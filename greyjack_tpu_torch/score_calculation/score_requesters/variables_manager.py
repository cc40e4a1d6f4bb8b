"""Variable schema compiler: descriptor list -> dense tensors on a device.

Counterpart of `greyjack_tpu/score_calculation/score_requesters/
variables_manager.py` (reference `variables_manager.rs:12-224`). Bounds,
discrete / frozen masks, initial values and semantic groups are compiled
once into fixed-shape tensors; sampling and fixing are whole-population
tensor ops.
"""

from __future__ import annotations

import numpy as np
import torch

from greyjack_tpu_torch import config
from greyjack_tpu_torch.utils.math_utils import rint_t


class VariablesManager:
    def __init__(self, variables, device, float_dtype=None):
        self.variables = list(variables)
        self.device = torch.device(device)
        v = len(self.variables)
        self.variables_count = v
        self.float_dtype = (config.FLOAT_DTYPE if float_dtype is None
                            else float_dtype)
        if self.float_dtype == torch.float32 and v >= (1 << 24):
            raise ValueError(
                f"{v} variables >= 2^24 cannot be represented exactly in "
                "float32 sampler tables; build with float_dtype=torch.float64")

        lower = np.empty(v, dtype=np.float64)
        upper = np.empty(v, dtype=np.float64)
        discrete = np.zeros(v, dtype=bool)
        frozen = np.zeros(v, dtype=bool)
        has_initial = np.zeros(v, dtype=bool)
        initial = np.zeros(v, dtype=np.float64)
        for i, var in enumerate(self.variables):
            lower[i] = var.lower_bound
            upper[i] = var.upper_bound
            discrete[i] = var.is_discrete
            frozen[i] = var.frozen
            if var.initial_value is not None:
                has_initial[i] = True
                initial[i] = var.initial_value

        def dev(x, dtype=None):
            return torch.as_tensor(x, dtype=dtype, device=self.device)

        fd = self.float_dtype
        self.lower_bounds = dev(lower, fd)
        self.upper_bounds = dev(upper, fd)
        self.discrete_mask = dev(discrete)
        self.frozen_mask = dev(frozen)
        self.frozen_mask_np = frozen
        self.has_initial_mask = dev(has_initial)
        self.initial_values = dev(initial, fd)
        # packed (lower, upper, discrete) [V, 3]: one per-position gather in
        # the generic delta sampler
        self.bounds_pack = torch.stack(
            [self.lower_bounds, self.upper_bounds,
             self.discrete_mask.to(fd)], dim=-1)

        # --- semantic groups (insertion order; frozen vars excluded) ------
        groups: dict[str, list] = {}
        for i, var in enumerate(self.variables):
            for group_name in var.semantic_groups:
                groups.setdefault(group_name, [])
                if not var.frozen:
                    groups[group_name].append(i)
        self.n_semantic_groups = len(groups)
        self.semantic_group_keys = list(groups.keys())

        sizes = np.array([len(ids) for ids in groups.values()], dtype=np.int32)
        lmax = max(1, int(sizes.max()) if len(sizes) else 1)
        members = np.zeros((max(1, len(groups)), lmax), dtype=np.int32)
        for g, ids in enumerate(groups.values()):
            members[g, : len(ids)] = ids
        self.group_sizes_np = sizes if len(sizes) else np.zeros(1, np.int32)
        self.group_sizes = dev(self.group_sizes_np)
        self.group_members_np = members
        self.group_members = dev(members)
        self.max_group_size = lmax
        # packed per-(group, slot) sampler table [G, lmax, 4]: member id,
        # lower, upper, discrete — the narrow sampler reads all four at once
        self.slot_pack = torch.stack(
            [dev(members, fd), dev(lower[members], fd),
             dev(upper[members], fd),
             dev(discrete[members].astype(np.float64), fd)], dim=-1)

    # --- device ops --------------------------------------------------------
    def sample_variables(self, generator, n_samples):
        """Initial population f[n_samples, V]: the initial value where one is
        declared, else uniform (integers inclusive), drawn from `generator`
        (reference `variables_manager.rs:119-134`)."""
        u = torch.rand((n_samples, self.variables_count), generator=generator,
                       dtype=self.float_dtype, device=self.device)
        span = self.upper_bounds - self.lower_bounds
        cont = self.lower_bounds + u * span
        disc = torch.floor(self.lower_bounds + u * (span + 1.0))
        disc = torch.minimum(disc, self.upper_bounds)
        sampled = torch.where(self.discrete_mask, disc, cont)
        return torch.where(self.has_initial_mask, self.initial_values, sampled)

    def random_column_values(self, generator, shape=()):
        """U[lower, upper) per variable, discrete ones too (the reference's
        `get_column_random_value`, `variables_manager.rs:115-117`; a later
        `fix_all` rints), drawn from `generator`: f[*shape, V]."""
        u = torch.rand(tuple(shape) + (self.variables_count,),
                       generator=generator, dtype=self.float_dtype,
                       device=self.device)
        return self.lower_bounds + u * (self.upper_bounds - self.lower_bounds)

    def fix_all(self, values):
        """Clamp to bounds, rint discrete columns, pin frozen columns to their
        initial value (`gj_integer.rs:70-83`). Idempotent."""
        fixed = torch.clamp(values, self.lower_bounds.to(values.dtype),
                            self.upper_bounds.to(values.dtype))
        fixed = torch.where(self.discrete_mask, rint_t(fixed), fixed)
        return torch.where(self.frozen_mask,
                           self.initial_values.to(values.dtype), fixed)

    # --- host helpers -------------------------------------------------------
    def get_variables_names_vec(self):
        return [var.name for var in self.variables]

    def inverse_transform_variables(self, values_row):
        """Host-side typed solution values for the JSON round-trip
        (`variables_manager.rs:136-152`)."""
        return [var.inverse_transform(float(x))
                for var, x in zip(self.variables, np.asarray(values_row))]
