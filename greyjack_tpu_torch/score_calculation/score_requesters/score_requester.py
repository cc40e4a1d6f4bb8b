"""Chromosome-space <-> entity-tensor-space bridge.

Counterpart of `greyjack_tpu/score_calculation/score_requesters/
score_requester.py` (reference `oop_score_requester.rs:17-470`). The cotwin
is compiled once into a flat variable schema (`VariablesManager`),
per-(group, column) variable-id maps and dense fact tensors, all on the
calculator's device; building the scoring frames of a population is then
one strided slice and cast per planning column.

Delta-path shapes: a ctx holds one base candidate per island (leaves with a
leading island axis I); deltas are {"positions": i32[I, P, K],
"values": f[I, P, K], "valid": bool[I, P, K]}.
"""

from __future__ import annotations

import numpy as np
import torch

from greyjack_tpu_torch import config
from greyjack_tpu_torch.utils.tracing import span
from greyjack_tpu_torch.variables.planning_variables import _PlanningVariable
from greyjack_tpu_torch.score_calculation.score_requesters.variables_manager import (  # noqa: E501
    VariablesManager,
)


def _fact_array(values, device):
    arr = np.asarray(values)
    if arr.dtype.kind in "ui":
        return torch.as_tensor(arr.astype(np.int32), device=device)
    if arr.dtype.kind == "f":
        return torch.as_tensor(arr.astype(np.float64), device=device)
    if arr.dtype.kind == "b":
        return torch.as_tensor(arr, device=device)
    return arr  # strings etc. stay host-side


class ScoreRequester:
    def __init__(self, cotwin):
        self.cotwin = cotwin
        calc = cotwin.score_calculator
        self.device = calc.device
        dev = self.device

        variables = []
        self.planning_schema = {}
        var_index = 0
        for group_name, entities in cotwin.planning_entities.items():
            schema = {"n": len(entities), "columns": [], "facts": {}}
            col_kinds = None
            fact_cols: dict = {}
            var_id_cols: dict = {}
            for entity in entities:
                pairs = entity.to_vec()
                if col_kinds is None:
                    col_kinds = [
                        (name, "planning" if isinstance(v, _PlanningVariable)
                         else "fact")
                        for name, v in pairs
                    ]
                for attr_name, value in pairs:
                    if isinstance(value, _PlanningVariable):
                        value.set_name(f"{group_name}: {var_index}-->{attr_name}")
                        variables.append(value)
                        var_id_cols.setdefault(attr_name, []).append(var_index)
                        var_index += 1
                    else:
                        fact_cols.setdefault(attr_name, []).append(value)
            schema["columns"] = col_kinds or []
            schema["is_discrete"] = {
                c: bool(variables[ids[0]].is_discrete)
                for c, ids in var_id_cols.items()
            }
            schema["var_ids_np"] = {
                c: np.asarray(ids, dtype=np.int32)
                for c, ids in var_id_cols.items()
            }
            schema["var_ids"] = {
                c: torch.as_tensor(v, device=dev)
                for c, v in schema["var_ids_np"].items()
            }
            # affine index patterns (start + stride*i) become strided slices
            schema["affine"] = {}
            for c, ids in var_id_cols.items():
                arr = np.asarray(ids)
                if len(arr) == 1:
                    schema["affine"][c] = (int(arr[0]), 1)
                elif len(arr) > 1:
                    stride = int(arr[1] - arr[0])
                    if stride > 0 and (np.diff(arr) == stride).all():
                        schema["affine"][c] = (int(arr[0]), stride)
            schema["facts"] = {c: _fact_array(v, dev)
                               for c, v in fact_cols.items()}
            self.planning_schema[group_name] = schema

        self.fact_frames = {}
        for group_name, facts in cotwin.problem_facts.items():
            cols: dict = {}
            for fact in facts:
                for attr_name, value in fact.to_vec():
                    cols.setdefault(attr_name, []).append(value)
            self.fact_frames[group_name] = {c: _fact_array(v, dev)
                                            for c, v in cols.items()}

        self.variables_manager = VariablesManager(variables, dev)
        self.score_size = calc.score_size
        self.score_class = calc.score_class

        # delta schema: flat var id -> (entity row, planning-column index)
        var_row = np.zeros(len(variables), dtype=np.int32)
        var_col = np.zeros(len(variables), dtype=np.int32)
        for schema in self.planning_schema.values():
            planning_cols = [c for c, kind in schema["columns"]
                             if kind == "planning"]
            for ci, col in enumerate(planning_cols):
                ids = schema["var_ids_np"][col]
                var_row[ids] = np.arange(len(ids), dtype=np.int32)
                var_col[ids] = ci
        self.var_row = torch.as_tensor(var_row, device=dev)
        self.var_col = torch.as_tensor(var_col, device=dev)
        self.var_rowcol = torch.as_tensor(
            np.stack([var_row, var_col], axis=-1), device=dev)

    # --- delta (incremental) path --------------------------------------------
    @property
    def supports_delta(self):
        calc = self.cotwin.score_calculator
        return bool(getattr(calc, "has_delta_kernels", False))

    @property
    def supports_sweep(self):
        """True when the model registered a sweep-neighbourhood module and
        this instance passes its static eligibility gate."""
        mod = self.sweep_module
        if mod is None or not self.supports_delta:
            return False
        return bool(mod.eligible(self._delta_utils()))

    @property
    def sweep_module(self):
        return getattr(self.cotwin.score_calculator, "sweep_module", None)

    def _delta_utils(self):
        calc = self.cotwin.score_calculator
        utils = dict(calc.utility_objects)
        utils["delta_schema"] = {"var_row": self.var_row,
                                 "var_col": self.var_col,
                                 "var_rowcol": self.var_rowcol}
        return utils

    def build_base_ctx(self, base_rows):
        """One O(N) pass over one base candidate per island,
        f[I, V] -> model ctx (leaves with a leading island axis)."""
        calc = self.cotwin.score_calculator
        with span("gj.ctx.build"):
            frames = self.build_frames(base_rows)
            return calc.delta_ctx_fn(frames, self.fact_frames,
                                     self._delta_utils())

    def request_score_delta(self, ctx, deltas):
        """f64[I, P, S] score rows of every island's neighbourhood (delta
        leaves [I, P, K]): the whole-neighbourhood scorer (the fused
        kernel), or the per-neighbour `score_delta` when that scorer is
        statically ineligible for this shape (it returns None)."""
        calc = self.cotwin.score_calculator
        with span("gj.delta.score"):
            utils = self._delta_utils()
            batch_fn = getattr(calc, "delta_score_batch_fn", None)
            if batch_fn is not None:
                out = batch_fn(ctx, deltas, utils)
                if out is not None:
                    return out
            return calc.delta_score_fn(ctx, deltas, utils)

    def request_score_delta_ints(self, ctx, deltas):
        """Integer delta rows i32[I, P, S] for the local-search accept loop,
        or None when the model / kernel does not support them for this
        shape (a host-side static, so callers branch in Python)."""
        if not self.registers_delta_ints:
            return None
        with span("gj.delta.score"):
            return self.cotwin.score_calculator.delta_score_batch_ints_fn(
                ctx, deltas, self._delta_utils())

    @property
    def registers_delta_ints(self):
        """True when the model registered the integer delta rows and the
        ctx score they are read against (what the JAX package's TabuSearch
        labels "int-delta")."""
        calc = self.cotwin.score_calculator
        return (getattr(calc, "delta_score_batch_ints_fn", None) is not None
                and getattr(calc, "delta_ctx_score_fn", None) is not None)

    def delta_ints_eligible(self, kd):
        """Whether `request_score_delta_ints` serves kd-wide deltas: the
        model registered the integer rows and its eligibility gate (if
        any) passes this width. A host-side static."""
        if not self.registers_delta_ints:
            return False
        calc = self.cotwin.score_calculator
        gate = getattr(calc, "delta_batch_eligible_fn", None)
        return gate is None or bool(gate(self._delta_utils(), kd))

    def ctx_score_row(self, ctx):
        """f64[I, S] score of each island's base candidate."""
        calc = self.cotwin.score_calculator
        return calc.delta_ctx_score_fn(ctx, self._delta_utils())

    @property
    def supports_rounded_fast_paths(self):
        calc = self.cotwin.score_calculator
        return (getattr(calc, "delta_ctx_ints_fn", None) is not None
                and getattr(calc, "score_int_scales", None) is not None)

    def ctx_int_totals(self, ctx):
        """i64[I, S] exact integer score totals of each base candidate."""
        calc = self.cotwin.score_calculator
        return calc.delta_ctx_ints_fn(ctx, self._delta_utils())

    @property
    def score_int_scales(self):
        return torch.as_tensor(self.cotwin.score_calculator.score_int_scales,
                               dtype=torch.float64, device=self.device)

    def update_ctx(self, ctx, delta):
        """Apply one accepted delta per island (delta leaves [I, K]; identity
        for islands whose delta has no valid entries)."""
        calc = self.cotwin.score_calculator
        with span("gj.ctx.update"):
            return calc.delta_update_fn(ctx, delta, self._delta_utils())

    # --- frames -------------------------------------------------------------
    def build_frames(self, population):
        """population f[..., V] -> {group: {col: typed [..., n_entities]}}.
        Integer planning columns come out as i32, float columns as clamped
        floats; fact columns of planning groups are broadcast."""
        vm = self.variables_manager
        fixed = vm.fix_all(population)
        frames = {}
        for group_name, schema in self.planning_schema.items():
            cols = {}
            for col, var_ids in schema["var_ids"].items():
                n = var_ids.shape[0]
                if col in schema["affine"]:
                    start, stride = schema["affine"][col]
                    vals = fixed[..., start:start + (n - 1) * stride + 1:stride]
                else:
                    vals = fixed[..., var_ids.long()]
                if schema["is_discrete"][col]:
                    cols[col] = vals.to(config.INT_DTYPE)
                else:
                    cols[col] = vals
            for col, arr in schema["facts"].items():
                if isinstance(arr, torch.Tensor):
                    cols[col] = torch.broadcast_to(
                        arr, population.shape[:-1] + arr.shape)
                else:
                    cols[col] = arr
            frames[group_name] = cols
        return frames

    # --- scoring ------------------------------------------------------------
    def request_score_plain(self, population, util_overrides=None):
        """f[P, V] -> f64[P, S] (reference `request_score_plain`,
        `oop_score_requester.rs:336-355`)."""
        calculator = self.cotwin.score_calculator
        with span("gj.score.plain"):
            frames = self.build_frames(population)
            return calculator.score_batch(frames, self.fact_frames,
                                          population.shape[0],
                                          util_overrides)

    # --- partitioned facts -------------------------------------------------
    def partitioned_plain_score_fn(self, facts_group=None):
        """Plain scoring with the distance matrix row-sharded over the
        process group `facts_group` instead of replicated
        (`greyjack_tpu/score_calculation/score_requesters/
        score_requester.py:285-326`).

        Returns `fn(dm_shard_flat, population) -> f64[P, S]`, called on
        every rank of the group with the same population and this rank's
        block of the flat padded milli matrix
        (`ops/partitioned.shard_rows_flat`). Every matrix lookup is an
        owner-computes sum over the group, so the scores equal the
        replicated ones bit for bit. Only the plain path is partitioned:
        the delta and sweep paths keep dense tables."""
        from greyjack_tpu_torch.ops import partitioned

        calc = self.cotwin.score_calculator
        if calc.utility_objects.get("exact_fp_scores"):
            raise ValueError(
                "partitioned facts require the integer-milli score path "
                "(exact_fp_scores=False)")
        n_locations = calc.utility_objects["n_locations"]

        def fn(dm_shard_flat, population):
            def dm_at(flat_idx):
                return partitioned.sharded_dm_gather_flat(
                    dm_shard_flat, flat_idx, n_locations, facts_group)

            return self.request_score_plain(population, {"dm_at": dm_at})

        return fn

    def score_fn(self):
        """The plain-score callable `population -> f64[P, S]`."""
        return self.request_score_plain
