"""Constraint registries (counterpart of `greyjack_tpu/score_calculation/
score_calculators/score_calculator.py`; reference
`plain_score_calculator.rs:8-99`).

A constraint is a function over a whole population's typed entity tensors
(leading population axis) returning score components; the calculator folds
the weighted components in insertion order, in f64, as the reference does.

Constraint signature:
    fn(planning: {group: {col: tensor[P, n_entities]}},
       facts:    {group: {col: tensor[n_rows]}},
       utils:    dict) -> tuple of f64[P] components (or f64[P, S])
"""

from __future__ import annotations

import torch


class PlainScoreCalculator:
    is_incremental = False

    def __init__(self, score_class, device):
        self.score_class = score_class
        self.score_size = score_class.precision_len()
        self.device = torch.device(device)
        self.constraints: dict = {}
        self.constraint_weights: dict = {}
        self.prescoring_functions: dict = {}
        self.utility_objects: dict = {}

    def add_constraint(self, name, fn, weight: float = 1.0):
        self.constraints[name] = fn
        self.constraint_weights[name] = float(weight)

    def remove_constraint(self, name):
        self.constraints.pop(name, None)
        self.constraint_weights.pop(name, None)

    def set_constraint_weights(self, weights: dict):
        for name, w in weights.items():
            self.constraint_weights[name] = float(w)

    def add_prescoring_function(self, name, fn):
        self.prescoring_functions[name] = fn

    def add_utility_object(self, name, obj):
        self.utility_objects[name] = obj

    def score_batch(self, planning, facts, n_samples, util_overrides=None):
        """Score a population's frames -> f64[P, S], folding the weighted
        constraint rows in insertion order (fp-parity with the reference's
        sequential `add_assign`, `plain_score_calculator.rs:79-90`).
        `util_overrides` (optional) is merged over the utility objects: the
        partitioned-facts mode injects its `dm_at` accessor there."""
        utils = dict(self.utility_objects)
        if util_overrides:
            utils.update(util_overrides)
        for fn in self.prescoring_functions.values():
            extra = fn(planning, facts, utils)
            if extra:
                utils.update(extra)

        total = torch.zeros((n_samples, self.score_size), dtype=torch.float64,
                            device=self.device)
        for name, fn in self.constraints.items():
            row = fn(planning, facts, utils)
            if isinstance(row, (tuple, list)):
                row = torch.stack(
                    [torch.broadcast_to(torch.as_tensor(
                        r, dtype=torch.float64, device=self.device),
                        (n_samples,)) for r in row], dim=-1)
            w = self.constraint_weights[name]
            total = total + (row if w == 1.0 else w * row)
        return total


class IncrementalScoreCalculator(PlainScoreCalculator):
    """Delta (incremental) scoring: the model registers

        build_ctx(planning, facts, utils) -> ctx
            the O(N) base pass over one base candidate per island;
        score_delta(ctx, deltas, utils) -> f64[I, P, S]
            every island's neighbours (delta leaves [I, P, K]) scored
            against its ctx, O(K) per neighbour;
        update_ctx(ctx, delta, utils) -> ctx
            applies one accepted delta per island;
        ctx_score(ctx, utils) -> f64[I, S], ctx_ints(ctx, utils) -> i64[I, S]
            the base candidate's score from the ctx's exact integer sums;

    and a whole-neighbourhood scorer pair (`set_delta_batch_kernel`).
    Local-search agents use them when present (reference
    `incremental_score_calculator.rs:8-104`)."""

    is_incremental = True

    def __init__(self, score_class, device):
        super().__init__(score_class, device)
        self.delta_ctx_fn = None
        self.delta_score_fn = None
        self.delta_update_fn = None
        self.delta_ctx_score_fn = None
        self.delta_score_batch_fn = None
        self.delta_score_batch_ints_fn = None
        self.delta_batch_eligible_fn = None
        self.delta_ctx_ints_fn = None
        self.score_int_scales = None
        self.sweep_module = None

    def set_delta_kernels(self, build_ctx, score_delta, update_ctx,
                          ctx_score=None, ctx_ints=None, int_scales=None):
        """Register the delta kernels (see the class docstring); `int_scales`
        are the length-S divisors mapping `ctx_ints` to the f64 rows."""
        self.delta_ctx_fn = build_ctx
        self.delta_score_fn = score_delta
        self.delta_update_fn = update_ctx
        self.delta_ctx_score_fn = ctx_score
        self.delta_ctx_ints_fn = ctx_ints
        if int_scales is not None:
            self.score_int_scales = [float(s) for s in int_scales]

    def set_delta_batch_kernel(self, score_delta_batch,
                               score_delta_batch_ints=None, eligible=None):
        """Register a whole-neighbourhood scorer `(ctx, deltas[I, P, K],
        utils) -> f64[I, P, S] | None` (None: statically ineligible for
        this shape), optionally its integer-delta twin returning i32
        delta rows order-equivalent to the f64 rows, and the static gate
        `eligible(utils, kd)` both answer by."""
        self.delta_score_batch_fn = score_delta_batch
        self.delta_score_batch_ints_fn = score_delta_batch_ints
        self.delta_batch_eligible_fn = eligible

    def set_sweep_module(self, module):
        """Register a sweep-neighbourhood module (dense value-sweep scoring,
        see `models/vrp/sweep.py`). The module exposes `eligible(utils)`
        (static), `SweepConfig(requester, targets, window)` and
        `propose(generators, ctx, free, tabu_masks, cfg, utils)`;
        local-search agents use it when present and eligible."""
        self.sweep_module = module

    @property
    def has_delta_kernels(self):
        return self.delta_ctx_fn is not None
