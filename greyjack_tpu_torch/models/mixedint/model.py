"""Mixed-integer / continuous benchmark model, LSHADE's home ground
(counterpart of `greyjack_tpu/models/mixedint/model.py`).

Classic objectives (rastrigin, rosenbrock, sphere) over `n_floats` GJFloat
and `n_ints` GJInteger variables in one planning column, scored by a
`PlainScoreCalculator(SimpleScore)` on the domain's device. The objective
takes a whole population's rows x f64[P, n] and reduces over the last
axis (n is the variable count), in f64, as the JAX package's per-row
objective does under `vmap`.
"""

from __future__ import annotations

import copy
import math

import torch

from greyjack_tpu_torch.cotwin import Cotwin, CotwinBuilderBase
from greyjack_tpu_torch.variables import GJFloat, GJInteger
from greyjack_tpu_torch.score_calculation.scores import SimpleScore
from greyjack_tpu_torch.score_calculation.score_calculators import (
    PlainScoreCalculator)


class MixedIntDomain:
    def __init__(self, n_floats, n_ints, lower=-5.12, upper=5.12,
                 objective="rastrigin", device="cuda"):
        self.n_floats = int(n_floats)
        self.n_ints = int(n_ints)
        self.lower = float(lower)
        self.upper = float(upper)
        self.objective = objective
        self.device = torch.device(device)
        self.solution_values = None


class DomainBuilder:
    """Builds `MixedIntDomain`s on `device`, the card unless the caller
    names another (tests pass device="cpu"); without a card the default
    raises when the cotwin is built."""

    def __init__(self, n_floats, n_ints, lower=-5.12, upper=5.12,
                 objective="rastrigin", device="cuda"):
        self._args = (n_floats, n_ints, lower, upper, objective, device)

    def build_domain_from_scratch(self):
        return MixedIntDomain(*self._args)

    def build_from_solution(self, solution, initial_domain=None):
        domain = self.build_domain_from_scratch()
        domain.solution_values = [value for _name, value in solution[0]]
        return domain

    def build_from_domain(self, domain):
        return copy.deepcopy(domain)


class CotVariable:
    def __init__(self, var):
        self.value = var

    def to_vec(self):
        return [("value", self.value)]


def _objective_fn(name):
    """x f64[..., n] -> f64[...]."""
    if name == "rastrigin":
        def f(x):
            return 10.0 * x.shape[-1] + torch.sum(
                x * x - 10.0 * torch.cos(2.0 * math.pi * x), dim=-1)
    elif name == "rosenbrock":
        def f(x):
            return torch.sum(
                100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2
                + (1.0 - x[..., :-1]) ** 2, dim=-1)
    elif name == "sphere":
        def f(x):
            return torch.sum(x * x, dim=-1)
    else:
        raise ValueError(f"unknown objective {name}")
    return f


class CotwinBuilder(CotwinBuilderBase):
    def build_cotwin(self, domain, is_already_initialized):
        entities = []
        for _ in range(domain.n_floats):
            entities.append(CotVariable(
                GJFloat(None, domain.lower, domain.upper, False, None)))
        for _ in range(domain.n_ints):
            entities.append(CotVariable(
                GJInteger(None, int(domain.lower), int(domain.upper), False,
                          None)))

        obj = _objective_fn(domain.objective)

        def objective_constraint(planning, facts, utils):
            x = planning["variables"]["value"]
            return (obj(x.to(torch.float64)),)

        cotwin = Cotwin()
        cotwin.add_planning_entities("variables", entities)
        calculator = PlainScoreCalculator(SimpleScore, domain.device)
        calculator.add_constraint("objective", objective_constraint)
        cotwin.add_score_calculator(calculator)
        return cotwin
