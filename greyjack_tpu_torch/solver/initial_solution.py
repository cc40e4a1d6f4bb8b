"""Initial-solution variants for multi-stage solving / replanning.

Reference: `greyjack/src/solver/initial_solution_variants.rs:3-8` —
`CotwinValuesVector` (a previous solution JSON) or `DomainObject` (a
rebuilt/edited domain), dispatched at `solver.rs:106-119`. Combined with
per-variable `frozen` pinning this enables warm starts and replanning.
"""

from __future__ import annotations


class InitialSolution:
    def __init__(self, kind, payload):
        self.kind = kind
        self.payload = payload

    @classmethod
    def from_solution(cls, solution_json):
        """Reference `CotwinValuesVector` variant."""
        return cls("cotwin_values_vector", solution_json)

    @classmethod
    def from_domain(cls, domain):
        """Reference `DomainObject` variant."""
        return cls("domain_object", domain)


# reference-style aliases
CotwinValuesVector = InitialSolution.from_solution
DomainObject = InitialSolution.from_domain
