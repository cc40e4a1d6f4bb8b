"""User persistence contract (counterpart of
`greyjack_tpu/domain/domain_builder.py`; reference
`domain_builder_trait.rs:3-30`). A domain builder builds the domain from
scratch, from a solution JSON (multi-stage solving / replanning: the
solution carries only planning-variable values, so non-planned state comes
from `initial_domain`), or as a copy of an existing domain object.
"""

import copy


class DomainBuilderBase:
    def build_domain_from_scratch(self):
        raise NotImplementedError

    def build_from_solution(self, solution, initial_domain=None):
        raise NotImplementedError

    def build_from_domain(self, domain):
        return copy.deepcopy(domain)
