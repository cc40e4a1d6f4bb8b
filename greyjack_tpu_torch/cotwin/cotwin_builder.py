"""Cotwin builder contract.

Reference: `greyjack/src/cotwin/cotwin_builder_trait.rs:7-11`.
"""


class CotwinBuilderBase:
    def build_cotwin(self, domain, is_already_initialized: bool):
        raise NotImplementedError
