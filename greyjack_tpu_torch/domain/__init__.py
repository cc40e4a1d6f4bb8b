from greyjack_tpu_torch.domain.domain_builder import DomainBuilderBase

__all__ = ["DomainBuilderBase"]
