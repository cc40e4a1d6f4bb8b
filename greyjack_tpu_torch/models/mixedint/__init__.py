from greyjack_tpu_torch.models.mixedint.model import (
    MixedIntDomain,
    DomainBuilder,
    CotwinBuilder,
)

__all__ = ["MixedIntDomain", "DomainBuilder", "CotwinBuilder"]
