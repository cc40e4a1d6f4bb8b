from greyjack_tpu_torch.cotwin.cotwin import Cotwin
from greyjack_tpu_torch.cotwin.cotwin_entity import CotwinEntity
from greyjack_tpu_torch.cotwin.cotwin_builder import CotwinBuilderBase

__all__ = ["Cotwin", "CotwinEntity", "CotwinBuilderBase"]
