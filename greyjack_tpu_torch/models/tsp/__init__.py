from greyjack_tpu_torch.models.tsp.domain import (
    Location,
    TravelSchedule,
    DomainBuilder,
    generate_uniform_instance,
)
from greyjack_tpu_torch.models.tsp.cotwin_builder import CotwinBuilder, CotStop
from greyjack_tpu_torch.models.tsp import sweep

__all__ = [
    "Location",
    "TravelSchedule",
    "DomainBuilder",
    "CotwinBuilder",
    "CotStop",
    "generate_uniform_instance",
    "sweep",
]
