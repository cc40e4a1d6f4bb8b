from greyjack_tpu_torch.models.vrp.domain import (
    Customer,
    Vehicle,
    VehicleRoutingPlan,
    DomainBuilder,
    generate_instance,
)
from greyjack_tpu_torch.models.vrp.cotwin_builder import CotwinBuilder, CotStop

__all__ = [
    "Customer",
    "Vehicle",
    "VehicleRoutingPlan",
    "DomainBuilder",
    "CotwinBuilder",
    "CotStop",
    "generate_instance",
]
