"""greyjack_tpu_torch — the PyTorch / CUDA port of greyjack_tpu.

Module paths and function names mirror `greyjack_tpu/`, which stays the
reference the port is tested against. Host modelling (cotwin, variables,
scores, termination strategies) is shared Python; the device path runs on
torch tensors on an explicit device, and every Pallas kernel of the JAX
package becomes a hand-written CUDA kernel under `csrc/` with a plain torch
version beside it (used for CPU tensors and as the parity reference).

This package imports torch and never jax.
"""

from greyjack_tpu_torch import config
from greyjack_tpu_torch.score_calculation.scores import (
    SimpleScore,
    HardSoftScore,
    HardMediumSoftScore,
)
from greyjack_tpu_torch.variables import GJFloat, GJInteger

__version__ = "0.1.0"

__all__ = [
    "config",
    "SimpleScore",
    "HardSoftScore",
    "HardMediumSoftScore",
    "GJFloat",
    "GJInteger",
]
