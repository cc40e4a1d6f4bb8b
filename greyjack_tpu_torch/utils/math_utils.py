"""Numeric helpers matching the reference's rounding semantics.

Counterpart of `greyjack_tpu/utils/math_utils.py`: a Python-scalar version
for host bookkeeping and a tensor version for the device path, agreeing
bit-for-bit.
"""

import math

import numpy as np
import torch


def rint(x: float) -> float:
    """Round to nearest with exact halves toward +inf (`math_utils.rs:5-7`)."""
    f = math.floor(x)
    c = math.ceil(x)
    return f if abs(x - f) < abs(c - x) else float(c)


def rint_t(x):
    """Tensor `rint` (ties toward +inf), not banker's rounding."""
    f = torch.floor(x)
    c = torch.ceil(x)
    return torch.where(torch.abs(x - f) < torch.abs(c - x), f, c)


def round_decimal(value: float, precision: int) -> float:
    """Truncating decimal round, reference `math_utils.rs:9-12`."""
    multiplier = 10.0 ** float(precision)
    fl = math.floor(value)
    return fl + math.floor((value - fl) * multiplier) / multiplier


def get_random_id(start_id: int, end_exclusive: int) -> int:
    """Host-side uniform id draw (`math_utils.rs:14-16`), from Python's
    `random` as the JAX package draws it."""
    import random

    return random.randrange(start_id, end_exclusive)


def choice(objects, n: int, replace: bool):
    """Host-side sampling with or without replacement
    (`math_utils.rs:18-47`), from Python's `random` as the JAX package
    samples."""
    import random

    if replace:
        return [random.choice(objects) for _ in range(n)]
    if n > len(objects):
        raise ValueError(
            "There are less objects than can be chosen without replacement"
        )
    return random.sample(list(objects), n)


def round_decimal_t(value, precision):
    """Tensor `round_decimal` over the trailing axis; `precision` is a host
    int or list of ints (the multiplier is computed on the host, so no
    device `pow` enters the result)."""
    p = np.asarray(precision)
    multiplier = torch.as_tensor(
        (10.0 ** p.astype(np.int64)).astype(np.float64), device=value.device)
    fl = torch.floor(value)
    return fl + torch.floor((value - fl) * multiplier) / multiplier


def true_div(x, divisor):
    """x / divisor (a Python number), correctly rounded on every device.
    CUDA computes a tensor divided by a Python number as the product with
    the number's reciprocal, which can differ from the quotient in the last
    bit (x / 1000.0 against x * 0.001); a tensor divisor takes the true
    division, as the CPU and the JAX package's eager scores do."""
    return x / torch.full_like(x, divisor)
