"""Distance-matrix construction (counterpart of `greyjack_tpu/ops/distance.py`)."""

import torch


def euclidean_matrix(xs, ys, precision=None):
    """Pairwise Euclidean distances f64[L, L] with optional truncating
    decimal rounding (`precision=3` mirrors the reference's pre-rounded
    matrices). xs, ys: f64[L] tensors; the result lies on their device.

    The truncation `floor(d) + floor(frac(d) * 10^p) / 10^p` is evaluated as
    one fused multiply-add `floor(d) + floor(frac(d) * 10^p) * 10^-p`: that
    is the form XLA compiles the JAX package's expression to on the CPU, so
    the matrices agree bit for bit. (The integer-milli matrix that every
    score uses is the same under either form.)"""
    dx = xs[:, None] - xs[None, :]
    dy = ys[:, None] - ys[None, :]
    d = torch.sqrt(dx * dx + dy * dy)
    if precision is None:
        return d
    scale = 10.0 ** precision
    fl = torch.floor(d)
    frac = torch.floor((d - fl) * scale)
    return torch.addcmul(fl, frac, torch.full_like(frac, 1.0 / scale))
