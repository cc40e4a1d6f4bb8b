"""Permutation application (counterpart of `greyjack_tpu/ops/join.py`)."""

import torch


def apply_permutation(x, p):
    """y[..., i] = x[..., p[..., i]] along the last axis.

    The JAX package avoids gathers with a double-sort identity because a TPU
    has no hardware gather; a GPU gathers natively, so this is one
    `torch.gather` with the same result."""
    return torch.gather(x, -1, p.long())
