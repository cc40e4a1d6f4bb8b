"""Arithmetic the plain references share: the truncated Euclidean matrix,
distinct counts and lexicographic order. Plain numpy and torch only; nothing
here imports the program under test."""

import numpy as np
import torch

STUB = int(np.iinfo(np.int32).max)


def truncated_distances(xs, ys, dtype=np.float64):
    """[L, L] Euclidean distances truncated to 3 decimals, computed in
    `dtype` (float64 as the configurations state; float32 for the
    lower-precision control)."""
    xs = np.asarray(xs, dtype=dtype)
    ys = np.asarray(ys, dtype=dtype)
    dx = xs[:, None] - xs[None, :]
    dy = ys[:, None] - ys[None, :]
    d = np.sqrt(dx * dx + dy * dy)
    fl = np.floor(d)
    return fl + np.floor((d - fl) * dtype(1000.0)) / dtype(1000.0)


def milli_matrix(xs, ys):
    """int64 [L, L]: the truncated distances as whole thousandths."""
    d = np.sqrt((np.asarray(xs)[:, None] - np.asarray(xs)[None, :]) ** 2
                + (np.asarray(ys)[:, None] - np.asarray(ys)[None, :]) ** 2)
    fl = np.floor(d)
    return (fl * 1000.0 + np.floor((d - fl) * 1000.0)).astype(np.int64)


def n_unique(values):
    """int64 [B]: distinct values in each row of int [B, N]."""
    s = torch.sort(values, dim=1).values
    return 1 + torch.sum(s[:, 1:] != s[:, :-1], dim=1)


def round3(x):
    """Truncation to 3 decimals, x float64 (the upstream score precision
    [3, 3]): floor(x) + floor(frac(x) * 1000) / 1000."""
    fl = np.floor(x)
    return fl + np.floor((x - fl) * 1000.0) / 1000.0


def lex_leq(a, b):
    """a <= b lexicographically, for 1-d rows."""
    for x, y in zip(a, b):
        if x < y:
            return True
        if x > y:
            return False
    return True


def lex_less(a, b):
    return lex_leq(a, b) and list(a) != list(b)


def lex_argmin(keys):
    """int64 [...]: index of the lexicographically smallest row of
    keys [..., M, S] along M, ties to the lowest index."""
    big = (torch.finfo(keys.dtype).max if keys.dtype.is_floating_point
           else torch.iinfo(keys.dtype).max)
    left = torch.ones(keys.shape[:-1], dtype=torch.bool, device=keys.device)
    for s in range(keys.shape[-1]):
        col = torch.where(left, keys[..., s], big)
        left = left & (col == col.min(dim=-1, keepdim=True).values)
    return torch.argmax(left.to(torch.int32), dim=-1)
