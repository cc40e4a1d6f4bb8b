"""Segment / uniqueness ops (counterpart of `greyjack_tpu/ops/segments.py`),
batched over leading axes."""

import torch

from greyjack_tpu_torch import config


def count_minus_n_unique(values, num_buckets=None):
    """`len(values) - n_unique(values)` along the last axis: values int[..., N]
    -> f64[...]. Sort-based distinct count, as in the reference package
    (`num_buckets` kept for API compatibility, unused)."""
    n = values.shape[-1]
    if n == 0:
        return torch.zeros(values.shape[:-1], dtype=torch.float64,
                           device=values.device)
    s = torch.sort(values, dim=-1).values
    n_unique = 1 + torch.sum(s[..., 1:] != s[..., :-1], dim=-1)
    return (n - n_unique).to(torch.float64)


def _bincount(values, length):
    """i64[..., length] value histogram along the last axis, as
    `jnp.bincount(values, length=length)` counts: negative values count
    at 0, values >= length are dropped (they land on a sentinel bucket
    that is cut off)."""
    v = torch.clamp(values.long(), min=0)
    v = torch.where(v < length, v, length)
    out = torch.zeros(values.shape[:-1] + (length + 1,), dtype=torch.int64,
                      device=values.device)
    return out.scatter_add_(-1, v, torch.ones_like(v))[..., :length]


def n_unique(values, num_buckets):
    """Distinct values along the last axis, i64[...], counted from a
    histogram of `num_buckets` buckets (values as `_bincount` counts
    them)."""
    return torch.sum(_bincount(values, num_buckets) > 0, dim=-1)


def segment_count(segment_ids, num_segments):
    """Occurrences of each segment id along the last axis,
    i64[..., num_segments]."""
    return _bincount(segment_ids, num_segments)


def segment_sum(values, segment_ids, num_segments):
    """Sum `values` [..., N] per segment id along the last axis ->
    [..., num_segments] (same dtype). Integer sums are exact whatever order
    the device adds them in."""
    out = torch.zeros(values.shape[:-1] + (num_segments,), dtype=values.dtype,
                      device=values.device)
    return out.scatter_add_(-1, segment_ids.long(), values)


def nunique_delta(counts, old_vals, new_vals, valid):
    """Exact change in n_unique when `old_vals[valid]` are replaced by
    `new_vals[valid]`, given the base histogram.

    counts: i32[I, L] (one histogram per island); old_vals, new_vals, valid:
    [I, M, K]. Returns i32[I, M]. Per distinct touched value v with base count
    c and net occupancy change d, n_unique changes by (c+d > 0) - (c > 0).

    Up to `config.MAX_NARROW_DELTA` entries by one [2K, 2K] comparison;
    wider deltas by a sort of the 2K touched values, each run of equal
    values summed by a prefix sum and counted once at its end."""
    l = counts.shape[-1]
    k = old_vals.shape[-1]
    sent = torch.tensor(l, dtype=torch.int32, device=counts.device)
    vals = torch.cat([torch.where(valid, old_vals.to(torch.int32), sent),
                      torch.where(valid, new_vals.to(torch.int32), sent)], -1)
    one = valid.to(torch.int32)
    d = torch.cat([-one, one], -1)
    if k > config.MAX_NARROW_DELTA:
        vals, order = torch.sort(vals, dim=-1)
        d = torch.gather(d, -1, order)
        csum = torch.cumsum(d, dim=-1, dtype=torch.int32)
        step = vals[..., 1:] != vals[..., :-1]
        edge = torch.ones_like(step[..., :1])
        idx = torch.arange(2 * k, device=counts.device)
        # the index where each entry's run of equal values starts
        start = torch.cummax(torch.where(torch.cat([edge, step], -1), idx, 0),
                             dim=-1).values
        net = csum - torch.gather(csum - d, -1, start)   # the run's sum so far
        counted = torch.cat([step, edge], -1)            # the run's last entry
    else:
        eq = vals[..., :, None] == vals[..., None, :]
        net = torch.sum(torch.where(eq, d[..., None, :], 0), dim=-1,
                        dtype=torch.int32)
        idx = torch.arange(2 * k, device=counts.device)
        counted = ~torch.any(eq & (idx[None, :] < idx[:, None]), dim=-1)
    flat = torch.clamp(vals, max=l - 1).reshape(vals.shape[0], -1).long()
    cb = torch.gather(counts, 1, flat).reshape(vals.shape)
    contrib = (((cb + net) > 0).to(torch.int32)
               - (cb > 0).to(torch.int32))
    mask = counted & (vals < l)
    return torch.sum(torch.where(mask, contrib, 0), dim=-1,
                     dtype=torch.int32)


def overflow_penalty(demands, segment_ids, capacities, num_segments):
    """Capacity-overflow penalty along the last axis: the sum over segments
    of max(0, load - capacity), f64[...]. Integer loads sum exactly in
    i64 (the JAX package's x64 sum)."""
    loads = segment_sum(demands, segment_ids, num_segments)
    over = torch.clamp(loads - capacities, min=0)
    return torch.sum(over, dim=-1).to(torch.float64)


def scatter_drop(x, idx, vals, add=False):
    """x [I, W] with `vals` written (with `add`, summed) at `idx` (int[I, K])
    along axis 1, an index equal to W dropping its write: the writes go to
    a sentinel column that is cut off, as the JAX package's
    `.at[].set / .add(mode="drop")` drops them. The kept indices of a
    write must be distinct; integer adds are exact with repeats."""
    pad = torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)
    out = torch.cat([x, pad], dim=1)
    write = out.scatter_add_ if add else out.scatter_
    return write(1, idx.long(), vals.to(x.dtype))[:, :x.shape[1]]
