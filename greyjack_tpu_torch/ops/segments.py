"""Segment / uniqueness ops (counterpart of `greyjack_tpu/ops/segments.py`),
batched over leading axes."""

import torch


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
    c and net occupancy change d, n_unique changes by (c+d > 0) - (c > 0)."""
    l = counts.shape[-1]
    k = old_vals.shape[-1]
    sent = torch.tensor(l, dtype=torch.int32, device=counts.device)
    vals = torch.cat([torch.where(valid, old_vals.to(torch.int32), sent),
                      torch.where(valid, new_vals.to(torch.int32), sent)], -1)
    one = valid.to(torch.int32)
    d = torch.cat([-one, one], -1)
    eq = vals[..., :, None] == vals[..., None, :]
    net = torch.sum(torch.where(eq, d[..., None, :], 0), dim=-1,
                    dtype=torch.int32)
    idx = torch.arange(2 * k, device=counts.device)
    earlier_dup = torch.any(eq & (idx[None, :] < idx[:, None]), dim=-1)
    flat = torch.clamp(vals, max=l - 1).reshape(vals.shape[0], -1).long()
    cb = torch.gather(counts, 1, flat).reshape(vals.shape)
    contrib = (((cb + net) > 0).to(torch.int32)
               - (cb > 0).to(torch.int32))
    mask = ~earlier_dup & (vals < l)
    return torch.sum(torch.where(mask, contrib, 0), dim=-1,
                     dtype=torch.int32)
