"""Row-partitioned fact tables over a `facts` process group (counterpart
of `greyjack_tpu/ops/partitioned.py`).

A replicated distance matrix stops working once it outgrows one device's
memory. The layout then is a grid of ranks (islands, facts)
(`parallel/mesh.py`): populations stay data-parallel over islands, the
matrix is row-sharded over the ranks of one island row (its `facts`
group), and every matrix lookup becomes owner-computes: each rank answers
the requests that fall in its rows, the others contribute 0, and one
integer `all_reduce(SUM)` over the facts group assembles the answer. The
requests are replicated along the facts group, so no data-dependent
exchange is needed, and the integer sum is exact: the result equals the
dense lookup bit for bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def shard_rows(dm, n_shards):
    """Pad the row axis with zero rows to a multiple of `n_shards`; returns
    (padded, rows_per_shard). Shard i owns rows [i·r, (i+1)·r)."""
    l = dm.shape[0]
    r = -(-l // n_shards)
    pad = n_shards * r - l
    if pad:
        dm = torch.cat([dm, dm.new_zeros((pad,) + tuple(dm.shape[1:]))])
    return dm, r


def shard_rows_flat(dm, n_shards):
    """(the row-padded matrix flattened, rows_per_shard): shard i's rows
    sit at flat indices [i·r·L, (i+1)·r·L), the flat index space the
    route walks use."""
    padded, r = shard_rows(dm, n_shards)
    return padded.reshape(-1), r


def _owner_sum(block, local, mine, group):
    vals = torch.where(mine, block[local], torch.zeros((), dtype=block.dtype,
                                                       device=block.device))
    dist.all_reduce(vals, op=dist.ReduceOp.SUM, group=group)
    return vals


def sharded_dm_gather_flat(dm_shard_flat, flat_idx, n_locations, group):
    """dm.reshape(-1)[flat_idx] with the matrix row-sharded over `group`.

    dm_shard_flat: i32[rows_per_shard · L], this rank's row block
    flattened; flat_idx: int[...] flat (u·L + v) indices, the same on
    every rank of `group`. Returns i32[...], the same on every rank."""
    block = dm_shard_flat.shape[0]
    idx = flat_idx.long()
    lo = dist.get_rank(group) * block
    local = torch.clamp(idx - lo, 0, block - 1)
    mine = (idx >= lo) & (idx < lo + block)
    return _owner_sum(dm_shard_flat, local, mine, group)


def sharded_dm_gather(dm_shard, u, v, group):
    """dm[u, v] with the matrix row-sharded over `group`.

    dm_shard: i32[rows_per_shard, L], this rank's row block; u, v: int[...]
    request indices, the same on every rank of `group`. Each rank gathers
    where it owns row u (local index u - lo, clamped; other lanes give 0),
    and one sum over the group assembles dm[u, v]: its payload is the
    request's shape, whatever L is."""
    r = dm_shard.shape[0]
    u = u.long()
    lo = dist.get_rank(group) * r
    local = torch.clamp(u - lo, 0, r - 1)
    mine = (u >= lo) & (u < lo + r)
    return _owner_sum(dm_shard, (local, v.long()), mine, group)
