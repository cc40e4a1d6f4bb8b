"""Fact lookups and permutations (counterpart of `greyjack_tpu/ops/join.py`).

The JAX package replaces gathers with sort-merge joins, log-depth forward
fills and scatters because a TPU has no hardware gather. A GPU gathers
natively, so each op here is a gather with the same result; the tables
are iota-keyed (row r has key r), so the merge's "last table row whose key
is <= the query" is a clamp of the query key. Every op broadcasts over the
leading axes of `keys`.
"""

import torch


def _lookup(table, keys):
    """table[L] or [L, F], keys int[..., N] -> [..., N] or [..., N, F]: the
    payload of the last table row whose key is <= the query key, 0 where
    no row is (a negative key). Keys >= L find row L - 1."""
    k = keys.long()
    out = table[torch.clamp(k, 0, table.shape[0] - 1)]
    hit = k >= 0
    if table.dim() == 2:
        hit = hit[..., None]
    return torch.where(hit, out, torch.zeros((), dtype=table.dtype,
                                             device=table.device))


def sort_merge_lookup(table, keys, key_domain=None):
    """rows[..., i] = table[keys[..., i]] for keys in [0, L), with the JAX
    merge's result outside it: 0 below 0, row L - 1 above (`_lookup`).
    `key_domain` is kept for API compatibility (unused)."""
    return _lookup(table, keys)


def counts_from_sorted(sorted_keys):
    """(n - n_unique) from keys sorted along the last axis (adjacent
    compare), f64[...]."""
    dup = sorted_keys[..., 1:] == sorted_keys[..., :-1]
    return torch.sum(dup, dim=-1).to(torch.float64)


def _dup_count(keys):
    return counts_from_sorted(torch.sort(keys, dim=-1).values)


def sort_merge_lookup_with_dups(table, keys):
    """`sort_merge_lookup` and the duplicate count of `keys`
    (len - n_unique, f64[...])."""
    return _lookup(table, keys), _dup_count(keys)


def iota_table_lookup(table, keys, with_dups=False):
    """rows[..., i] = table[keys[..., i]] for an iota-keyed table; keys must
    lie in [0, L) (outside it the JAX package's merged layout is not
    defined). With `with_dups`, also the duplicate count of `keys`."""
    out = _lookup(table, keys)
    if with_dups:
        return out, _dup_count(keys)
    return out


def apply_permutation(x, p):
    """y[..., i] = x[..., p[..., i]] along the last axis.

    The JAX package avoids gathers with a double-sort identity because a TPU
    has no hardware gather; a GPU gathers natively, so this is one
    `torch.gather` with the same result."""
    return torch.gather(x, -1, p.long())
