"""Entity tabu rings (counterpart of `greyjack_tpu/ops/selection.py`).

Per semantic group, a ring buffer of recently touched slot ids. The rings
of all islands are one tensor with a leading island axis: ring
i32[I, G, cap], cursor i32[I, G]. Writes are compare-selects, so no two
writes race.
"""

import torch


def make_tabu_state(n_islands, n_groups, capacity, device):
    return {
        "ring": torch.full((n_islands, n_groups, capacity), -1,
                           dtype=torch.int32, device=device),
        "cursor": torch.zeros((n_islands, n_groups), dtype=torch.int32,
                              device=device),
    }


def tabu_masks_all(tabu_state, tabu_sizes, max_len):
    """bool[..., G, max_len]: slots currently tabu in every group — the
    most recent `tabu_sizes[g]` ring entries (`tabu_search_base.rs:91`)."""
    ring = tabu_state["ring"]                                 # [..., G, cap]
    cursor = tabu_state["cursor"]                             # [..., G]
    cap = ring.shape[-1]
    slot = torch.arange(cap, dtype=torch.int32, device=ring.device)
    age = torch.remainder(cursor[..., None] - 1 - slot, cap)
    recent = age < tabu_sizes[:, None]
    entries = torch.where(recent & (ring >= 0), ring, -1)
    lanes = torch.arange(max_len, dtype=torch.int32, device=ring.device)
    return torch.any(entries[..., :, None] == lanes, dim=-2)


def tabu_push(tabu_state, group_idx, positions, count):
    """Push `positions[..., :count]` into each island's ring of group
    `group_idx` (oldest evicted). group_idx, count: int[I];
    positions: int[I, k]."""
    ring = tabu_state["ring"]
    cursor = tabu_state["cursor"]
    g, cap = ring.shape[-2:]
    dev = ring.device
    k_max = positions.shape[-1]
    i = torch.arange(k_max, dtype=torch.int32, device=dev)
    gsel = torch.arange(g, device=dev) == group_idx[:, None]  # [I, G]
    cur = torch.sum(torch.where(gsel, cursor, 0), dim=-1, dtype=cursor.dtype)
    slots = torch.where(i < count[:, None],
                        torch.remainder(cur[:, None] + i, cap), -1)  # [I, k]
    m = (gsel[:, :, None, None]
         & (torch.arange(cap, device=dev)[None, None, :, None]
            == slots[:, None, None, :]))                      # [I, G, cap, k]
    val = torch.sum(torch.where(m, positions[:, None, None, :], 0), dim=-1,
                    dtype=ring.dtype)
    ring = torch.where(torch.any(m, dim=-1), val, ring)
    cursor = torch.where(gsel, torch.remainder(cur + count, cap)[:, None]
                         .to(cursor.dtype), cursor)
    return {"ring": ring, "cursor": cursor}
