"""Entity tabu rings and position selectors (counterpart of
`greyjack_tpu/ops/selection.py`).

Per semantic group, a ring buffer of recently touched slot ids. The rings
of all islands are one tensor with a leading island axis: ring
i32[I, G, cap], cursor i32[I, G]. Writes are compare-selects, so no two
writes race. The selectors (Gumbel top-k, distinct pair, random
permutation) take their noise as tensors; the move samplers draw it.
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


# --- position selection ------------------------------------------------------
# Each selector below is the deterministic half of its JAX counterpart: it
# takes the drawn noise (Gumbels or uniforms, batched over any leading axes)
# and gives, bit for bit, what the JAX function gives for the same noise.
# The draws themselves live with the move samplers (`ops/moves.py`).

TABU_PENALTY = 1.0e9


def topk_first(score, k):
    """int32[..., k]: the indices of the k largest entries of f32
    `score[..., n]`, largest first and, among equal entries, the lower
    index first — the order of `lax.top_k`: a stable descending sort cut
    to k, under the floats' total order (-0.0 ranks below 0.0, as in XLA).
    `torch.topk` orders ties as it likes, differently on the CPU and the
    card, so it ranks distinct int64 keys instead: the score's
    order-preserving integer image above, the reversed index below (no NaN
    reaches here)."""
    n = score.shape[-1]
    bits = score.contiguous().view(torch.int32).to(torch.int64)
    mono = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    rev = torch.arange(n - 1, -1, -1, dtype=torch.int64, device=score.device)
    key = mono * (1 << 32) + rev
    return torch.topk(key, k, dim=-1).indices.to(torch.int32)


def gumbel_topk_positions(gumbels, limit, k_max, tabu_mask=None):
    """Up to `k_max` distinct positions of [0, limit), most preferred first
    (`greyjack_tpu/ops/selection.py:21-43`). gumbels: f32[..., max_len];
    limit: int[...]; tabu_mask: optional bool[..., max_len], True = tabu
    (penalized). Returns int32[..., k_max]; when k_max > max_len the
    selection repeats cyclically (callers mask past their count)."""
    max_len = gumbels.shape[-1]
    pos = torch.arange(max_len, dtype=torch.int32, device=gumbels.device)
    valid = pos < limit[..., None]
    score = torch.where(valid, gumbels, float("-inf"))
    if tabu_mask is not None:
        score = score - torch.where(tabu_mask & valid, TABU_PENALTY, 0.0).to(
            torch.float32)
    k_eff = min(k_max, max_len)
    top = topk_first(score, k_eff)
    if k_eff < k_max:
        reps = -(-k_max // k_eff)
        top = torch.cat([top] * reps, dim=-1)[..., :k_max]
    return top


def sample_distinct_pair(u_a, u_b, limit, tabu_masks=None, group_idx=None):
    """Two distinct uniform positions of [0, limit)
    (`greyjack_tpu/ops/selection.py:46-90`). u_a, u_b: f32[I, ..., A]
    uniforms, A = 1 without tabu and the retry count with it; limit:
    int[I, ...]. With tabu_masks bool[I, G, lmax] and group_idx int[I, ...],
    each position is the first of its A draws that is not tabu, or the last
    draw when all are. b is drawn over limit - 1 and shifted past a.
    Returns int32[I, ..., 2]."""
    limit = torch.clamp(limit, min=1).to(torch.int32)
    lim_b = torch.clamp(limit - 1, min=1)
    if tabu_masks is None:
        a = torch.floor(u_a[..., 0] * limit.to(torch.float32)).to(torch.int32)
        b1 = torch.floor(u_b[..., 0] * lim_b.to(torch.float32)).to(torch.int32)
        b = torch.where(limit > 1, b1 + (b1 >= a).to(torch.int32), a)
        return torch.stack([a, b], dim=-1)

    n_isl, lmax = tabu_masks.shape[0], tabu_masks.shape[-1]
    isl = torch.arange(n_isl, device=u_a.device).view(
        (n_isl,) + (1,) * (u_a.dim() - 1))
    grp = group_idx.long()[..., None]

    def is_tabu(c):
        # out-of-range ids clamp, as a JAX gather does
        return tabu_masks[isl, grp, torch.clamp(c, 0, lmax - 1).long()]

    def first_free(us, lim, taken):
        cands = torch.floor(us * lim.to(torch.float32)[..., None]).to(
            torch.int32)
        free = ~taken(cands)
        pick = torch.argmax(free.to(torch.int32), dim=-1, keepdim=True)
        return torch.where(free.any(-1),
                           torch.gather(cands, -1, pick)[..., 0],
                           cands[..., -1])

    a = first_free(u_a, limit, is_tabu)
    b1 = first_free(u_b, lim_b,
                    lambda c: is_tabu(c + (c >= a[..., None]).to(torch.int32)))
    b = torch.where(limit > 1, b1 + (b1 >= a).to(torch.int32), a)
    return torch.stack([a, b], dim=-1)


def tabu_mask_for_group(tabu_state, group_idx, tabu_sizes, max_len):
    """bool[I, max_len]: the slots currently tabu in group `group_idx[i]`
    of each island (`greyjack_tpu/ops/selection.py:101-117`)."""
    masks = tabu_masks_all(tabu_state, tabu_sizes, max_len)
    isl = torch.arange(masks.shape[0], device=masks.device)
    return masks[isl, group_idx.long()]


def tabu_mask_row(tabu_masks, group_idx):
    """bool[I, ..., lmax]: each candidate's group row of its island's masks
    bool[I, G, lmax]; group_idx: int[I, ...]."""
    n_isl = tabu_masks.shape[0]
    isl = torch.arange(n_isl, device=tabu_masks.device).view(
        (n_isl,) + (1,) * (group_idx.dim() - 1))
    return tabu_masks[isl, group_idx.long()]


def random_permutation_positions(gumbels, count):
    """int32[..., k_max]: a permutation of [0, count) by the Gumbels'
    descending order, then the identity up to k_max
    (`greyjack_tpu/ops/selection.py:175-185`). gumbels: f32[..., k_max];
    count: int[...]."""
    k_max = gumbels.shape[-1]
    i = torch.arange(k_max, dtype=torch.int32, device=gumbels.device)
    live = i < count[..., None]
    score = torch.where(live, gumbels, float("-inf"))
    perm = topk_first(score, k_max)
    return torch.where(live, perm, i)
