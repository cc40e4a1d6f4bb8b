"""Fused VRP delta (incremental) scorer: torch stages around a hand-written
CUDA kernel. Port of `greyjack_tpu/models/vrp/delta_pallas.py`.

Stages, as in the JAX package:
  `_pre`          per-neighbour scalar analysis (`_delta_common`) and the
                  packed per-(neighbour, route) kernel input columns;
  `_call_kernel`  the fused route pipeline, one row per (island, neighbour,
                  affected route): `csrc/vrp_delta.cu` on a CUDA tensor, on
                  the route `_kernel_plan` picks by shape ("shared": the
                  island's routes in shared memory, a thread a row;
                  "direct": a warp a row reading device memory),
                  `_kernel_reference` (plain torch) on a CPU tensor;
  `_post`         the one distance-matrix gather per neighbour, loads, and
                  lexicographic score assembly (f64 rows or i32 delta rows).

What the kernel computes per row (`delta_pallas.py:_kernel`): fetch the
base route row (6 payload tables of the ctx), patch stay rows, compute each
slot's shift (inserts before minus removals before), merge survivors and
inserts, run the integer lateness prefix scan, and extract the chain-leg
sum, the route endpoints and the 4*kd dirty-pair (u, v, carried leg) values.
All four output blocks are i32 [rows, 8] and bit-equal to the Pallas
kernel's.

Shapes: ctx leaves carry a leading island axis I; deltas are [I, P, K];
kernel rows are ordered (island, neighbour, route), so a row's island is
row // (P * A).
"""

from __future__ import annotations

import ctypes
import os

import torch

from greyjack_tpu_torch.ops import moves, lexico
from greyjack_tpu_torch.utils.math_utils import true_div
from greyjack_tpu_torch.utils.tracing import span
from greyjack_tpu_torch.models.vrp.cotwin_builder import _delta_common, _take

_BIG = 1 << 30
_I32 = torch.int32
_I64 = torch.int64
_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc", "vrp_delta.cu")


def n_routes(kd):
    """Route rows per neighbour: a kd <= 2 delta touches at most 3 distinct
    routes, so the 2*kd affected-route slots compact to min(3, 2*kd)."""
    return min(3, 2 * kd)


def _route_pad(route_cap):
    """Route slots per kernel row: route_cap rounded up to 128 (32 lanes of
    a warp x 4 slots)."""
    return -(-route_cap // 128) * 128


def eligible(utils, deltas):
    """Static eligibility of the fused kernel for these deltas."""
    return eligible_width(utils, deltas["positions"].shape[-1])


def eligible_width(utils, kd):
    """Static eligibility of the fused kernel: narrow deltas (kd <= 2), i32
    accumulation bounds, and a route cap the kernel's per-warp shared row
    holds (<= 512 slots)."""
    return (kd <= 2 and utils["acc_dtype"] == torch.int32
            and utils["route_cap"] <= 512)


def score_delta_batch(ctx, deltas, utils):
    """f64[I, P, S] score rows of every island's neighbourhood, or None when
    the kernel is statically ineligible."""
    if not eligible(utils, deltas):
        return None
    return _score(ctx, deltas, utils, as_ints=False)


def score_delta_batch_ints(ctx, deltas, utils):
    """i32[I, P, 3] delta rows (1000*d_dups + d_overflow, d_late,
    d_dist_milli), lexicographically order-equivalent to the f64 rows;
    over-cap / poisoned-base neighbours become INT32_MAX rows, which never
    pass an accept-if-<=-zero test. None when the kernel is ineligible."""
    if not eligible(utils, deltas):
        return None
    return _score(ctx, deltas, utils, as_ints=True)


def _score(ctx, deltas, utils, as_ints):
    """The three stages, each in its span."""
    with span("gj.delta.pre"):
        inputs, aux = _pre(ctx, deltas, utils)
    with span("gj.delta.kernel"):
        outs = _call_kernel(inputs, utils, aux["kd"], aux["n_islands"])
    with span("gj.delta.post"):
        return _post(outs, aux, ctx, utils, as_ints=as_ints)


def _compact_routes(c, kd, k):
    """Compact the 2*kd affected-route slots to `n_routes(kd)`: slot j holds
    the j-th distinct affected vehicle, sentinel k otherwise; a_of_* are
    remapped by vehicle-id match. A delta touching more distinct vehicles
    than that is flagged `compact_bad` and scores as the stub."""
    nr = n_routes(kd)
    if nr >= 2 * kd:
        return c
    av4, arep4 = c["av"], c["arep"]
    dev = av4.device
    rank = torch.cumsum(arep4.to(_I32), dim=-1, dtype=_I32) - arep4.to(_I32)
    m = arep4[..., None] & (rank[..., None] == torch.arange(nr, device=dev))
    av3 = (torch.sum(torch.where(m, av4[..., None], 0), dim=-2, dtype=_I32)
           + torch.where(torch.any(m, dim=-2), 0, k).to(_I32))
    a_of_row = torch.argmax(
        (av3[..., None, :] == c["old_v"][..., :, None]).to(_I32),
        dim=-1).to(_I32)
    a_of_new = torch.argmax(
        (av3[..., None, :] == c["new_v"][..., :, None]).to(_I32),
        dim=-1).to(_I32)
    compact_bad = torch.sum(arep4, dim=-1) > nr
    return {**c, "av": av3, "arep": av3 < k,
            "av_safe": torch.clamp(av3, max=k - 1),
            "a_of_row": a_of_row, "a_of_new": a_of_new,
            "compact_bad": compact_bad}


def _pre(ctx, deltas, utils):
    """Stage 1: per-neighbour analysis and the packed kernel inputs."""
    kd = deltas["positions"].shape[-1]
    n_isl, p = deltas["positions"].shape[:2]
    a2 = n_routes(kd)
    r = utils["route_cap"]
    rp = _route_pad(r)
    n = ctx["v"].shape[-1]
    tw = bool(utils["time_windowed"])
    dev = deltas["positions"].device

    c = _delta_common(ctx, moves.dedupe_delta(deltas), utils)
    c = _compact_routes(c, kd, utils["k_vehicles"])
    rows = c["rows"]                                      # [I, P, KD]
    rep = c["rep"]
    old_v, new_v, new_c = c["old_v"], c["new_v"], c["new_c"]
    veh_changed, stay = c["veh_changed"], c["stay"]
    arep, av_safe = c["arep"], c["av_safe"]
    a_of_row, a_of_new = c["a_of_row"], c["a_of_new"]
    slot = c["slot_of_row"]

    # closed-form shift at each rep row's own cell
    vc_j = veh_changed[..., None, :]
    ins_at = torch.sum(vc_j & (new_v[..., None, :] == old_v[..., :, None])
                       & (rows[..., None, :] < rows[..., :, None]),
                       dim=-1, dtype=_I32)
    rem_at = torch.sum(vc_j & (old_v[..., None, :] == old_v[..., :, None])
                       & (slot[..., None, :] < slot[..., :, None]),
                       dim=-1, dtype=_I32)
    locus = slot + ins_at - rem_at

    # insert ranks among same-route inserts (by stop-id order)
    ins_key = torch.where(veh_changed, rows, n)
    same_new = (veh_changed[..., :, None] & vc_j
                & (a_of_new[..., :, None] == a_of_new[..., None, :]))
    ins_rank_ins = torch.sum(same_new & (ins_key[..., None, :]
                                         < ins_key[..., :, None]),
                             dim=-1, dtype=_I32)

    # one packed per-vehicle gather (wds, wde, len, dist, late, load, cap,
    # depot)
    vp = _take(ctx["veh_pack"], av_safe)                  # [I, P, A, 8]

    ai = torch.arange(a2, dtype=_I32, device=dev)
    n_clr = torch.sum(vc_j & (a_of_row[..., None, :] == ai[:, None]),
                      dim=-1, dtype=_I32)
    n_ins = torch.sum(vc_j & (a_of_new[..., None, :] == ai[:, None]),
                      dim=-1, dtype=_I32)
    length = vp[..., 2] - n_clr + n_ins                   # [I, P, A]
    over_cap = torch.any(arep & (length > r), dim=-1)
    if "compact_bad" in c:
        over_cap = over_cap | c["compact_bad"]

    def per_k_row(flag_k, val_k, a_k):
        m = flag_k[..., None] & (a_k[..., None] == ai)
        return torch.where(m, val_k[..., None], -1)

    pslot = [per_k_row(stay[..., k], slot[..., k], a_of_row[..., k])
             for k in range(kd)]
    cslot = [per_k_row(veh_changed[..., k], slot[..., k], a_of_row[..., k])
             for k in range(kd)]
    iflag = [(veh_changed[..., k, None] & (a_of_new[..., k, None] == ai)
              ).to(_I32) for k in range(kd)]
    irow = [rows[..., k, None].expand(n_isl, p, a2) for k in range(kd)]
    irank = [ins_rank_ins[..., k, None].expand(n_isl, p, a2)
             for k in range(kd)]
    zero_pa = torch.zeros((n_isl, p, a2), dtype=_I32, device=dev)
    if tw:
        w0row, w1row = vp[..., 0], vp[..., 1]
    else:
        w0row, w1row = zero_pa, zero_pa

    nrows = n_isl * p * a2

    def pack(cols, fill):
        cols = cols + [fill] * (8 - len(cols))
        return torch.stack(cols, dim=-1).to(_I32).reshape(nrows, 8)

    sc_pack = pack(pslot + cslot + [w0row, w1row, length], zero_pa)
    ins_pack = pack(iflag + irow + irank, zero_pa)

    crows = utils["cust_packed"][new_c.long()]            # [I, P, KD, 4]
    ct_p = crows[..., 3]
    fl_p = crows[..., 1] + crows[..., 3]
    ce_p = crows[..., 2]
    dem_new = crows[..., 0]
    pay_cols = []
    for k in range(kd):
        pay_cols += [new_c[..., k], ct_p[..., k], fl_p[..., k], ce_p[..., k]]
    pay_cols += [torch.zeros_like(new_c[..., 0])] * (8 - len(pay_cols))
    pay_pack = (torch.stack(pay_cols, dim=-1).to(_I32)[:, :, None, :]
                .expand(n_isl, p, a2, 8).reshape(nrows, 8))

    # E1 / E2 extraction slots (known before the merge): on a_of_row rows
    e1 = [per_k_row(rep[..., k], locus[..., k] - 1, a_of_row[..., k])
          for k in range(kd)]
    e2 = [per_k_row(stay[..., k], locus[..., k], a_of_row[..., k])
          for k in range(kd)]
    el_pack = pack(e1 + e2, zero_pa - 1)

    av_col = av_safe.to(_I32).reshape(nrows, 1)

    pad = rp - r

    def padded(name, fill):
        return torch.nn.functional.pad(ctx[name], (0, pad), value=fill)

    ctx_mat = torch.cat([
        padded("r_stop", n), padded("r_c", 0), padded("r_ct", 0),
        padded("r_floor", 0), padded("r_ce", 0), padded("r_leg", 0),
    ], dim=-1).contiguous()                               # [I, K, 6*Rp]

    inputs = (ctx_mat, av_col, sc_pack, ins_pack, pay_pack, el_pack)
    aux = {"kd": kd, "n_islands": n_isl, "c": c, "locus": locus,
           "length": length, "over_cap": over_cap, "vp": vp,
           "dem_new": dem_new}
    return inputs, aux


def _kernel_reference(ctx_mat, av_col, sc, ins, pay, el, *, kd, tw,
                      rows_per_island):
    """Plain torch version of the CUDA kernel (and of the Pallas `_kernel`):
    the whole [rows, Rp] grid at once, with masked rolls for the merge."""
    nrows = av_col.shape[0]
    rp = ctx_mat.shape[-1] // 6
    dev = ctx_mat.device
    zero = torch.zeros((nrows, 1), dtype=_I32, device=dev)
    lane = torch.arange(rp, dtype=_I32, device=dev)[None, :]

    isl = torch.arange(nrows, device=dev) // rows_per_island
    base = ctx_mat[isl, av_col[:, 0].long()]              # [rows, 6*Rp]
    r_stop, r_c, r_ct, r_fl, r_ce, r_leg = (
        base[:, f * rp:(f + 1) * rp] for f in range(6))

    for k in range(kd):
        pm = lane == sc[:, k:k + 1]
        r_c = torch.where(pm, pay[:, 4 * k:4 * k + 1], r_c)
        r_ct = torch.where(pm, pay[:, 4 * k + 1:4 * k + 2], r_ct)
        r_fl = torch.where(pm, pay[:, 4 * k + 2:4 * k + 3], r_fl)
        r_ce = torch.where(pm, pay[:, 4 * k + 3:4 * k + 4], r_ce)

    cleared = torch.zeros((nrows, rp), dtype=torch.bool, device=dev)
    rem_before = torch.zeros((nrows, rp), dtype=_I32, device=dev)
    for k in range(kd):
        cp = sc[:, kd + k:kd + k + 1]
        cleared = cleared | (lane == cp)
        rem_before = rem_before + ((cp >= 0) & (cp < lane)).to(_I32)
    ins_before = torch.zeros((nrows, rp), dtype=_I32, device=dev)
    iflag = []
    for k in range(kd):
        fl = ins[:, k:k + 1] > 0
        iflag.append(fl)
        ins_before = ins_before + (fl & (ins[:, kd + k:kd + k + 1] < r_stop)
                                   ).to(_I32)
    shift = ins_before - rem_before
    survives = ~cleared

    # merge: a survivor at slot j moves to j + shift (|shift| <= kd) and is
    # dropped when that falls outside [0, Rp)
    keys = [r_c, r_leg] + ([r_ct, r_fl, r_ce] if tw else [])
    merged = [torch.zeros((nrows, rp), dtype=_I32, device=dev) for _ in keys]
    for s in range(-kd, kd + 1):
        m = survives & (shift == s)
        keep = (lane >= s) if s >= 0 else (lane < rp + s)
        for i, key in enumerate(keys):
            moved = torch.roll(torch.where(m, key, 0), s, dims=1)
            merged[i] = merged[i] + torch.where(keep, moved, 0)

    ins_pos = []
    for k in range(kd):
        rank_base = torch.sum(
            iflag[k] & survives & (ins[:, kd + k:kd + k + 1] >= r_stop),
            dim=1, keepdim=True, dtype=_I32)
        ip = rank_base + ins[:, 2 * kd + k:2 * kd + k + 1]
        ins_pos.append(ip)
        im = iflag[k] & (lane == ip)
        ins_vals = [pay[:, 4 * k:4 * k + 1], zero]
        if tw:
            ins_vals += [pay[:, 4 * k + 1:4 * k + 2],
                         pay[:, 4 * k + 2:4 * k + 3],
                         pay[:, 4 * k + 3:4 * k + 4]]
        for i in range(len(keys)):
            merged[i] = torch.where(im, ins_vals[i], merged[i])
    m_c, m_leg = merged[0], merged[1]

    length = sc[:, 2 * kd + 2:2 * kd + 3]
    vj = lane < length
    has = length > 0

    if tw:
        m_ct, m_fl, m_ce = merged[2], merged[3], merged[4]
        ct = torch.where(vj, m_ct, 0)
        fl = torch.where(vj, m_fl, -_BIG)
        p = torch.cumsum(ct, dim=1, dtype=_I32)
        cm = torch.cummax(fl - p, dim=1).values
        w0 = sc[:, 2 * kd:2 * kd + 1]
        w1 = sc[:, 2 * kd + 1:2 * kd + 2]
        post = p + torch.maximum(w0, cm)
        late = torch.where(vj, torch.clamp(post - m_ce, min=0), 0)
        late_sum = torch.sum(late, dim=1, keepdim=True, dtype=_I32)
        overtime = torch.where(
            has, torch.clamp(post[:, rp - 1:rp] - w1, min=0), 0)
        late_total = late_sum + overtime
    else:
        late_total = zero

    vpair = vj & (lane + 1 < length)
    chain = torch.sum(torch.where(vpair, m_leg, 0), dim=1, keepdim=True,
                      dtype=_I32)
    first_c = m_c[:, 0:1]
    last_c = torch.sum(torch.where(lane == length - 1, m_c, 0), dim=1,
                       keepdim=True, dtype=_I32)

    # dirty-pair slots: E1 (locus-1), E2 (locus, stay) from `_pre`; E3
    # (ins_pos-1), E4 (ins_pos) from the insert positions; -1 disables
    slot_cols = (
        [el[:, k:k + 1] for k in range(kd)]
        + [el[:, kd + k:kd + k + 1] for k in range(kd)]
        + [torch.where(iflag[k], ins_pos[k] - 1, -1) for k in range(kd)]
        + [torch.where(iflag[k], ins_pos[k], -1) for k in range(kd)])
    us, vs, cs = [], [], []
    for col in slot_cols:
        at = lane == col
        right = (lane == col + 1) & (col >= 0)
        us.append(torch.sum(torch.where(at, m_c, 0), 1, True, dtype=_I32))
        vs.append(torch.sum(torch.where(right, m_c, 0), 1, True, dtype=_I32))
        cs.append(torch.sum(torch.where(at, m_leg, 0), 1, True, dtype=_I32))
    pad = [zero] * (8 - 4 * kd)
    ip_out = [torch.where(iflag[k], ins_pos[k], -1) for k in range(kd)]
    misc = torch.cat([late_total, chain, first_c, last_c] + ip_out
                     + [zero] * (2 - kd) + [zero] * 2, dim=1)
    return (misc, torch.cat(us + pad, dim=1), torch.cat(vs + pad, dim=1),
            torch.cat(cs + pad, dim=1))


# The H100's shared memory for one block, and the kernel's block sizes
# (`kMaxWarps`, `kDirectWarps` and `kRoutePad` in csrc/vrp_delta.cu, whose
# `layout_bytes` refuses a launch given less than this plan's smem_bytes)
_SMEM_LIMIT = 232_448
_SMEM_RESERVED = 64           # the block's mbarrier (static shared memory)
_MAX_WARPS = 24
_DIRECT_WARPS = 8
_ROUTE_PAD = 4
ROUTES = ("direct", "shared")


def _kernel_plan(rows_per_island, k, rp, tw):
    """(route, warps, smem_bytes) of one kernel launch, a static choice by
    shape. "shared": the island has at least K rows to share its K routes,
    Rp is 128, and one block's shared memory holds the routes (K x (6*rp +
    4) i32, padded for the banks), their lengths, and one byte a slot for
    each of its threads, one thread walking a row. "direct" otherwise: one
    warp a row, its route read from device memory, its merge in a shared
    row of NK x rp keys beside a 32-word stash."""
    threads = 32 * _MAX_WARPS
    smem = 4 * k * (6 * rp + _ROUTE_PAD) + 4 * k + rp * threads
    if (rows_per_island >= k and rp <= 128
            and smem + _SMEM_RESERVED <= _SMEM_LIMIT):
        return "shared", _MAX_WARPS, smem
    nk = 5 if tw else 2
    return "direct", _DIRECT_WARPS, _DIRECT_WARPS * 4 * (32 + nk * rp)


_LIB = {}
_SMS = {}


def _library():
    """The compiled kernel library, built from `csrc/vrp_delta.cu` on first
    use (see `cuda_build.load_library`)."""
    if "lib" not in _LIB:
        from greyjack_tpu_torch import cuda_build

        lib = cuda_build.load_library("vrp_delta", [_SOURCE])
        fn = lib.gj_vrp_delta
        fn.argtypes = ([ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB["lib"] = lib
    return _LIB["lib"]


def _kernel_args(inputs, outs, utils, kd, n_islands):
    """The C entry point's arguments but the stream: pointers, shapes, and
    the launch plan of `_kernel_plan`."""
    ctx_mat, av_col = inputs[0], inputs[1]
    dev = ctx_mat.device
    nrows = av_col.shape[0]
    kveh = utils["k_vehicles"]
    rp = ctx_mat.shape[-1] // 6
    tw = bool(utils["time_windowed"])
    route, warps, smem = _kernel_plan(nrows // n_islands, kveh, rp, tw)
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return (*(t.data_ptr() for t in inputs), *(o.data_ptr() for o in outs),
            nrows, nrows // n_islands, kveh, rp, kd, int(tw),
            utils["n_stops"], ROUTES.index(route), warps, smem,
            _SMS[dev.index])


def _call_kernel(inputs, utils, kd, n_islands):
    """Stage 2: the fused route kernel over all I*P*A rows.

    On a CUDA tensor this launches `gj_vrp_delta` (csrc/vrp_delta.cu) or
    raises; on a CPU tensor it runs `_kernel_reference`. Outputs:
    (misc, u, v, c), i32 [rows, 8] each. `_call_kernel.launches` counts
    kernel launches."""
    ctx_mat, av_col, sc_pack, ins_pack, pay_pack, el_pack = inputs
    tw = bool(utils["time_windowed"])
    nrows = av_col.shape[0]
    rows_per_island = nrows // n_islands
    dev = ctx_mat.device
    if dev.type == "cpu":
        return _kernel_reference(ctx_mat, av_col, sc_pack, ins_pack,
                                 pay_pack, el_pack, kd=kd, tw=tw,
                                 rows_per_island=rows_per_island)
    if dev.type != "cuda":
        raise ValueError(f"vrp delta kernel: unsupported device {dev}")
    kveh = utils["k_vehicles"]
    rp = ctx_mat.shape[-1] // 6
    if not (1 <= kd <= 2 and rp % 128 == 0 and rp <= 512):
        raise ValueError(f"vrp delta kernel: unsupported kd={kd} rp={rp}")
    if ctx_mat.shape != (n_islands, kveh, 6 * rp):
        raise ValueError(f"vrp delta kernel: ctx_mat shape {ctx_mat.shape}")
    if nrows != n_islands * rows_per_island:
        raise ValueError("vrp delta kernel: rows do not split over islands")
    for name, t, cols in (("ctx_mat", ctx_mat, 6 * rp), ("av_col", av_col, 1),
                          ("sc", sc_pack, 8), ("ins", ins_pack, 8),
                          ("pay", pay_pack, 8), ("el", el_pack, 8)):
        # the kernel copies route slabs with 16-byte aligned bulk copies
        if (t.device != dev or t.dtype != _I32 or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"vrp delta kernel: {name} must be contiguous, "
                             f"16-byte aligned int32 on {dev}")
        if t.shape[-1] != cols or (t is not ctx_mat and t.shape[0] != nrows):
            raise ValueError(f"vrp delta kernel: {name} shape {tuple(t.shape)}")
    outs = [torch.empty((nrows, 8), dtype=_I32, device=dev) for _ in range(4)]
    if nrows == 0:
        return tuple(outs)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.gj_vrp_delta(*_kernel_args(inputs, outs, utils, kd, n_islands),
                           stream)
    if err != 0:
        raise RuntimeError(f"vrp delta kernel launch failed (cudaError {err})")
    _call_kernel.launches += 1
    return tuple(outs)


_call_kernel.launches = 0


def _post(outs, aux, ctx, utils, as_ints=False):
    """Stage 3: dirty-pair reassembly, the one distance-matrix gather,
    loads, and score assembly (f64 rows, or i32 delta rows)."""
    misc, u_pk, v_pk, c_pk = outs
    kd = aux["kd"]
    c = aux["c"]
    locus = aux["locus"]
    length = aux["length"]
    over_cap = aux["over_cap"]
    vp = aux["vp"]
    a2 = n_routes(kd)
    n_isl, p = length.shape[:2]
    r = utils["route_cap"]
    l = utils["n_locations"]
    dmf = utils["dm_flat_milli"]
    dev = length.device
    ai = torch.arange(a2, dtype=_I32, device=dev)

    rep = c["rep"]
    old_v, new_v = c["old_v"], c["new_v"]
    veh_changed = c["veh_changed"]
    av, arep = c["av"], c["arep"]
    a_of_row, a_of_new = c["a_of_row"], c["a_of_new"]

    misc = misc.reshape(n_isl, p, a2, 8)
    late = misc[..., 0]                                   # [I, P, A]
    chain_raw = misc[..., 1]
    first_c = misc[..., 2]
    last_c = misc[..., 3]
    ins_pos = torch.amax(misc[..., 4:4 + kd], dim=-2)     # [I, P, KD]

    def collapse(x):                                      # -> [I, P, 8]
        return torch.sum(x.reshape(n_isl, p, a2, 8), dim=-2, dtype=_I32)

    u_all = collapse(u_pk)
    v_all = collapse(v_pk)
    carr_all = collapse(c_pk)

    # reassemble the dirty-pair order of the JAX path:
    # e in [0,KD): (a_of_row, locus-1); [KD,2KD): stay?(a_of_row, locus)
    # : (a_of_new, ins_pos-1); [2KD,3KD): (a_of_new, ins_pos)
    er = torch.cat([a_of_row, torch.where(veh_changed, a_of_new, a_of_row),
                    a_of_new], dim=-1)                    # [I, P, 3KD]
    el = torch.cat([locus - 1, torch.where(veh_changed, ins_pos - 1, locus),
                    ins_pos], dim=-1)
    ev = torch.cat([rep, rep, veh_changed], dim=-1)
    len_at = torch.gather(length, -1, torch.clamp(er, max=a2 - 1).long())
    ev = ev & (el >= 0) & (el <= len_at - 2)
    ekey = torch.where(ev, er * (r + 1) + el, -1)
    ii3 = torch.arange(3 * kd, device=dev)
    edup = torch.any((ekey[..., :, None] == ekey[..., None, :])
                     & ev[..., :, None] & ev[..., None, :]
                     & (ii3[None, :] < ii3[:, None]), dim=-1)
    ev = ev & ~edup

    def mid(x):
        return torch.where(veh_changed, x[..., 2 * kd:3 * kd],
                           x[..., kd:2 * kd])

    u = torch.cat([u_all[..., :kd], mid(u_all), u_all[..., 3 * kd:4 * kd]],
                  dim=-1)
    v_right = torch.cat([v_all[..., :kd], mid(v_all),
                         v_all[..., 3 * kd:4 * kd]], dim=-1)
    carried = torch.cat([carr_all[..., :kd], mid(carr_all),
                         carr_all[..., 3 * kd:4 * kd]], dim=-1)

    # the ONE consolidated distance-matrix gather + finishing sums
    has = length > 0
    depots = vp[..., 7]
    gidx = torch.cat([
        torch.where(ev, u * l + v_right, 0),
        torch.where(has, depots * l + first_c, 0),
        torch.where(has, last_c * l + depots, 0),
    ], dim=-1)
    gvals = dmf[gidx.long()]
    leg_new = gvals[..., :3 * kd]
    start_leg = torch.where(has, gvals[..., 3 * kd:3 * kd + a2], 0)
    end_leg = torch.where(has, gvals[..., 3 * kd + a2:], 0)

    corr = torch.where(ev, leg_new - carried, 0)          # [I, P, 3KD]
    corr_by_route = torch.sum(
        torch.where(er[..., :, None] == ai, corr[..., :, None], 0), dim=-2,
        dtype=_I32)
    chain = chain_raw + corr_by_route
    dist = torch.where(has, start_leg + end_leg + chain, 0)

    dem_old = c["dem_old"]
    dem_new = aux["dem_new"]
    is_old = old_v[..., None, :] == av[..., :, None]      # [I, P, A, KD]
    is_new = new_v[..., None, :] == av[..., :, None]
    vc = veh_changed[..., None, :]
    contrib = (
        torch.where(vc & is_old, -dem_old[..., None, :], 0)
        + torch.where(vc & is_new, dem_new[..., None, :], 0)
        + torch.where(rep[..., None, :] & ~vc & is_old,
                      (dem_new - dem_old)[..., None, :], 0))
    load = vp[..., 5] + torch.sum(contrib, dim=-1, dtype=_I32)

    cap_a = vp[..., 6]
    m = arep
    bad = over_cap | ctx["base_over"][:, None]
    if as_ints:
        # all-i32 delta rows (acc_dtype == i32 is an eligibility condition,
        # so every term is i32-bounded by construction)
        d_dist = torch.sum(torch.where(m, dist - vp[..., 3], 0), dim=-1,
                           dtype=_I32)
        d_late = torch.sum(torch.where(m, late - vp[..., 4], 0), dim=-1,
                           dtype=_I32)
        d_over = torch.sum(torch.where(
            m, torch.clamp(load - cap_a, min=0)
            - torch.clamp(vp[..., 5] - cap_a, min=0), 0), dim=-1, dtype=_I32)
        d_hard = 1000 * (c["new_dups"] - ctx["dups"][:, None]) + d_over
        out = torch.stack([d_hard, d_late, d_dist], dim=-1)
        return torch.where(bad[..., None], torch.iinfo(_I32).max, out)

    d_dist = torch.sum(torch.where(m, dist - vp[..., 3], 0), dim=-1,
                       dtype=_I64)
    d_late = torch.sum(torch.where(m, late - vp[..., 4], 0), dim=-1,
                       dtype=_I64)
    d_over = torch.sum(torch.where(
        m, torch.clamp(load - cap_a, min=0).to(_I64)
        - torch.clamp(vp[..., 5] - cap_a, min=0).to(_I64), 0), dim=-1)
    hard = (1000.0 * c["new_dups"].to(torch.float64)
            + (ctx["sum_overflow"][:, None] + d_over).to(torch.float64))
    medium = (ctx["sum_late"][:, None] + d_late).to(torch.float64)
    soft = true_div((ctx["sum_dist"][:, None] + d_dist).to(torch.float64),
                    1000.0)
    out = torch.stack([hard, medium, soft], dim=-1)
    stub = lexico.stub_score_row(3, device=dev)
    return torch.where(bad[..., None], stub, out)
