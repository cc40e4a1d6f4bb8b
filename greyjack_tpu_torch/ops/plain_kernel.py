"""The VRP plain score's route analysis as one CUDA kernel
(`csrc/vrp_plain.cu`): the stable sort of every row's stops by vehicle,
the legs, the time-window walk, the duplicate count and the per-vehicle
loads, in one launch, with the integers of the torch body.

`models/vrp/cotwin_builder.py` `build_common` calls `route_analysis` where
`eligible` holds, and otherwise runs its torch body, which is the plain
version of this kernel (`routes.sort_stops_by_vehicle`,
`routes.vrp_routes_packed`, `segments.count_minus_n_unique`,
`segments.segment_sum`); the exact f64-order walk and the partitioned
facts' `dm_at` accessor stay torch. The kernel takes rows of any width:
a row whose working set fits a block's shared memory is kept there, a
wider one in a global scratch buffer (`plan`).

The library is built from the source with nvcc on first use
(`cuda_build.load_library`); nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os

import torch

_SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "vrp_plain.cu")

# the C entry point's `dims`, in the order of its `Dim` enum
DIMS = ("rows", "stops", "vehicles", "locations", "time_windowed", "smem",
        "blocks")
WARPS = 8                   # the kernel's kThreads / 32
SMEM_MAX = 227 * 1024       # Hopper's opt-in shared memory of a block
RED_BYTES = 8 * 2 * WARPS + 4 * WARPS   # the block's reductions (kRedBytes)
SCRATCH_MAX = 256 << 20     # bytes of the scratch buffer of wide rows
GRID_MAX = 2 ** 31 - 1      # blocks of a launch
_LIB = {}


def _library():
    if "lib" not in _LIB:
        from greyjack_tpu_torch import cuda_build

        lib = cuda_build.load_library("vrp_plain", [_SOURCE])
        fn = lib.gj_vrp_plain
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB["lib"] = lib
    return _LIB["lib"]


def row_ints(n, k, l):
    """The i32 words of the working set of a row of `n` stops, `k`
    vehicles and `l` locations (the .cu's `row_ints`)."""
    return 4 * n + WARPS * k + 3 * k + (l + 31) // 32


def shared_bytes(n, k, l):
    """Shared memory a block indexes with the row kept there."""
    return RED_BYTES + 4 * row_ints(n, k, l)


def fits(n, k, l):
    """Whether such a row's working set fits a block's shared memory."""
    return shared_bytes(n, k, l) <= SMEM_MAX


def plan(rows, n, k, l, sms):
    """(shared bytes, blocks, scratch ints) of a launch over `rows` rows on
    a card of `sms` multiprocessors: a block a row with the row in shared
    memory where it `fits`; else as many blocks as the card holds at once
    (8 an SM), fewer where their slabs would pass SCRATCH_MAX, looping over
    the rows, each with its working set in its slab of a global buffer."""
    if fits(n, k, l):
        return shared_bytes(n, k, l), min(rows, GRID_MAX), 0
    per = row_ints(n, k, l)
    blocks = max(1, min(rows, 8 * sms, SCRATCH_MAX // (4 * per)))
    return RED_BYTES, blocks, blocks * per


def eligible(vehicle_ids, utils):
    """Whether `build_common` runs the kernel on these columns: a CUDA
    population on the integer-milli path (not `exact_fp_scores`) with the
    dense matrix (no `dm_at`)."""
    return (vehicle_ids.is_cuda and not utils["exact_fp_scores"]
            and utils.get("dm_at") is None)


def _table(t, dtype, shape, name):
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"plain kernel: {name} must be contiguous {dtype} "
                         f"{shape}, got {t.dtype} {tuple(t.shape)}")
    return t


def route_analysis(vehicle_ids, customer_ids, utils):
    """(distance i64[...] in milli, time penalty i64[...], N - distinct
    customers i32[...], loads i32[..., K]) of the rows `vehicle_ids`,
    `customer_ids` i32[..., N] (fixed columns, contiguous, on a CUDA
    device), with the VRP cotwin's utility objects. Launches on the
    current stream; raises if the inputs or the launch are refused.
    `route_analysis.launches` counts launches."""
    n = vehicle_ids.shape[-1]
    k, l = utils["k_vehicles"], utils["n_locations"]
    for name, t in (("vehicle_id", vehicle_ids), ("customer_id",
                                                  customer_ids)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"plain kernel: {name} must be contiguous "
                             f"int32, got {t.dtype}")
        if t.device.type != "cuda":
            raise ValueError(f"plain kernel: unsupported device {t.device}")
    dev = vehicle_ids.device
    if customer_ids.shape != vehicle_ids.shape or customer_ids.device != dev:
        raise ValueError("plain kernel: the two columns differ in shape or "
                         "device")
    if min(n, k, l) < 1:
        raise ValueError(f"plain kernel: rows of {n} stops, {k} vehicles, "
                         f"{l} locations")
    tables = [  # in the order of the C entry point's arguments
        _table(utils["dm_flat_milli"], torch.int32, (l * l,),
               "dm_flat_milli"),
        _table(utils["cust_packed"], torch.int32, (l, 4), "cust_packed"),
        _table(utils["vehicle_depot_ids"], torch.int32, (k,),
               "vehicle_depot_ids"),
        _table(utils["work_day_start_k"], torch.int32, (k,),
               "work_day_start_k"),
        _table(utils["work_day_end_k"], torch.int32, (k,), "work_day_end_k"),
    ]
    for t in tables:
        if t.device != dev:
            raise ValueError(f"plain kernel: a table is on {t.device}")
    if tables[1].data_ptr() % 16:
        raise ValueError("plain kernel: cust_packed is not 16-byte aligned")
    lead = vehicle_ids.shape[:-1]
    dist = torch.empty(lead, dtype=torch.int64, device=dev)
    late = torch.empty(lead, dtype=torch.int64, device=dev)
    dups = torch.empty(lead, dtype=torch.int32, device=dev)
    loads = torch.empty(lead + (k,), dtype=torch.int32, device=dev)
    rows = dist.numel()
    if rows == 0:
        return dist, late, dups, loads
    smem, blocks, scratch_ints = plan(
        rows, n, k, l, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    scratch = (torch.empty(scratch_ints, dtype=torch.int32, device=dev)
               if scratch_ints else None)
    dims = {"rows": rows, "stops": n, "vehicles": k, "locations": l,
            "time_windowed": int(bool(utils["time_windowed"])),
            "smem": smem, "blocks": blocks}
    host_dims = (ctypes.c_longlong * len(DIMS))(*(dims[d] for d in DIMS))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().gj_vrp_plain(
        vehicle_ids.data_ptr(), customer_ids.data_ptr(),
        *(t.data_ptr() for t in tables), dist.data_ptr(), late.data_ptr(),
        dups.data_ptr(), loads.data_ptr(),
        None if scratch is None else scratch.data_ptr(), host_dims,
        len(DIMS), stream)
    if err != 0:
        raise RuntimeError(f"plain kernel launch failed (cudaError {err})")
    route_analysis.launches += 1
    return dist, late, dups, loads


route_analysis.launches = 0
