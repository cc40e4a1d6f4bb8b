"""The plain step's move sampler as one CUDA kernel
(`csrc/move_sample.cu`): `do_move` and `VariablesManager.fix_all` of every
candidate f[I, P, V] in one launch, bit-equal to the torch body fed the
same uniforms.

`ops/moves.py` `move_population` calls `move_and_fix` for a population on
a CUDA device, after drawing the f64 uniforms u [I, P, W] as the torch
body does (`island_uniforms`, one `torch.rand` an island). The kernel
reads each leaf's columns of u at the offsets `noise_dims` takes from the
draw's own field list (`moves.field_columns`), so the two cannot drift;
the plain torch version of the kernel is the torch body itself
(`moves.do_move`, then `fix_all`), which serves every other device.

The library is built from the source with nvcc on first use
(`cuda_build.load_library`); nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os

import torch

from greyjack_tpu_torch import config

_SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "move_sample.cu")

# the C entry point's `dims`, in the order of its `Dim` enum
DIMS = ("islands", "cands", "vars", "width", "groups", "lmax",
        "off_move", "off_g", "g_lo", "g_hi", "off_count", "off_gumbel",
        "off_kscr", "kscr_lo", "kscr_hi", "off_start", "off_perm",
        "off_res", "enabled", "stride_island", "stride_cand", "stride_var",
        "f64")

# leaf -> (kind, columns, dim of its first column); columns "vars" / "lmax"
# are the variable count / the largest group
_LEAVES = {
    "u_move": ("f64", 1, "off_move"),
    "g": ("int", 1, "off_g"),
    "c_raw": ("count", "vars", "off_count"),
    "gumbel": ("gumbel", "lmax", "off_gumbel"),
    "k_scr": ("int", 1, "off_kscr"),
    "u_start": ("f32", 1, "off_start"),
    "perm_gumbel": ("gumbel", config.SCRAMBLE_MAX, "off_perm"),
    "u_res": ("dtype", config.MAX_MOVE_SIZE, "off_res"),
}
_LIB = {}


def _library():
    if "lib" not in _LIB:
        from greyjack_tpu_torch import cuda_build

        lib = cuda_build.load_library("move_sample", [_SOURCE])
        fn = lib.gj_move_sample
        fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB["lib"] = lib
    return _LIB["lib"]


def noise_dims(columns, n_vars, lmax):
    """The kernel's dims of the draw's layout: `width`, each leaf's first
    column, the integer leaves' bounds, and `off_count` -1 where the draw
    has no Binomial count. `columns` is `moves.field_columns` of
    `moves.move_noise_fields`; raises on a leaf the kernel does not read
    as that kind and width."""
    sizes = {"vars": n_vars, "lmax": lmax}
    dims = {"off_count": -1,
            "width": sum(n for _, _, n, _, _ in columns)}
    seen = set()
    for name, col, n, kind, arg in columns:
        if name not in _LEAVES or name in seen:
            raise ValueError(f"move kernel: unexpected noise leaf {name!r}")
        want_kind, want_n, dim = _LEAVES[name]
        if (kind, n) != (want_kind, sizes.get(want_n, want_n)):
            raise ValueError(f"move kernel: leaf {name!r} is {kind} x {n}")
        seen.add(name)
        dims[dim] = col
    missing = set(_LEAVES) - {"c_raw"} - seen
    if missing:
        raise ValueError(f"move kernel: no noise leaf {sorted(missing)}")
    arg = {name: a for name, _, _, _, a in columns}
    dims["g_lo"], dims["g_hi"] = arg["g"]
    dims["kscr_lo"], dims["kscr_hi"] = arg["k_scr"]
    if (dims["kscr_lo"] < 1 or dims["kscr_hi"] - 1 > config.SCRAMBLE_MAX
            or dims["g_lo"] != 0):
        raise ValueError("move kernel: integer leaves out of range")
    return dims


def _device_table(t, dtype, shape, name):
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"move kernel: {name} must be contiguous {dtype} "
                         f"{shape}, got {t.dtype} {tuple(t.shape)}")
    return t


def move_and_fix(u, columns, population, vm, cfg, tabu_masks):
    """(`vm.fix_all` of do_move's rows f[I, P, V], info {"group" i32[I, P],
    "positions" i32[I, P, 8], "count" i32[I, P]}) of `population` on a
    CUDA device, from the uniforms u f64[I, P, W] laid out as `columns`
    and the tabu masks bool[I, G, lmax] (None without tabu). The rows may
    be a real population or a base expanded with stride 0 over P.
    Launches on the current stream; raises if the launch is refused.
    `move_and_fix.launches` counts launches."""
    n_isl, p, v = population.shape
    dev = population.device
    dt = population.dtype
    if dev.type != "cuda":
        raise ValueError(f"move kernel: unsupported device {dev}")
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"move kernel: unsupported dtype {dt}")
    if v != vm.variables_count:
        raise ValueError(f"move kernel: {v} variables, the manager has "
                         f"{vm.variables_count}")
    lmax = cfg.max_group_size
    dims = noise_dims(columns, v, lmax)
    if (u.device != dev or u.dtype != torch.float64 or not u.is_contiguous()
            or tuple(u.shape) != (n_isl, p, dims["width"])):
        raise ValueError(f"move kernel: u must be contiguous float64 "
                         f"{(n_isl, p, dims['width'])} on {dev}")
    n_groups = vm.group_members.shape[0]
    members = _device_table(vm.group_members, torch.int32, (n_groups, lmax),
                            "group_members")
    tables = {  # in the order of the C entry point's arguments
        "sizes": _device_table(cfg.group_sizes, torch.int32, (n_groups,),
                               "group_sizes"),
        "thr": _device_table(cfg.thresholds, torch.float64, (6,),
                             "thresholds"),
        "rates": _device_table(cfg.group_rates, torch.float64, (n_groups,),
                               "group_rates"),
        "lower": _device_table(vm.lower_bounds.to(dt), dt, (v,), "lower"),
        "upper": _device_table(vm.upper_bounds.to(dt), dt, (v,), "upper"),
        "disc": _device_table(vm.discrete_mask, torch.bool, (v,),
                              "discrete_mask"),
        "frozen": _device_table(vm.frozen_mask, torch.bool, (v,),
                                "frozen_mask"),
        "initial": _device_table(vm.initial_values.to(dt), dt, (v,),
                                 "initial_values"),
    }
    if tabu_masks is not None:
        _device_table(tabu_masks, torch.bool, (n_isl, n_groups, lmax),
                      "tabu_masks")
    for name, t in [("u", u), ("members", members), ("masks", tabu_masks),
                    *tables.items()]:
        if t is not None and t.device != dev:
            raise ValueError(f"move kernel: {name} is on {t.device}")

    out = torch.empty((n_isl, p, v), dtype=dt, device=dev)
    info = {"group": torch.empty((n_isl, p), dtype=torch.int32, device=dev),
            "positions": torch.empty((n_isl, p, config.MAX_MOVE_SIZE),
                                     dtype=torch.int32, device=dev),
            "count": torch.empty((n_isl, p), dtype=torch.int32, device=dev)}
    if out.numel() == 0:
        return out, info
    s_isl, s_p, s_v = population.stride()
    dims.update(islands=n_isl, cands=p, vars=v, groups=n_groups, lmax=lmax,
                enabled=sum(1 << k for k in cfg.enabled),
                stride_island=s_isl, stride_cand=s_p, stride_var=s_v,
                f64=int(dt == torch.float64))
    host_dims = (ctypes.c_longlong * len(DIMS))(*(dims[k] for k in DIMS))
    masks = None if tabu_masks is None else tabu_masks.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().gj_move_sample(
        u.data_ptr(), population.data_ptr(), masks, members.data_ptr(),
        *(t.data_ptr() for t in tables.values()), out.data_ptr(),
        *(t.data_ptr() for t in info.values()), host_dims, len(DIMS), stream)
    if err != 0:
        raise RuntimeError(f"move kernel launch failed (cudaError {err})")
    move_and_fix.launches += 1
    return out, info


move_and_fix.launches = 0
