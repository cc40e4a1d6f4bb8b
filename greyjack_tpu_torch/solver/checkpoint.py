"""Device-state checkpoint / resume (counterpart of
`greyjack_tpu/solver/checkpoint.py`).

A checkpoint holds everything a solve needs to continue exactly where it
stopped: the island state tree of all islands (as numpy), every island
generator's `get_state()`, the termination strategies (time-based ones rebased, so time
spent down does not count against their limits), the alive mask, the chunk
counter and the best solution recorded so far. With a fixed `seed` and
step-based termination, a solve resumed from a checkpoint gives the same
final state and solution as the uninterrupted solve, bit for bit, on the
same kind of device: the generators' states are device-specific.

Format: one pickle written atomically (a temporary file, then a rename) of
numpy arrays and host objects only; `load_checkpoint` returns them on the
host and `Solver.solve(resume_from=...)` moves them onto the solve's
device.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

FORMAT_VERSION = 1


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _rebase_strategy_times(strategies, to_relative):
    """Turn time-based strategies' absolute `start_time` (ms since the
    epoch) into an offset from now (save) or back (load)."""
    now = time.time() * 1000.0
    for s in strategies:
        st = getattr(s, "start_time", None)
        if st is not None:
            s.start_time = (st - now) if to_relative else (st + now)
    return strategies


def save_checkpoint(path, *, state, generator_states, strategies, alive,
                    chunk_id, best=None, meta=None):
    """Atomically write the solve state. `state` is the runner state of all
    islands (tensors on any device), `generator_states` every island's
    generator `get_state()` after the chunk (uint8 tensors), `best` the
    solve's best record so far (score row and solution JSON)."""
    payload = {
        "format_version": FORMAT_VERSION,
        "state": _to_numpy(state),
        "generators": [g.numpy().copy() for g in generator_states],
        "strategies": _rebase_strategy_times(
            [s.clone() for s in strategies], to_relative=True),
        "alive": np.asarray(alive, dtype=bool),
        "chunk_id": int(chunk_id),
        "best": best,
        "meta": meta or {},
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_checkpoint(path):
    """A checkpoint written by `save_checkpoint`: a dict of state (numpy
    tree), generators (uint8 state arrays), strategies, alive, chunk_id,
    best and meta, all on the host."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if payload.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint {path}: unsupported format "
            f"{payload.get('format_version')!r} (expected {FORMAT_VERSION})")
    payload.pop("format_version")
    payload["strategies"] = _rebase_strategy_times(payload["strategies"],
                                                   to_relative=False)
    return payload
