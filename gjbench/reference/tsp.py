"""Plain rescoring of the travelling salesman tour.

A solution gives each tour position n a location s[n] in 1..L-1; the tour
leaves location 0 (the depot), visits s[0], ..., s[N-1] and returns. The
score, lowest best:

  hard = positions - distinct locations
  soft = tour length, each leg the Euclidean distance truncated to 3
         decimals

and, under the upstream example's score precision [3, 3], each component
truncated to 3 decimals. Plain torch; nothing here imports the program
under test.
"""

import numpy as np
import torch

from gjbench.reference import common


def instance(inst, device, precision="float64"):
    """The instance's distances as a tensor on `device` (`inst` holds numpy
    arrays xs, ys, location 0 first): int64 thousandths, or float32 units
    under the lower-precision control."""
    if precision == "float64":
        dm = common.milli_matrix(inst["xs"], inst["ys"])
    else:
        dm = common.truncated_distances(inst["xs"], inst["ys"], np.float32)
    return {"dm": torch.as_tensor(dm, device=device), "precision": precision}


def legs(ref, tours):
    """[B, N + 1] leg lengths: leg i joins position i - 1 to position i,
    positions -1 and N being the depot."""
    zero = torch.zeros((tours.shape[0], 1), dtype=tours.dtype,
                       device=tours.device)
    path = torch.cat([zero, tours, zero], dim=1)
    return ref["dm"][path[:, :-1], path[:, 1:]]


def ints(ref, tours, batch=8192):
    """int64 [B, 2]: (duplicate positions, tour length in thousandths)."""
    out = []
    for i in range(0, tours.shape[0], batch):
        t = tours[i:i + batch]
        dist = legs(ref, t).sum(1)
        if dist.dtype != torch.int64:
            dist = torch.round(dist.double() * 1000.0).to(torch.int64)
        out.append(torch.stack([t.shape[1] - common.n_unique(t), dist],
                               dim=1))
    return torch.cat(out)


def rows(ref, tours, precision=None):
    """float64 [B, 2] score rows (hard, soft) on the host, each truncated
    to 3 decimals when `precision` is given (divided in numpy, as
    `vrp.rows` says why)."""
    dist = legs(ref, tours).sum(1).cpu().numpy().astype(np.float64)
    soft = dist / 1000.0 if ref["precision"] == "float64" else dist
    hard = (tours.shape[1] - common.n_unique(tours)).cpu().numpy()
    row = np.stack([hard.astype(np.float64), soft], axis=1)
    if precision is not None:
        row = common.round3(row)
    return torch.as_tensor(row)


def greedy(inst):
    """The upstream greedy start (`cotwin_builder.rs:139-168`): from the
    depot, always the nearest unvisited location (untruncated distance).
    Returns int64 [L - 1]."""
    xs, ys = np.asarray(inst["xs"]), np.asarray(inst["ys"])
    d = np.sqrt((xs[:, None] - xs[None, :]) ** 2
                + (ys[:, None] - ys[None, :]) ** 2)
    seen = np.zeros(len(xs), bool)
    seen[0] = True
    tour, prev = [], 0
    for _ in range(len(xs) - 1):
        nxt = int(np.argmin(np.where(seen, np.inf, d[prev])))
        seen[nxt] = True
        tour.append(nxt)
        prev = nxt
    return np.asarray(tour, np.int64)
