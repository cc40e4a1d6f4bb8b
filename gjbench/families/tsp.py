"""The travelling-salesman deployments: uniform points drawn from the seed,
their hand-over to the port through its public domain classes, and the
reference's view of the port's tour rows and sweep candidates.

A solution row of the port holds the location of tour position n at
`layout["stop"][n]` (read from the variable names the port publishes with
every solution). The reference works on int64 tours [B, N].
"""

import numpy as np
import torch

from gjbench.reference import tsp as ref_tsp

SCORE_NAMES = ("hard_score", "soft_score")


def make_instance(cfg, rng):
    """Uniform points in a square, as the port's
    `generate_uniform_instance` draws them; location 0 is the depot."""
    pts = rng.uniform(0.0, cfg["span"], size=(cfg["n_locations"], 2))
    return {"xs": pts[:, 0].copy(), "ys": pts[:, 1].copy(),
            "name": cfg["name"]}


def builders(inst, workload, device):
    """(domain builder, cotwin builder) of the port for this instance."""
    from greyjack_tpu_torch.models.tsp import (CotwinBuilder, DomainBuilder,
                                               Location, TravelSchedule)
    from greyjack_tpu_torch.ops.distance import euclidean_matrix

    def schedule():
        locations = [Location(i, inst["xs"][i], inst["ys"][i])
                     for i in range(len(inst["xs"]))]
        dm = euclidean_matrix(torch.as_tensor(inst["xs"]),
                              torch.as_tensor(inst["ys"]),
                              precision=3).to(device)
        return TravelSchedule(inst["name"], locations, dm)

    cot = workload["cotwin"]
    return (DomainBuilder.from_generator(schedule),
            CotwinBuilder(cot["incremental"], cot["greedy"]))


def layout(names):
    """Variable index of each tour position's location."""
    return {"stop": [i for i, s in enumerate(names)
                     if s.endswith("-->locations_vec_id")]}


class Family:
    """The reference side of one TSP instance on one device."""

    sweep_families = ("a", "c", "r", "i")
    key_parts = ("hard", "dist")
    bounded_parts = ()
    sweep_module = "greyjack_tpu_torch.models.tsp.sweep"
    # the delta ctx's distance total, in thousandths
    ctx_total = "soft_milli"

    def __init__(self, inst, device, lay, precision="float64"):
        self.inst = inst
        self.ref = ref_tsp.instance(inst, device, precision)
        self.lay = lay
        self.idx = torch.as_tensor(lay["stop"], device=device)
        self.n = len(lay["stop"])

    def rep(self, rows):
        return (rows.to(torch.int64)[:, self.idx],)

    def ints(self, rep):
        return ref_tsp.ints(self.ref, rep[0])

    def rows(self, rep, precision=None):
        return ref_tsp.rows(self.ref, rep[0], precision)

    def start(self):
        row = np.zeros(self.n, np.int64)
        row[self.lay["stop"]] = ref_tsp.greedy(self.inst)
        return row

    def route_width(self, ctx):
        """A tour has no route buffers."""
        return None

    def overfills(self, rep, width):
        """bool [B]: a tour has no route buffers to overfill."""
        return torch.zeros(rep[0].shape[0], dtype=torch.bool,
                           device=rep[0].device)

    # --- the sweep's candidates -------------------------------------------
    def sweep_candidates(self, rep, t, info):
        """All candidates of tour position t of one base tour ([1, N]), in
        the port's family order: change to every location 1..L-1, swap
        with every position, reverse the span to every position, move the
        city to sit after every position. Returns (candidates ([C, N],),
        reference validity [C])."""
        s = rep[0]
        n = self.n
        dev = s.device
        idx = torch.arange(n, device=dev)
        j = idx[:, None]
        a = s.expand(n, n).clone()
        a[:, t] = idx + 1
        a_valid = idx + 1 != s[0, t]
        src = idx.expand(n, n).clone()
        src[idx, t] = idx
        src[idx, idx] = t
        swap = s[0][src]
        lo, hi = torch.clamp(j, max=t), torch.clamp(j, min=t)
        inside = (idx >= lo) & (idx <= hi)
        rev = s[0][torch.where(inside, lo + hi - idx, idx)]
        fwd = (j > t) & (idx >= t) & (idx < j)
        back = (j < t) & (idx > j + 1) & (idx <= t)
        src = torch.where(fwd, idx + 1, torch.where(back, idx - 1, idx))
        src = torch.where((j > t) & (idx == j), t, src)
        src = torch.where((j < t) & (idx == j + 1), t, src)
        ins = s[0][src]
        span = torch.abs(idx - t) <= info["span_cap"] - 1
        free = (idx != t) & ~info["row_tabu"]
        c_valid = free & (s[0] != s[0, t])
        r_valid = free & span
        i_valid = free & span & (idx != t - 1)
        return ((torch.cat([a, swap, rev, ins]),),
                torch.cat([a_valid, c_valid, r_valid, i_valid]))

    def sweep_apply(self, rep, fam, t, j):
        """The tour candidate j of family `fam` (0 change, 1 swap, 2
        reversal, 3 insertion) of position t stands for, by the
        reference's own move semantics."""
        s = rep[0]
        tour = s[0].clone()
        if fam == 0:
            tour[t] = j + 1
        elif fam == 1:
            tour[t], tour[j] = s[0, j], s[0, t]
        elif fam == 2:
            lo, hi = min(t, j), max(t, j)
            tour[lo:hi + 1] = torch.flip(s[0, lo:hi + 1], [0])
        else:
            city = s[0, t]
            rest = torch.cat([s[0, :t], s[0, t + 1:]])
            at = j if j < t else j - 1
            tour = torch.cat([rest[:at + 1], city[None], rest[at + 1:]])
        return (tour[None],)

    # --- the delta ctx ---------------------------------------------------
    def ctx_bad(self, ctx, rep):
        s = rep[0][0]
        legs = ref_tsp.legs(self.ref, s[None])[0].cpu().numpy()
        s = s.cpu().numpy()
        want = {"s": s,
                "counts": np.bincount(s, minlength=len(self.inst["xs"])),
                "legs": legs, "hard": self.n - len(np.unique(s)),
                "soft_milli": legs.sum()}
        bad = 0
        for key, value in want.items():
            got = np.asarray(ctx[key]).astype(np.int64)
            value = np.asarray(value, np.int64)
            bad += (int(np.sum(got != value)) if got.shape == value.shape
                    else max(got.size, value.size, 1))
        return bad
