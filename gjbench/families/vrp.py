"""The vehicle-routing deployments: the instance drawn from the seed, its
hand-over to the port through the port's public domain classes, and the
reference's view of the port's solution rows and sweep candidates.

A solution row of the port holds, for stop n, its vehicle at
`layout["veh"][n]` and its location at `layout["cust"][n]` (read from the
variable names the port publishes with every solution). The reference works
on (veh, cust) pairs of int64 [B, N] tensors.
"""

import math

import numpy as np
import torch

from gjbench.reference import common
from gjbench.reference import vrp as ref_vrp

SCORE_NAMES = ("hard_score", "medium_score", "soft_score")


def make_instance(cfg, rng):
    """Coordinates, demands and windows, draw for draw as the port's
    `generate_instance` makes them (so the instance class matches the
    upstream synthetic one): uniform points, integer demands, and for each
    customer a window start, a window length and a service time."""
    if not cfg["time_windowed"]:
        raise ValueError("the VRP family draws time-windowed instances only")
    nd, n, k = cfg["n_depots"], cfg["n_customers"], cfg["k_vehicles"]
    total = nd + n
    pts = rng.uniform(0.0, cfg["span"], size=(total, 2))
    demand = rng.integers(cfg["demand_min"], cfg["demand_max"] + 1,
                          size=total)
    demand[:nd] = 0
    tw = np.zeros((total, 3), np.int64)
    tw[:nd, 1] = cfg["day_end"]
    for i in range(nd, total):
        start = int(rng.integers(0, cfg["window_start_max"]))
        tw[i] = (start, start + int(rng.integers(cfg["window_len_min"],
                                                 cfg["window_len_max"])),
                 int(rng.integers(cfg["service_min"], cfg["service_max"])))
    capacity = max(1, math.ceil(cfg["capacity_slack"] * demand.sum() / k))
    return {"xs": pts[:, 0].copy(), "ys": pts[:, 1].copy(),
            "demand": demand.astype(np.int64), "tw_start": tw[:, 0],
            "tw_end": tw[:, 1], "service": tw[:, 2], "n_depots": nd,
            "k_vehicles": k, "capacity": int(capacity),
            "name": cfg["name"]}


def builders(inst, workload, device):
    """(domain builder, cotwin builder) of the port for this instance."""
    from greyjack_tpu_torch.models.vrp import (CotwinBuilder, Customer,
                                               DomainBuilder, Vehicle,
                                               VehicleRoutingPlan)
    from greyjack_tpu_torch.ops.distance import euclidean_matrix

    def plan():
        nd, k = inst["n_depots"], inst["k_vehicles"]
        customers = [
            Customer(i + 1, i, inst["xs"][i], inst["ys"][i], None,
                     int(inst["demand"][i]), int(inst["tw_start"][i]),
                     int(inst["tw_end"][i]), int(inst["service"][i]))
            for i in range(len(inst["xs"]))]
        vehicles = [Vehicle(customers[i % nd], [], i % nd,
                            customers[i % nd].time_window_start,
                            customers[i % nd].time_window_end,
                            inst["capacity"], len(customers) - nd)
                    for i in range(k)]
        dm = euclidean_matrix(torch.as_tensor(inst["xs"]),
                              torch.as_tensor(inst["ys"]),
                              precision=3).to(device)
        return VehicleRoutingPlan(inst["name"], vehicles, customers, dm,
                                  customers[:nd], True)

    cot = workload["cotwin"]
    return (DomainBuilder.from_generator(plan),
            CotwinBuilder(cot["incremental"], cot["greedy"]))


def layout(names):
    """Variable indices of each stop's vehicle and location."""
    return {"veh": [i for i, s in enumerate(names)
                    if s.endswith("-->vehicle_id")],
            "cust": [i for i, s in enumerate(names)
                     if s.endswith("-->customer_id")]}


class Family:
    """The reference side of one VRP instance on one device."""

    # the sweep's candidate families in the port's order, the parts of a
    # candidate's key, and the module whose functions the check observes
    sweep_families = ("a", "b", "c")
    key_parts = ("hard", "late", "dist")
    # key parts a non-converged candidate only bounds from below
    bounded_parts = ("late",)
    sweep_module = "greyjack_tpu_torch.models.vrp.sweep"
    # the delta ctx's distance total, in thousandths
    ctx_total = "sum_dist"

    def __init__(self, inst, device, lay, precision="float64"):
        self.inst = inst
        self.ref = ref_vrp.instance(inst, device, precision)
        self.lay = lay
        self.veh_idx = torch.as_tensor(lay["veh"], device=device)
        self.cust_idx = torch.as_tensor(lay["cust"], device=device)
        self.n = len(lay["veh"])

    def rep(self, rows):
        rows = rows.to(torch.int64)
        return rows[:, self.veh_idx], rows[:, self.cust_idx]

    def ints(self, rep):
        return ref_vrp.ints(self.ref, *rep)

    def rows(self, rep, precision=None):
        row = ref_vrp.rows(self.ref, *rep)
        if precision is not None:
            row = torch.as_tensor(common.round3(row.numpy()))
        return row

    def start(self):
        """Solution row of the greedy start, or None."""
        got = ref_vrp.greedy(self.inst)
        if got is None:
            return None
        row = np.zeros(2 * self.n, np.int64)
        row[self.lay["veh"]] = got[0]
        row[self.lay["cust"]] = got[1]
        return row

    def route_width(self, ctx):
        """The port's route buffer width, read from its delta ctx (None:
        no ctx, no limit)."""
        return ctx["r_stop"].shape[-1] if ctx and "r_stop" in ctx else None

    def overfills(self, rep, width):
        """bool [B]: a vehicle holds more than `width` stops (the port's
        route buffers; None: no limit)."""
        veh = rep[0]
        if width is None:
            return torch.zeros(veh.shape[0], dtype=torch.bool,
                               device=veh.device)
        counts = torch.zeros((veh.shape[0], self.ref["k"]), dtype=torch.int64,
                             device=veh.device)
        counts.scatter_add_(1, veh, torch.ones_like(veh))
        return counts.max(dim=1).values > width

    # --- the sweep's candidates -------------------------------------------
    def sweep_candidates(self, rep, t, info):
        """All candidates of target stop t of one base solution rep
        ((veh, cust) [1, N]), in the port's family order: change to every
        customer location, move to every vehicle, swap with every stop.
        Returns (candidates (veh, cust) [C, N], reference validity [C])."""
        veh, cust = rep
        nd, k, n = self.ref["n_depots"], self.ref["k"], self.n
        dev = veh.device
        lc = len(self.inst["xs"]) - nd
        locs = torch.arange(nd, nd + lc, device=dev)
        a_veh = veh.expand(lc, n).clone()
        a_cust = cust.expand(lc, n).clone()
        a_cust[:, t] = locs
        a_valid = locs != cust[0, t]
        b_veh = veh.expand(k, n).clone()
        b_veh[:, t] = torch.arange(k, device=dev)
        b_cust = cust.expand(k, n).clone()
        lengths = torch.bincount(veh[0], minlength=k)
        b_valid = ((torch.arange(k, device=dev) != veh[0, t])
                   & (lengths < info["route_width"]))
        c_veh = veh.expand(n, n).clone()
        c_cust = cust.expand(n, n).clone()
        j = torch.arange(n, device=dev)
        c_cust[j, t] = cust[0]
        c_cust[j, j] = cust[0, t]
        c_valid = ((veh[0] != veh[0, t]) & (cust[0] != cust[0, t])
                   & ~info["row_tabu"])
        cands = (torch.cat([a_veh, b_veh, c_veh]),
                 torch.cat([a_cust, b_cust, c_cust]))
        return cands, torch.cat([a_valid, b_valid, c_valid])

    def sweep_apply(self, rep, fam, t, j):
        """The solution candidate j of family `fam` (0 change, 1 vehicle,
        2 swap) of target stop t stands for, by the reference's own move
        semantics."""
        veh, cust = (x.clone() for x in rep)
        if fam == 0:
            cust[0, t] = self.ref["n_depots"] + j
        elif fam == 1:
            veh[0, t] = j
        else:
            cust[0, t], cust[0, j] = rep[1][0, j], rep[1][0, t]
        return veh, cust

    # --- the delta ctx ---------------------------------------------------
    def ctx_bad(self, ctx, rep):
        """Entries of one island's ctx (numpy leaves without the island
        axis) that disagree with the reference's view of the solution it
        describes."""
        veh, cust = (x[0].cpu().numpy() for x in rep)
        n, k = self.n, self.ref["k"]
        r = ctx["r_stop"].shape[-1]
        view = ref_vrp.routes(self.ref, veh, cust)
        r_stop = np.full((k, r), n, np.int64)
        r_c = np.zeros((k, r), np.int64)
        pos = np.zeros(n, np.int64)
        for v, route in enumerate(view["stops"]):
            for slot, stop in enumerate(route[:r]):
                r_stop[v, slot] = stop
                r_c[v, slot] = cust[stop]
                pos[stop] = slot
        counts = np.bincount(cust, minlength=len(self.inst["xs"]))
        dm = self.ref["dm"].cpu().numpy()
        legs = np.zeros((k, r), np.int64)
        for v, route in enumerate(view["stops"]):
            for slot in range(min(len(route), r) - 1):
                legs[v, slot] = dm[cust[route[slot]], cust[route[slot + 1]]]
        lengths = np.array([len(s) for s in view["stops"]])
        overflow = np.maximum(view["load"] - self.ref["capacity"], 0).sum()
        want = {
            "v": veh, "c": cust, "counts": counts,
            "dups": n - len(np.unique(cust)), "r_stop": r_stop, "r_c": r_c,
            "pos": pos, "len": lengths, "dist": view["dist"],
            "late": view["late"], "load": view["load"],
            "r_leg": legs, "sum_dist": view["dist"].sum(),
            "sum_late": view["late"].sum(), "sum_overflow": overflow,
        }
        bad = 0
        for key, value in want.items():
            got = np.asarray(ctx[key]).astype(np.int64)
            value = np.asarray(value, np.int64)
            if key == "r_leg":
                got = got[..., :r]
            bad += (int(np.sum(got != value)) if got.shape == value.shape
                    else max(got.size, value.size, 1))
        return bad
