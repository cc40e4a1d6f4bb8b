"""Plain rescoring of the multi-depot, time-windowed vehicle routing problem.

A solution gives each stop n a vehicle veh[n] and a location cust[n]; a
vehicle visits its stops in stop-index order, leaving from and returning to
its depot. The score, lowest best:

  hard   = 1000 * (stops - distinct locations) + sum over vehicles of
           max(0, load - capacity)
  medium = sum over stops of max(0, departure - window end), plus, for each
           vehicle with stops, max(0, last departure - end of its work day);
           departure = max(previous departure, window start) + service time,
           the first previous departure being the start of the work day
  soft   = total route distance, each leg the Euclidean distance truncated
           to 3 decimals

Plain torch over a batch of solutions, stop by stop. Nothing here imports
the program under test.
"""

import numpy as np
import torch

from gjbench.reference import common


def instance(inst, device, precision="float64"):
    """The instance's tables as tensors on `device`. `inst` holds numpy
    arrays xs, ys, demand, tw_start, tw_end, service (one row a location,
    depots first) and the ints n_depots, k_vehicles, capacity. With
    precision "float32" the distances are computed and summed in float32:
    the lower-precision control."""
    nd, k = inst["n_depots"], inst["k_vehicles"]
    depot = np.arange(k) % nd

    def t(x):
        return torch.as_tensor(np.asarray(x), device=device)

    if precision == "float64":
        dm = t(common.milli_matrix(inst["xs"], inst["ys"]))
    else:
        dm = t(common.truncated_distances(inst["xs"], inst["ys"],
                                          np.float32))
    return {
        "dm": dm, "precision": precision,
        "demand": t(inst["demand"].astype(np.int64)),
        "tw_start": t(inst["tw_start"].astype(np.int64)),
        "tw_end": t(inst["tw_end"].astype(np.int64)),
        "service": t(inst["service"].astype(np.int64)),
        "depot": t(depot.astype(np.int64)),
        "work_start": t(inst["tw_start"][depot].astype(np.int64)),
        "work_end": t(inst["tw_end"][depot].astype(np.int64)),
        "capacity": int(inst["capacity"]), "k": k, "n_depots": nd,
    }


def parts(ref, veh, cust):
    """Score parts of solutions veh, cust int64 [B, N]: dict of [B]
    tensors dups, overflow, late (int64) and dist (int64 thousandths, or
    float32 units under the float32 control)."""
    b, n = veh.shape
    dev = veh.device
    order = torch.argsort(veh * n + torch.arange(n, device=dev), dim=1)
    sv = torch.gather(veh, 1, order)
    sc = torch.gather(cust, 1, order)
    first = torch.ones_like(sv, dtype=torch.bool)
    first[:, 1:] = sv[:, 1:] != sv[:, :-1]
    last = torch.ones_like(sv, dtype=torch.bool)
    last[:, :-1] = sv[:, :-1] != sv[:, 1:]
    dm = ref["dm"]
    depot = ref["depot"][sv]
    zero = torch.zeros((), dtype=dm.dtype, device=dev)
    chain = torch.where(first[:, 1:], zero, dm[sc[:, :-1], sc[:, 1:]])
    out_leg = torch.where(first, dm[depot, sc], zero)
    in_leg = torch.where(last, dm[sc, depot], zero)
    dist = chain.sum(1) + out_leg.sum(1) + in_leg.sum(1)

    load = torch.zeros((b, ref["k"]), dtype=torch.int64, device=dev)
    load.scatter_add_(1, veh, ref["demand"][cust])
    overflow = torch.clamp(load - ref["capacity"], min=0).sum(1)
    dups = n - common.n_unique(cust)

    start, end = ref["tw_start"][sc], ref["tw_end"][sc]
    service = ref["service"][sc]
    w0, w1 = ref["work_start"][sv], ref["work_end"][sv]
    post = torch.zeros(b, dtype=torch.int64, device=dev)
    late = torch.zeros(b, dtype=torch.int64, device=dev)
    for j in range(n):
        prev = torch.where(first[:, j], w0[:, j], post)
        post = torch.maximum(prev, start[:, j]) + service[:, j]
        late += torch.clamp(post - end[:, j], min=0)
        late += torch.where(last[:, j], torch.clamp(post - w1[:, j], min=0),
                            0)
    return {"dups": dups, "overflow": overflow, "late": late, "dist": dist}


def ints(ref, veh, cust, batch=4096):
    """int64 [B, 3]: (1000 * dups + overflow, late, distance in
    thousandths), in batches of `batch` solutions."""
    out = []
    for i in range(0, veh.shape[0], batch):
        p = parts(ref, veh[i:i + batch], cust[i:i + batch])
        dist = p["dist"]
        if dist.dtype != torch.int64:
            dist = torch.round(dist.double() * 1000.0).to(torch.int64)
        out.append(torch.stack([1000 * p["dups"] + p["overflow"], p["late"],
                                dist], dim=1))
    return torch.cat(out)


def rows(ref, veh, cust):
    """float64 [B, 3] score rows (hard, medium, soft), on the host. The
    thousandths are divided in numpy: a CUDA device divides a tensor by a
    Python number as a product with its reciprocal, which can miss the
    correctly rounded quotient in the last bit."""
    p = {k: v.cpu().numpy() for k, v in parts(ref, veh, cust).items()}
    dist = p["dist"].astype(np.float64)
    soft = dist / 1000.0 if ref["precision"] == "float64" else dist
    hard = 1000.0 * p["dups"].astype(np.float64) + p["overflow"]
    return torch.as_tensor(np.stack([hard, p["late"].astype(np.float64),
                                     soft], axis=1))


def routes(ref, veh, cust):
    """Per-vehicle view of one solution, numpy: stops [K] lists of stop
    indices in visiting order, and int64 [K] dist (thousandths), late
    (lateness + overtime), load."""
    veh = np.asarray(veh, np.int64)
    cust = np.asarray(cust, np.int64)
    dm = ref["dm"].cpu().numpy()
    start, end = ref["tw_start"].cpu().numpy(), ref["tw_end"].cpu().numpy()
    service, demand = (ref["service"].cpu().numpy(),
                       ref["demand"].cpu().numpy())
    depot = ref["depot"].cpu().numpy()
    w0, w1 = ref["work_start"].cpu().numpy(), ref["work_end"].cpu().numpy()
    k = ref["k"]
    stops = [[int(n) for n in np.nonzero(veh == v)[0]] for v in range(k)]
    dist = np.zeros(k, np.int64)
    late = np.zeros(k, np.int64)
    load = np.zeros(k, np.int64)
    for v, route in enumerate(stops):
        if not route:
            continue
        locs = [depot[v]] + [cust[n] for n in route] + [depot[v]]
        dist[v] = sum(dm[a, b] for a, b in zip(locs[:-1], locs[1:]))
        post = w0[v]
        for n in route:
            c = cust[n]
            post = max(post, start[c]) + service[c]
            late[v] += max(0, post - end[c])
            load[v] += demand[c]
        late[v] += max(0, post - w1[v])
    return {"stops": stops, "dist": dist, "late": late, "load": load}


def greedy(inst):
    """The upstream greedy start (`cotwin_builder.rs:153-255`): vehicle by
    vehicle from its depot, the nearest remaining customer (by the
    untruncated distance) while it fits the capacity, else the next
    vehicle. Returns (veh, cust) int64 [N], or None when some customer is
    left over."""
    xs, ys = np.asarray(inst["xs"]), np.asarray(inst["ys"])
    d = np.sqrt((xs[:, None] - xs[None, :]) ** 2
                + (ys[:, None] - ys[None, :]) ** 2)
    fl = np.floor(d)
    d = fl + np.floor((d - fl) * 1000.0) / 1000.0
    nd, k, cap = inst["n_depots"], inst["k_vehicles"], inst["capacity"]
    demand = np.asarray(inst["demand"])
    left = np.ones(len(xs), bool)
    left[:nd] = False
    veh, cust = [], []
    v, prev, load = 0, 0, 0
    while v < k and left.any():
        c = int(np.argmin(np.where(left, d[prev], np.inf)))
        if load + demand[c] <= cap:
            left[c] = False
            veh.append(v)
            cust.append(c)
            prev, load = c, load + int(demand[c])
        else:
            v += 1
            prev, load = min(v, k - 1) % nd, 0
    if left.any():
        return None
    return np.asarray(veh, np.int64), np.asarray(cust, np.int64)
