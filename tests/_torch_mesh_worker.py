"""One rank of a gloo world on the CPU for the port's mesh tests
(`tests/test_torch_mesh.py`, `tests/test_torch_partitioned.py`), and the
cases both sides run: the parent runs each case without a mesh in its own
process and compares.

    python tests/_torch_mesh_worker.py --init file:///tmp/x/store \
        --world 2 --rank 0 --suite mesh --out /tmp/x/out

Rank r writes `<out>.rank<r>.pkl`: a dict of numpy trees. Imports only the
port.
"""

from __future__ import annotations

import argparse
import datetime
import os
import pickle
import shutil
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from greyjack_tpu_torch.agents import (GeneticAlgorithm,  # noqa: E402
                                       LateAcceptance, TabuSearch)
from greyjack_tpu_torch.agents.termination_strategies import (  # noqa: E402
    StepsLimit)
from greyjack_tpu_torch.models import nqueens, tsp, vrp  # noqa: E402
from greyjack_tpu_torch.parallel import IslandRunner  # noqa: E402
from greyjack_tpu_torch.score_calculation.score_requesters import (  # noqa
    ScoreRequester)
from greyjack_tpu_torch.solver import (Solver,  # noqa: E402
                                       SolverLoggingLevels, SolverMetrics)
from greyjack_tpu_torch.solver.solver import island_generators  # noqa: E402

DEV = "cpu"
RUNNER_ISLANDS, RUNNER_CHUNKS, RUNNER_STEPS = 4, 3, 2
SOLVE_ISLANDS = 4
CKPT_CHUNK = 2


def to_np(tree):
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_np(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


# --- the cases --------------------------------------------------------------

def nq_agent(name, steps=4):
    """The JAX package's N-Queens 10 configurations
    (`tests/test_islands_multidevice.py:19-25`), LateAcceptance beside."""
    probas = [0.0, 1.0, 0.0, 0.0, 0.0, 0.0]
    if name == "TS":
        return TabuSearch(8, 0.2, True, None, probas, 2, StepsLimit(steps))
    if name == "LA":
        return LateAcceptance(5, 0.2, None, probas, 2, StepsLimit(steps))
    return GeneticAlgorithm(8, 0.5, 0.2, 0.0, 1.0, None, 0.25, 2,
                            StepsLimit(steps))


def nq_builders():
    return (nqueens.DomainBuilder(10, 45, device=DEV),
            nqueens.CotwinBuilder(True))


def nq_kernel(name):
    db, cb = nq_builders()
    req = ScoreRequester(cb.build_cotwin(db.build_domain_from_scratch(),
                                         False))
    return nq_agent(name).build_kernel(req, None)


def run_runner(name, mesh=None):
    """The runner's whole state, generator states and global best after
    each of RUNNER_CHUNKS chunks of N-Queens 10, 4 islands, seed 7."""
    runner = IslandRunner(nq_kernel(name), RUNNER_ISLANDS, RUNNER_STEPS,
                          mesh=mesh)
    gens = island_generators(7, RUNNER_ISLANDS, DEV)[runner.local_islands]
    state = runner.init(gens)
    alive = torch.ones(RUNNER_ISLANDS, dtype=torch.bool)
    out = []
    for _ in range(RUNNER_CHUNKS):
        state = runner.run_chunk(state, gens, alive, {}, RUNNER_STEPS)
        whole, gen_states = runner.gather_state(state, gens)
        out.append({"state": to_np(whole),
                    "generators": [g.numpy() for g in gen_states]})
    return out


def vrp_builder():
    return vrp.DomainBuilder.from_generator(
        lambda: vrp.generate_instance(24, 2, 5, seed=4, time_windowed=True,
                                      device=DEV))


SOLVES = {
    # label: (builders, agent, n_jobs)
    "nq-TS": (nq_builders, lambda: nq_agent("TS", 9)),
    "nq-LA": (nq_builders, lambda: nq_agent("LA", 9)),
    "nq-GA": (nq_builders, lambda: nq_agent("GA", 9)),
    "vrp-int-delta": (lambda: (vrp_builder(), vrp.CotwinBuilder(True, True)),
                      lambda: TabuSearch(32, 0.2, True, None,
                                         [0.5, 0.5, 0, 0, 0, 0], 3,
                                         StepsLimit(8))),
    "vrp-sweep": (lambda: (vrp_builder(), vrp.CotwinBuilder(True, True)),
                  lambda: TabuSearch(8, 0.2, True, None,
                                     [0.5, 0.5, 0, 0, 0, 0], 3, StepsLimit(8),
                                     sweep=True, sweep_targets=4,
                                     sweep_window=4)),
}


def run_solve(label, mesh=None, seed=3, **kw):
    """(solution, metrics records without wall times) of one solve."""
    builders, agent = SOLVES[label]
    db, cb = builders()
    metrics = SolverMetrics()
    sol = Solver.solve(db, cb, agent(), SOLVE_ISLANDS, seed=seed, mesh=mesh,
                       logging_level=SolverLoggingLevels.Silent,
                       metrics=metrics, **kw)
    recs = [{k: v for k, v in r.items()
             if k not in ("wall_ms", "moves_per_s")} for r in metrics.records]
    return sol, recs


class CopyAt:
    """An observer that copies the checkpoint file as chunk `chunk`'s
    metrics land: the copy holds the checkpoint of chunks 0..chunk-1."""

    def __init__(self, src, dst, chunk):
        self.src, self.dst, self.chunk = src, dst, chunk

    def update(self, solution):
        pass

    def update_metrics(self, record):
        if record["chunk"] == self.chunk:
            shutil.copyfile(self.src, self.dst)


def run_checkpointed(label, ckpt, snapshot, mesh=None):
    return run_solve(label, mesh=mesh, checkpoint_path=ckpt,
                     checkpoint_frequency=1,
                     observers=[CopyAt(ckpt, snapshot, CKPT_CHUNK)])


# --- partitioned facts ------------------------------------------------------

def vrp_requester():
    domain = vrp.generate_instance(30, 2, 6, seed=4, time_windowed=True,
                                   device=DEV)
    return ScoreRequester(vrp.CotwinBuilder(True, True).build_cotwin(domain,
                                                                     False))


def tsp_requester():
    domain = tsp.generate_uniform_instance(25, seed=6, device=DEV)
    return ScoreRequester(tsp.CotwinBuilder(True, True).build_cotwin(domain,
                                                                     False))


def gather_case(seed=0, n=37, p=64):
    """A matrix whose side does not divide by the shard counts, and two
    islands' requests."""
    rng = np.random.RandomState(seed)
    dm = rng.randint(0, 1 << 20, size=(n, n)).astype(np.int32)
    u = rng.randint(0, n, size=(2, p)).astype(np.int32)
    v = rng.randint(0, n, size=(2, p)).astype(np.int32)
    return dm, u, v


def populations(req, n_islands, p, seed):
    gens = island_generators(seed, n_islands, DEV)
    return torch.stack([req.variables_manager.sample_variables(g, p)
                        for g in gens])


# --- the launcher -------------------------------------------------------------

def launch(suite, world, out_dir, timeout=300):
    """Run `suite` on a gloo world of `world` ranks, one process each, with
    a `file://` store in `out_dir`; kills every rank if one fails or the
    world outlives `timeout` seconds. Returns each rank's result dict."""
    import subprocess
    import time

    out_dir = str(out_dir)
    init = "file://" + os.path.join(out_dir, f"store_{suite}_{world}")
    out = os.path.join(out_dir, f"{suite}_{world}")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--init", init,
         "--world", str(world), "--rank", str(r), "--suite", suite,
         "--out", out], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = [None] * world
    try:
        for r, proc in enumerate(procs):
            logs[r], _ = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for r, proc in enumerate(procs):
        if proc.returncode != 0:
            raise RuntimeError(f"rank {r} of the {suite} world exited "
                               f"{proc.returncode}:\n{logs[r]}")
    results = []
    for r in range(world):
        with open(f"{out}.rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


# --- the suites --------------------------------------------------------------

def suite_mesh(mesh, out_dir):
    res = {}
    if mesh.size > 1:
        for name in ("TS", "LA", "GA"):
            res[f"runner-{name}"] = run_runner(name, mesh)
    for label in SOLVES:
        res[f"solve-{label}"] = run_solve(label, mesh)
    if mesh.size > 1:
        ckpt = os.path.join(out_dir, "mesh.ckpt")
        snap = os.path.join(out_dir, "mesh_snapshot.ckpt")
        res["ckpt-full"] = run_checkpointed("vrp-int-delta", ckpt, snap, mesh)
        torch.distributed.barrier()
        res["ckpt-resumed-mesh"] = run_solve("vrp-int-delta", mesh,
                                             resume_from=snap)
        res["solve-seedless"] = run_solve("nq-TS", mesh, seed=None)
    return res


def suite_partitioned():
    from greyjack_tpu_torch.ops import partitioned
    from greyjack_tpu_torch.parallel.mesh import make_island_mesh

    res = {}
    for facts in (1, 2):
        mesh = make_island_mesh(facts=facts)
        dm, u, v = gather_case()
        dm_pad, r = partitioned.shard_rows(torch.as_tensor(dm), facts)
        shard = dm_pad[mesh.facts_index * r:(mesh.facts_index + 1) * r]
        row = mesh.index          # this rank's island row of requests
        got = partitioned.sharded_dm_gather(
            shard, torch.as_tensor(u[row]), torch.as_tensor(v[row]),
            mesh.facts_group)
        flat, rf = partitioned.shard_rows_flat(torch.as_tensor(dm), facts)
        block = flat[mesh.facts_index * rf * dm.shape[1]:
                     (mesh.facts_index + 1) * rf * dm.shape[1]]
        idx = torch.as_tensor(u[row]).long() * dm.shape[1] + torch.as_tensor(
            v[row]).long()
        got_flat = partitioned.sharded_dm_gather_flat(block, idx,
                                                      dm.shape[1],
                                                      mesh.facts_group)
        res[f"gather-F{facts}"] = {"row": row, "shard_rows": shard.shape[0],
                                   "dense": to_np(got),
                                   "flat": to_np(got_flat)}
        for label, make_req, p in (("vrp", vrp_requester, 8),
                                   ("tsp", tsp_requester, 4)):
            req = make_req()
            fn = req.partitioned_plain_score_fn(mesh.facts_group)
            utils = req.cotwin.score_calculator.utility_objects
            dm_flat, rr = partitioned.shard_rows_flat(
                utils["distance_matrix_milli"], facts)
            span = rr * utils["distance_matrix_milli"].shape[1]
            my_block = dm_flat[mesh.facts_index * span:
                               (mesh.facts_index + 1) * span]
            pop = populations(req, mesh.size, p, seed=9)[mesh.index]
            res[f"{label}-F{facts}"] = {"row": mesh.index,
                                        "population": to_np(pop),
                                        "scores": to_np(fn(my_block, pop))}
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--init", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--suite", choices=("mesh", "partitioned"),
                    required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=args.init, world_size=args.world,
        rank=args.rank, timeout=datetime.timedelta(seconds=120))
    try:
        out_dir = os.path.dirname(args.out)
        if args.suite == "mesh":
            from greyjack_tpu_torch.parallel.mesh import make_island_mesh
            res = suite_mesh(make_island_mesh(), out_dir)
        else:
            res = suite_partitioned()
        res["jax_imported"] = "jax" in sys.modules
        with open(f"{args.out}.rank{args.rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
