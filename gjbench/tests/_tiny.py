"""A small copy of the benchmark's cells, for runs on the CPU: the same
families, agents and paths at sizes a test holds."""

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CONFIGS = {
    "vrp-tiny": {"family": "vrp", "n_customers": 30, "n_depots": 2,
                 "k_vehicles": 4, "time_windowed": True, "span": 100.0,
                 "demand_min": 1, "demand_max": 30, "capacity_slack": 1.3,
                 "day_end": 864000, "window_start_max": 432000,
                 "window_len_min": 86400, "window_len_max": 432000,
                 "service_min": 60, "service_max": 1800},
    "tsp-tiny": {"family": "tsp", "n_locations": 30, "span": 100.0},
    # the control's float32 sums part from the exact ones only over tours
    # of some hundreds of legs
    "tsp-1k": {"family": "tsp", "n_locations": 1000, "span": 100.0},
}

VRP_MOVES = [0.5, 0.5, 0.0, 0.0, 0.0, 0.0]
CELLS = {
    "vrp-tiny.ts-sweep": ("vrp-tiny", {
        "agent_args": {"neighbours_count": 64, "tabu_entity_rate": 0.2,
                       "compare_to_global": True,
                       "mutation_rate_multiplier": None,
                       "move_probas": VRP_MOVES, "sweep": True,
                       "sweep_targets": 8, "sweep_window": 4},
        "cotwin": {"incremental": True, "greedy": True},
        "path": "sweep", "moves": "vrp_sweep",
        "check": {"sample": 2, "accept": "tabu"}}),
    "tsp-tiny.ts-sweep": ("tsp-tiny", {
        "agent_args": {"neighbours_count": 64, "tabu_entity_rate": 0.5,
                       "compare_to_global": True,
                       "mutation_rate_multiplier": None,
                       "move_probas": [0.0, 0.2, 0.2, 0.2, 0.2, 0.2],
                       "sweep": True, "sweep_targets": 8},
        "score_precision": [3, 3],
        "cotwin": {"incremental": True, "greedy": True},
        "path": "sweep", "moves": "tsp_sweep",
        "check": {"sample": 2, "accept": "tabu"}}),
    "vrp-tiny.ts-intdelta": ("vrp-tiny", {
        "agent_args": {"neighbours_count": 64, "tabu_entity_rate": 0.2,
                       "compare_to_global": True,
                       "mutation_rate_multiplier": None,
                       "move_probas": VRP_MOVES},
        "cotwin": {"incremental": True, "greedy": True},
        "path": "int-delta", "moves": "neighbours",
        "check": {"sample": 16, "accept": "tabu"}}),
    "vrp-tiny.ts-plain": ("vrp-tiny", {
        "agent_args": {"neighbours_count": 32, "tabu_entity_rate": 0.2,
                       "compare_to_global": True,
                       "mutation_rate_multiplier": None, "move_probas": None},
        "cotwin": {"incremental": False, "greedy": True},
        "path": "plain", "moves": "neighbours",
        "check": {"sample": 8, "accept": "tabu"}}),
}
# cells of the control test only
CONTROL_CELLS = {
    "tsp-1k.ts-sweep": ("tsp-1k", dict(
        CELLS["tsp-tiny.ts-sweep"][1], check={"sample": 1,
                                              "accept": "tabu"})),
}


def make_root(path):
    """Write a BENCHMARK.json, configuration and workload files of the tiny
    cells under `path`, with the real benchmark's metrics; returns path."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        real = json.load(f)
    os.makedirs(os.path.join(path, "gjbench", "workloads"), exist_ok=True)
    os.makedirs(os.path.join(path, "gjbench", "configs"), exist_ok=True)
    configs = []
    for name, cfg in CONFIGS.items():
        file = f"gjbench/configs/{name}.json"
        with open(os.path.join(path, file), "w") as f:
            json.dump({"name": name, **cfg}, f)
        configs.append({"name": name, "source": "test", "file": file,
                        "reduced": [], "why": "test"})
    cells = []
    for cell, (config, wl) in {**CELLS, **CONTROL_CELLS}.items():
        traffic = cell.split(".", 1)[1]
        wl = {"config": config, "traffic": traffic, "agent": "TabuSearch",
              "islands": 2, "chunk_steps": 3, "score_precision": None, **wl}
        with open(os.path.join(path, "gjbench", "workloads", cell + ".json"),
                  "w") as f:
            json.dump(wl, f)
        cells.append({"name": cell, "config": config, "traffic": traffic,
                      "chips": 1, "why": "test"})
    rename = {"vrp-tw-n1000": ["vrp-tiny"], "tsp-n1000": ["tsp-tiny",
                                                            "tsp-1k"]}

    def cell_names(names):
        return [n.replace(k, v) for n in names for k, vs in rename.items()
                for v in vs if n.startswith(k)]

    bench = dict(real, configs=configs, workloads=cells)
    for group in ("end_to_end", "per_layer"):
        bench[group] = [dict(m, workloads=cell_names(m["workloads"]))
                        if "workloads" in m else m for m in real[group]]
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return path
