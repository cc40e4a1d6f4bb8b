"""VRP solving service example (twin of `examples/vrp_service_example.py`;
reference `examples/vrp_service/src/main.rs` and its python client), over
the HTTP broker on port 8077.

    python -m greyjack_tpu_torch.examples.vrp_service_example server
        [--device cpu]
    python -m greyjack_tpu_torch.examples.vrp_service_example client
"""

import argparse
import json
import urllib.request

from greyjack_tpu_torch.agents import TabuSearch
from greyjack_tpu_torch.agents.termination_strategies import (
    ScoreNoImprovement)
from greyjack_tpu_torch.models.vrp import generate_instance
from greyjack_tpu_torch.service import HttpBroker, SolverService
from greyjack_tpu_torch.service.solver_service import domain_to_task_json
from greyjack_tpu_torch.solver import SolverLoggingLevels

PORT = 8077


def agent_factory():
    return TabuSearch(1024, 0.2, True, None, [0.5, 0.5, 0.0, 0.0, 0.0, 0.0],
                      10, ScoreNoImprovement(5_000))


def server(device):
    broker = HttpBroker(port=PORT)
    service = SolverService(broker, agent_factory, n_jobs=8,
                            logging_level=SolverLoggingLevels.FreshOnly,
                            device=device)
    print(f"VRP service listening on :{broker.port}")
    try:
        service.serve_forever()
    finally:
        broker.close()


def client(device):
    domain = generate_instance(50, 2, 10, seed=1, time_windowed=True,
                               device=device)
    task = domain_to_task_json(domain)
    req = urllib.request.Request(
        f"http://127.0.0.1:{PORT}/tasks", data=json.dumps(task).encode(),
        method="POST")
    urllib.request.urlopen(req)
    while True:
        resp = urllib.request.urlopen(f"http://127.0.0.1:{PORT}/solutions",
                                      timeout=60)
        solution = json.loads(resp.read())
        if solution == "Solving finished":
            print("done")
            break
        if solution is None:
            continue
        print(f"distance={solution['sum_travel_distance']:.3f} "
              f"unique_stops={solution['unique_stops']}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("role", nargs="?", choices=("server", "client"),
                    default="client")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    (server if args.role == "server" else client)(args.device)


if __name__ == "__main__":
    main()
