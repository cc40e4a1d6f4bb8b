"""Standalone VRP service client (twin of `examples/vrp_client.py`; the
reference's python client,
`examples/vrp_service/python_client/scripts/solve_vrp_by_rust_service.py:1-70`):
build a task payload from a domain (a generated instance, or a `.vrp`
file), submit it to a running solver service, then stream every fresh
global-best solution until the service sends "Solving finished".

Start the server first:
    python -m greyjack_tpu_torch.examples.vrp_service_example server
then run this client:
    python -m greyjack_tpu_torch.examples.vrp_client [--host 127.0.0.1]
        [--port 8077] [--vrp-file path/to/instance.vrp]
        [--customers 50 --depots 2 --vehicles 10] [--device cpu]
"""

import argparse
import json
import sys
import urllib.error
import urllib.request

from greyjack_tpu_torch.service.solver_service import domain_to_task_json


def build_task(args):
    if args.vrp_file:
        from greyjack_tpu_torch.models.vrp import DomainBuilder
        domain = DomainBuilder(args.vrp_file, device=args.device) \
            .build_domain_from_scratch()
    else:
        from greyjack_tpu_torch.models.vrp import generate_instance
        domain = generate_instance(args.customers, args.depots, args.vehicles,
                                   seed=args.seed, time_windowed=True,
                                   device=args.device)
    task = domain_to_task_json(domain)
    # the reference client tags tasks with user/task ids (`:54-55`); the
    # service echoes unknown fields back, so the tags survive the round-trip
    task["user_id"] = 13
    task["task_id"] = 45
    return task


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8077)
    ap.add_argument("--vrp-file", default=None)
    ap.add_argument("--customers", type=int, default=50)
    ap.add_argument("--depots", type=int, default=2)
    ap.add_argument("--vehicles", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    base = f"http://{args.host}:{args.port}"
    task = build_task(args)
    req = urllib.request.Request(f"{base}/tasks",
                                 data=json.dumps(task).encode(),
                                 method="POST")
    urllib.request.urlopen(req)
    print(f"submitted task to {base}/tasks "
          f"({task['customers_dict']['n_customers']} customers, "
          f"{task['metadata']['vehicles_count']} vehicles); "
          "streaming solutions:")

    while True:
        try:
            resp = urllib.request.urlopen(f"{base}/solutions", timeout=120)
        except urllib.error.URLError as e:
            print(f"service unreachable: {e}", file=sys.stderr)
            return 1
        solution = json.loads(resp.read())
        if solution == "Solving finished":
            print("done")
            return 0
        if solution is None:  # no fresh global best yet — poll again
            continue
        print(f"distance={solution['sum_travel_distance']:.3f} "
              f"unique_stops={solution['unique_stops']} "
              f"trips={len(solution['trips'])}")


if __name__ == "__main__":
    raise SystemExit(main())
