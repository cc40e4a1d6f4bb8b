"""Solving as a service: consume task JSONs, stream global-best solutions
(counterpart of `greyjack_tpu/service/solver_service.py`).

Reference: `examples/vrp_service/src/main.rs:30-105`: for each message,
build a VRP domain from JSON (not a file), run `Solver.solve` with an
observer that publishes every new global best, then send a "Solving
finished" marker. The domain is built on `device`, the card unless the
caller names another.
"""

from __future__ import annotations

import copy

import torch

from greyjack_tpu_torch.models.vrp import CotwinBuilder, DomainBuilder
from greyjack_tpu_torch.models.vrp.domain import (Customer, _build_plan,
                                                  VehicleRoutingPlan)
from greyjack_tpu_torch.solver import Solver, SolverLoggingLevels
from greyjack_tpu_torch.solver.observer import Observer


class SolutionObserver(Observer):
    """Publishes each improved solution to the broker, rebuilt as a domain
    JSON (reference RabbitMQObserver,
    `observers/rabbitmq_observer.rs:33-57`)."""

    def __init__(self, domain_builder, broker):
        self.domain_builder = domain_builder
        self.broker = broker

    def update(self, solution):
        domain = self.domain_builder.build_from_solution(solution)
        payload = {
            "name": domain.name,
            "sum_travel_distance": domain.get_sum_travel_distance(),
            "unique_stops": domain.get_unique_stops_count(),
            "trips": [
                {
                    "vehicle": k,
                    "depot": v.depot.vec_id,
                    "customers": [c.vec_id for c in v.customers],
                }
                for k, v in enumerate(domain.vehicles)
            ],
            "solution": solution,
        }
        self.broker.publish_solution(payload)


class JsonDomainBuilder:
    """VRP domain from a task JSON (reference vrp_service
    `persistence/domain_builder.rs:19-60` format: metadata + customers_dict
    + depot_dict), built on `device`."""

    def __init__(self, vrp_json, device="cuda"):
        self.vrp_json = vrp_json
        self.device = torch.device(device)

    def build_domain_from_scratch(self):
        j = self.vrp_json
        meta = j["metadata"]
        time_windowed = str(meta.get("time_window_task_type",
                                     "false")).lower() == "true"
        n_customers = int(j["customers_dict"]["n_customers"])
        customers = []
        for i in range(n_customers):
            cj = j["customers_dict"][str(i)]
            customers.append(Customer(
                cj["id"], i, cj["latitude"], cj["longitude"],
                str(cj.get("name", cj["id"])), int(cj["demand"]),
                int(cj.get("time_window_start", 0)) if time_windowed else 0,
                int(cj.get("time_window_end", 0)) if time_windowed else 0,
                int(cj.get("service_time", 0)) if time_windowed else 0,
            ))
        n_depots = int(j["depot_dict"]["n_depots"])
        k_vehicles = int(meta["vehicles_count"])
        capacity = int(meta["vehicles_capacity"])
        return _build_plan(str(meta.get("dataset_name", "vrp")), customers,
                           n_depots, k_vehicles, capacity, time_windowed,
                           self.device)

    def build_from_solution(self, solution, initial_domain=None):
        return DomainBuilder.build_from_solution(self, solution,
                                                 initial_domain)

    def build_from_domain(self, domain):
        return copy.deepcopy(domain)


def domain_to_task_json(domain: VehicleRoutingPlan):
    """Inverse of JsonDomainBuilder: a task JSON from a domain (what the
    reference python client assembles from a .vrp file), in the JAX
    package's layout."""
    customers_dict = {"n_customers": len(domain.customers_vec)}
    for i, c in enumerate(domain.customers_vec):
        customers_dict[str(i)] = {
            "id": c.id, "name": c.name, "latitude": c.latitude,
            "longitude": c.longitude, "demand": c.demand,
            "time_window_start": c.time_window_start,
            "time_window_end": c.time_window_end,
            "service_time": c.service_time,
        }
    depot_dict = {"n_depots": len(domain.depot_vec)}
    for i in range(len(domain.depot_vec)):
        depot_dict[str(i)] = domain.depot_vec[i].id
    return {
        "metadata": {
            "dataset_name": domain.name,
            "distance_type": "EUC_2D",
            "task_type": "CVRP",
            "time_window_task_type": str(domain.time_windowed).lower(),
            "vehicles_capacity": domain.vehicles[0].capacity,
            "vehicles_count": len(domain.vehicles),
        },
        "customers_dict": customers_dict,
        "depot_dict": depot_dict,
    }


class SolverService:
    """Serves tasks from `broker`: each is solved by the agent
    `agent_builder_factory()` builds, on `device`."""

    def __init__(self, broker, agent_builder_factory, n_jobs=8,
                 score_precision=(0, 0, 3),
                 logging_level=SolverLoggingLevels.FreshOnly, seed=None,
                 device="cuda"):
        self.broker = broker
        self.agent_builder_factory = agent_builder_factory
        self.n_jobs = n_jobs
        self.score_precision = list(score_precision)
        self.logging_level = logging_level
        self.seed = seed
        self.device = torch.device(device)

    def serve_one(self, timeout=None):
        """Consume one task; returns the final solution, or None when no
        task came within `timeout` seconds."""
        task = self.broker.next_task(timeout=timeout)
        if task is None:
            return None
        domain_builder = JsonDomainBuilder(task, device=self.device)
        observers = [SolutionObserver(domain_builder, self.broker)]
        solution = Solver.solve(
            domain_builder,
            CotwinBuilder(True, True),
            self.agent_builder_factory(),
            n_jobs=self.n_jobs,
            score_precision=self.score_precision,
            logging_level=self.logging_level,
            observers=observers,
            seed=self.seed,
        )
        self.broker.publish_solution("Solving finished")
        return solution

    def serve_forever(self, poll_timeout=1.0, stop_event=None):
        while stop_event is None or not stop_event.is_set():
            self.serve_one(timeout=poll_timeout)
