"""VRP domain model + synthetic instances (counterpart of
`greyjack_tpu/models/vrp/domain.py`).

Multi-depot CVRP with optional time windows: the first `d` rows of the
customer list are depots; vehicles are assigned round-robin over depots;
vehicle work-day = depot time window. Coordinates and facts come from numpy,
so both packages build the same instance from the same seed; the distance
matrix (Euclidean, truncated to 3 decimals) is built in f64 on the host and
placed on `device`.
The `.vrp` file reader is not ported yet.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from greyjack_tpu_torch.ops.distance import euclidean_matrix


class Customer:
    def __init__(self, id, vec_id, latitude, longitude, name=None,
                 demand=0, time_window_start=0, time_window_end=0,
                 service_time=0, frozen=False):
        self.id = int(id)
        self.vec_id = int(vec_id)
        self.latitude = float(latitude)
        self.longitude = float(longitude)
        self.name = name if name is not None else str(id)
        self.demand = int(demand)
        self.time_window_start = int(time_window_start)
        self.time_window_end = int(time_window_end)
        self.service_time = int(service_time)
        self.frozen = bool(frozen)


class Vehicle:
    def __init__(self, depot, customers, depot_vec_id, work_day_start,
                 work_day_end, capacity, max_stops):
        self.depot = depot
        self.customers = customers  # ordered visit list of Customer
        self.depot_vec_id = int(depot_vec_id)
        self.work_day_start = int(work_day_start)
        self.work_day_end = int(work_day_end)
        self.capacity = int(capacity)
        self.max_stops = int(max_stops)


class VehicleRoutingPlan:
    def __init__(self, name, vehicles, customers_vec, distance_matrix,
                 depot_vec, time_windowed):
        self.name = name
        self.vehicles = vehicles
        self.customers_vec = customers_vec
        self.distance_matrix = distance_matrix  # f64[L, L] tensor on device
        self.depot_vec = depot_vec
        self.time_windowed = bool(time_windowed)


def _build_plan(name, customers, n_depots, k_vehicles, capacity,
                time_windowed, device):
    # built on the host, so the matrix does not depend on the device's
    # floating-point contraction choices, then moved to `device`
    xs = torch.tensor([c.latitude for c in customers], dtype=torch.float64)
    ys = torch.tensor([c.longitude for c in customers], dtype=torch.float64)
    dm = euclidean_matrix(xs, ys, precision=3).to(device)
    max_stops = len(customers) - n_depots
    vehicles = []
    for i in range(k_vehicles):
        depot = customers[i % n_depots]
        vehicles.append(
            Vehicle(depot, [], i % n_depots, depot.time_window_start,
                    depot.time_window_end, capacity, max_stops)
        )
    depot_vec = customers[:n_depots]
    return VehicleRoutingPlan(name, vehicles, customers, dm, depot_vec,
                              time_windowed)


def generate_instance(n_customers, n_depots=1, k_vehicles=10, seed=0,
                      time_windowed=False, span=100.0, name=None,
                      device="cpu"):
    """Synthetic belgium-style instance, draw for draw the JAX package's:
    uniform coordinates, U{1..30} demands, capacity sized for ~1.3x slack,
    day-long depot windows, random customer windows."""
    rng = np.random.default_rng(seed)
    total = n_depots + n_customers
    pts = rng.uniform(0.0, span, size=(total, 2))
    demands = rng.integers(1, 31, size=total)
    demands[:n_depots] = 0
    day_end = 10 * 86400
    customers = []
    for i in range(total):
        if i < n_depots:
            tw = (0, day_end, 0)
        elif time_windowed:
            start = int(rng.integers(0, day_end // 2))
            tw = (start, start + int(rng.integers(day_end // 10, day_end // 2)),
                  int(rng.integers(60, 1800)))
        else:
            tw = (0, 0, 0)
        customers.append(
            Customer(i + 1, i, pts[i, 0], pts[i, 1], None, demands[i],
                     tw[0], tw[1], tw[2])
        )
    capacity = max(1, math.ceil(1.3 * demands.sum() / k_vehicles))
    return _build_plan(name or f"synthetic-n{n_customers}-k{k_vehicles}",
                       customers, n_depots, k_vehicles, capacity,
                       time_windowed, torch.device(device))


class DomainBuilder:
    def __init__(self, generator):
        self.generator = generator

    @classmethod
    def from_generator(cls, generator):
        return cls(generator=generator)

    def build_domain_from_scratch(self):
        return self.generator()

    def build_from_solution(self, solution, initial_domain=None):
        """Reference `build_from_solution` (`domain_builder.rs:91-135`):
        pairs come in (vehicle_id, customer_id) per stop; order within a
        vehicle = stop index order."""
        if initial_domain is None:
            domain = self.build_domain_from_scratch()
        else:
            domain = copy.deepcopy(initial_domain)
            for vehicle in domain.vehicles:
                vehicle.customers = []
        pairs = solution[0]
        for i in range(0, len(pairs), 2):
            if "vehicle" in pairs[i][0]:
                vehicle_id, customer_id = int(pairs[i][1]), int(pairs[i + 1][1])
            else:
                vehicle_id, customer_id = int(pairs[i + 1][1]), int(pairs[i][1])
            domain.vehicles[vehicle_id].customers.append(
                domain.customers_vec[customer_id]
            )
        return domain

    def build_from_domain(self, domain):
        return copy.deepcopy(domain)
