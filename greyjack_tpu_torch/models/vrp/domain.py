"""VRP domain model + .vrp persistence + synthetic instances (counterpart
of `greyjack_tpu/models/vrp/domain.py`; reference
`persistence/domain_builder.rs:18-316`).

Multi-depot CVRP with optional time windows: the first `d` rows of the
customer list are depots; vehicles are assigned round-robin over depots;
vehicle work-day = depot time window. Coordinates and facts come from numpy,
so both packages build the same instance from the same seed; the distance
matrix (Euclidean, truncated to 3 decimals) is built in f64 on the host and
placed on `device`. `.vrp` files are read by the native tokenizer
(`greyjack_tpu_torch/native`) when it builds, else scanned in Python.
"""

from __future__ import annotations

import copy
import math
import re

import numpy as np
import torch

from greyjack_tpu_torch.native import parse_instance
from greyjack_tpu_torch.ops.distance import euclidean_matrix
from greyjack_tpu_torch.utils.math_utils import round_decimal


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

    def distance_to(self, other):
        d = ((other.latitude - self.latitude) ** 2
             + (other.longitude - self.longitude) ** 2) ** 0.5
        return round_decimal(d, 3)


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

    def get_unique_stops_count(self):
        return len({c.vec_id for v in self.vehicles for c in v.customers})

    def get_trip_distance(self, vehicle):
        trip = vehicle.customers
        if not trip:
            return 0.0
        d = (vehicle.depot.distance_to(trip[0])
             + trip[-1].distance_to(vehicle.depot))
        for i in range(1, len(trip)):
            d += trip[i - 1].distance_to(trip[i])
        return d

    def get_sum_travel_distance(self):
        return sum(self.get_trip_distance(v) for v in self.vehicles)

    def get_trip_demand(self, vehicle):
        return sum(c.demand for c in vehicle.customers)

    def print_metrics(self):
        print(f"Solution distance: {self.get_sum_travel_distance()}")
        print(f"Unique stops (excluding depot): "
              f"{self.get_unique_stops_count()}")

    def print_trip_paths(self):
        for k, vehicle in enumerate(self.vehicles):
            names = [vehicle.depot.name]
            names += [c.name for c in vehicle.customers]
            names.append(vehicle.depot.name)
            print()
            print(f"vehicle {k} trip metrics:")
            print(f"Distance: {self.get_trip_distance(vehicle)}")
            print(f"Demand / capacity: {self.get_trip_demand(vehicle)} / "
                  f"{vehicle.capacity}")
            print(" --> ".join(names))
            print()


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
                      device="cuda"):
    """Synthetic belgium-style instance, draw for draw the JAX package's:
    uniform coordinates, U{1..30} demands, capacity sized for ~1.3x slack,
    day-long depot windows, random customer windows. The instance's
    tensors live on `device`, the card unless the caller names another
    (tests pass device="cpu"); without a card the default raises."""
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
    """Builds from a `.vrp` file path (onto `device`, the card unless the
    caller names another) or from a generator of plans (which places its
    own matrix)."""

    def __init__(self, vrp_file_path=None, generator=None, device="cuda"):
        if (vrp_file_path is None) == (generator is None):
            raise ValueError("give exactly one of vrp_file_path, generator")
        self.vrp_file_path = vrp_file_path
        self.generator = generator
        self.device = torch.device(device)

    @classmethod
    def from_generator(cls, generator):
        return cls(generator=generator)

    def build_domain_from_scratch(self):
        if self.generator is not None:
            return self.generator()
        return read_vrp_file(self.vrp_file_path, device=self.device)

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


def read_vrp_file(path, device="cuda"):
    """.vrp parser (reference `read_vrp_file`, `domain_builder.rs:145-316`):
    metadata (the vehicle count from the NAME's `-kNN` suffix, CAPACITY),
    NODE_COORD_SECTION rows, DEMAND_SECTION rows (id demand [tw_start
    tw_end service]), DEPOT_SECTION ids. The native tokenizer reads the
    file when it builds (names are then the ids); otherwise the Python scan
    below, which keeps a fourth coordinate column as the name."""
    native = parse_instance(path)
    if native is not None and len(native["ids"]) and len(native["depot_ids"]):
        demand = native["demand_rows"]
        time_windowed = demand.shape[1] == 5
        customers = []
        for vec_id in range(len(native["ids"])):
            cid = int(native["ids"][vec_id])
            d = demand[vec_id]
            if int(d[0]) != cid:
                raise ValueError("Invalid customer to demand mapping")
            tw = ((int(d[2]), int(d[3]), int(d[4])) if time_windowed
                  else (0, 0, 0))
            customers.append(Customer(
                cid, vec_id, float(native["xs"][vec_id]),
                float(native["ys"][vec_id]), None, int(d[1]), *tw))
        return _build_plan(native["name"] or "vrp", customers,
                           len(native["depot_ids"]),
                           int(native["vehicles_count"]),
                           int(native["capacity"]), time_windowed,
                           torch.device(device))
    return scan_vrp_file(path, device)


def scan_vrp_file(path, device="cuda"):
    """The pure-Python `.vrp` scan (`greyjack_tpu/models/vrp/domain.py`
    `read_vrp_file`'s fallback)."""
    metadata = {}
    coord_rows = []
    demand_rows = []
    depot_ids = []
    section = "meta"
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if section == "meta":
                if "NODE_COORD_SECTION" in line:
                    section = "coords"
                    continue
                if "NAME" in line:
                    name = line.split()[-1]
                    metadata["dataset_name"] = name
                    metadata["vehicles_count"] = name.split("-")[-1].replace(
                        "k", "")
                if "CAPACITY" in line:
                    metadata["vehicles_capacity"] = line.split()[-1]
            elif section == "coords":
                if "DEMAND_SECTION" in line or "EOF" in line:
                    section = "demand"
                    continue
                parts = re.sub(r"\s+", " ", line).split(" ")
                if len(parts) >= 3:
                    coord_rows.append(parts)
            elif section == "demand":
                if "DEPOT_SECTION" in line or "EOF" in line:
                    section = "depot"
                    continue
                parts = line.split()
                if parts:
                    demand_rows.append([int(x) for x in parts])
            else:
                if "EOF" in line or line == "-1" or not line:
                    break
                depot_ids.append(int(line))

    time_windowed = any(len(r) == 5 for r in demand_rows)
    customers = []
    for vec_id, parts in enumerate(coord_rows):
        cid = int(parts[0])
        name = parts[3] if len(parts) > 3 else parts[0]
        d = demand_rows[vec_id]
        if d[0] != cid:
            raise ValueError("Invalid customer to demand mapping")
        tw = (d[2], d[3], d[4]) if len(d) == 5 else (0, 0, 0)
        customers.append(
            Customer(cid, vec_id, float(parts[1]), float(parts[2]), name,
                     d[1], tw[0], tw[1], tw[2])
        )
    return _build_plan(metadata.get("dataset_name", "vrp"), customers,
                       len(depot_ids), int(metadata["vehicles_count"]),
                       int(metadata["vehicles_capacity"]), time_windowed,
                       torch.device(device))
