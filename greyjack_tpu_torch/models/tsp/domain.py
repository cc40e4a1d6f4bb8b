"""TSP domain model + TSPLIB persistence (counterpart of
`greyjack_tpu/models/tsp/domain.py`; reference `examples/tsp/src/domain/*.rs`,
`persistence/domain_builder.rs:92-213`).

Distances are Euclidean, truncated to 3 decimals per entry
(`location.rs:38-50`). The matrix is built in f64 on the host by
`ops.distance.euclidean_matrix` (bit-equal to the JAX package's) and placed
on the domain's device, the card unless the caller names another.
"""

from __future__ import annotations

import copy
import re

import numpy as np
import torch

from greyjack_tpu_torch.native import parse_instance
from greyjack_tpu_torch.ops.distance import euclidean_matrix
from greyjack_tpu_torch.utils.math_utils import round_decimal, round_decimal_t


class Location:
    def __init__(self, id, latitude, longitude, name=None):
        self.id = int(id)
        self.latitude = float(latitude)
        self.longitude = float(longitude)
        self.name = name if name is not None else str(id)

    def distance_to(self, other):
        d = ((other.latitude - self.latitude) ** 2
             + (other.longitude - self.longitude) ** 2) ** 0.5
        return round_decimal(d, 3)


class TravelSchedule:
    def __init__(self, name, locations_vec, distance_matrix):
        self.name = name
        self.locations_vec = locations_vec
        self.distance_matrix = distance_matrix  # f64[L, L] tensor on device
        self.trip_path: list = []  # location ids (reference vehicle.trip_path)

    def get_travel_distance(self):
        assert self.trip_path, "trip_path is not initialized (task not solved?)"
        locs = self.locations_vec
        depot = locs[0]
        path = [locs[i] for i in self.trip_path]
        d = depot.distance_to(path[0]) + path[-1].distance_to(depot)
        for i in range(1, len(path)):
            d += path[i - 1].distance_to(path[i])
        return d

    def get_unique_stops_count(self):
        return len(set(self.trip_path))

    def print_metrics(self):
        print(f"Solution distance: {self.get_travel_distance()}")
        print(f"Unique stops (excluding depot): {self.get_unique_stops_count()}")

    def print_path(self):
        names = [self.locations_vec[0].name]
        names += [self.locations_vec[i].name for i in self.trip_path]
        names.append(self.locations_vec[0].name)
        print(" --> ".join(names))


def _build_schedule(name, locations, device):
    # built on the host, so the matrix does not depend on the device's
    # floating-point contraction choices, then moved to `device`
    xs = torch.tensor([lc.latitude for lc in locations], dtype=torch.float64)
    ys = torch.tensor([lc.longitude for lc in locations], dtype=torch.float64)
    dm = euclidean_matrix(xs, ys, precision=3).to(device)
    return TravelSchedule(name, locations, dm)


def generate_uniform_instance(n_locations, seed=0, span=100.0, name=None,
                              device="cuda"):
    """Synthetic instance, draw for draw the JAX package's: uniform points
    in a square (the reference repo ships no data files). The matrix lives
    on `device`, the card unless the caller names another (tests pass
    device="cpu"); without a card the default raises."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.0, span, size=(n_locations, 2))
    locations = [Location(i, pts[i, 0], pts[i, 1]) for i in range(n_locations)]
    return _build_schedule(name or f"uniform-{n_locations}", locations,
                           torch.device(device))


class DomainBuilder:
    """Builds from a TSPLIB file path (onto `device`) or from a generator of
    `TravelSchedule`s (which places its own matrix)."""

    def __init__(self, tsp_file_path=None, generator=None, device="cuda"):
        assert (tsp_file_path is None) != (generator is None)
        self.tsp_file_path = tsp_file_path
        self.generator = generator
        self.device = torch.device(device)

    @classmethod
    def from_generator(cls, generator):
        return cls(tsp_file_path=None, generator=generator)

    def build_domain_from_scratch(self):
        if self.generator is not None:
            return self.generator()
        metadata, locations, matrix = read_tsp_file(self.tsp_file_path)
        name = metadata.get("dataset_name", "tsp")
        if matrix is not None:
            dm = round_decimal_t(torch.as_tensor(matrix, dtype=torch.float64),
                                 3)
            return TravelSchedule(name, locations, dm.to(self.device))
        return _build_schedule(name, locations, self.device)

    def build_from_solution(self, solution, initial_domain=None):
        domain = self.build_domain_from_scratch()
        domain.trip_path = [int(value) for _name, value in solution[0]]
        return domain

    def build_from_domain(self, domain):
        return copy.deepcopy(domain)


def read_tsp_file(path):
    """TSPLIB parser (reference `read_tsp_file`, `domain_builder.rs:92-213`):
    metadata until NODE_COORD_SECTION, whitespace-split coordinate rows
    until EOF (a fourth column is the location's name), then an optional
    explicit distance matrix, used for non-EUC_2D types. Returns
    (metadata, locations, matrix or None).

    Uses the native C++ tokenizer (`greyjack_tpu_torch/native`) when it
    builds; the Python scan (`scan_tsp_file`) is the fallback, and keeps a
    name column, which the native path drops in favour of the ids."""
    native = parse_instance(path)
    if native is not None and len(native["ids"]):
        metadata = {
            "dataset_name": native["name"] or "tsp",
            "distance_type": native["edge_weight_type"] or "EUC_2D",
        }
        locations = [
            Location(int(i), x, y)
            for i, x, y in zip(native["ids"], native["xs"], native["ys"])
        ]
        matrix = None
        if ("EUC_2D" not in metadata["distance_type"]
                and native["matrix"] is not None):
            matrix = native["matrix"]
        return metadata, locations, matrix
    return scan_tsp_file(path)


def scan_tsp_file(path):
    """The pure-Python TSPLIB scan (`greyjack_tpu/models/tsp/domain.py`
    `read_tsp_file`'s fallback)."""
    metadata = {}
    locations = []
    matrix_rows = []
    section = "meta"
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if section == "meta":
                if "NODE_COORD_SECTION" in line:
                    section = "coords"
                    continue
                if "NAME" in line:
                    metadata["dataset_name"] = line.split()[-1]
                if "EDGE_WEIGHT_TYPE" in line:
                    metadata["distance_type"] = line.split()[-1]
            elif section == "coords":
                if "EOF" in line:
                    section = "matrix"
                    continue
                parts = re.sub(r"\s+", " ", line).split(" ")
                if len(parts) < 3:
                    continue
                name = parts[3] if len(parts) > 3 else parts[0]
                locations.append(Location(int(parts[0]), float(parts[1]),
                                          float(parts[2]), name))
            else:
                if "EOF" in line or not line:
                    break
                parts = line.split(" ")
                matrix_rows.append([float(x) for x in parts if x])
    matrix = None
    if "EUC_2D" not in metadata.get("distance_type", "EUC_2D") and matrix_rows:
        matrix = np.array(matrix_rows)
    return metadata, locations, matrix
