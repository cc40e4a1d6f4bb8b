"""N-Queens domain model + persistence (counterpart of
`greyjack_tpu/models/nqueens/domain.py`; reference
`examples/nqueens/src/domain/*.rs`, `persistence/domain_builder.rs`: a
seeded shuffle of row ids; the solution round-trip parses
`"queens: {i}-->row_id"` names).

The board holds no tensor, so it carries the device its cotwin is built
on: the card unless the caller names another (tests pass device="cpu").
"""

from __future__ import annotations

import copy
import random

import torch


class Queen:
    def __init__(self, row_id, column_id):
        self.row_id = int(row_id)
        self.column_id = int(column_id)


class ChessBoard:
    def __init__(self, n, queens, device="cuda"):
        self.n = int(n)
        self.queens = queens
        self.device = torch.device(device)

    def conflict_count(self):
        """Host-side validity metric: conflicts over rows and both
        diagonals."""
        rows = [q.row_id for q in self.queens]
        desc = [q.column_id + q.row_id for q in self.queens]
        asc = [q.column_id - q.row_id for q in self.queens]
        n = len(rows)
        return (
            (n - len(set(rows)))
            + (n - len(set(desc)))
            + (n - len(set(asc)))
        )

    def __str__(self):
        keys = {(q.row_id, q.column_id) for q in self.queens}
        lines = []
        for i in range(self.n):
            lines.append(
                " ".join("+" if (i, j) in keys else "-" for j in range(self.n))
            )
        return "\n".join(lines)


class DomainBuilder:
    """Builds the seeded board (the same `random.Random` shuffle as the JAX
    package, so both build the same board) on `device`; without a card
    the default raises when the cotwin is built."""

    def __init__(self, n_queens, random_seed, device="cuda"):
        self.n_queens = int(n_queens)
        self.random_seed = int(random_seed)
        self.device = torch.device(device)

    def build_domain_from_scratch(self):
        row_ids = list(range(self.n_queens))
        rng = random.Random(self.random_seed)
        rng.shuffle(row_ids)
        queens = [Queen(row_ids[i], i) for i in range(self.n_queens)]
        return ChessBoard(self.n_queens, queens, self.device)

    def build_from_solution(self, solution, initial_domain=None):
        domain = self.build_domain_from_scratch()
        for name, value in solution[0]:
            queen_id = int(name.split(" ")[1].split("-->")[0])
            domain.queens[queen_id].row_id = int(value)
        return domain

    def build_from_domain(self, domain):
        return copy.deepcopy(domain)

    def clone(self):
        return DomainBuilder(self.n_queens, self.random_seed, self.device)
