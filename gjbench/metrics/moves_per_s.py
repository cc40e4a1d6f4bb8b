"""moves_per_s: candidate moves scored a second over the measured window.

The window runs from the entry of the timed solve's second chunk into
`IslandRunner.run_chunk` to the solve's return, and holds every chunk cycle
after the first: the device work, the solver's read of the tops, the
termination checks, the conversion of a new best and the observers. Moves
are counted by the static rule the workload names (`_moves`) for every
island and step of those chunks."""

from gjbench.metrics import _moves


def read(run):
    per = _moves.per_island_step(run["config"], run["workload"])
    moves = (run["window_chunks"] * run["workload"]["chunk_steps"]
             * run["workload"]["islands"] * per)
    return moves / run["window_s"]
