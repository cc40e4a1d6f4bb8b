"""The lower-precision control fails: the reference computed in float32,
put in the program's place (`check.judge` with `control`), reads over a
limit on every seed, while the program reads every number at 0. Here at
test sizes on the CPU; on the card at each cell's own size
(`gjbench/control.py` runs the same readings there)."""

import pytest

from gjbench import control
from gjbench.tests import _tiny

SEEDS = [101, 102, 2 ** 31 + 103]
CELLS = [c for c in sorted(_tiny.CELLS) if c.startswith("vrp")] + sorted(
    _tiny.CONTROL_CELLS)


def over(numbers):
    from gjbench import check
    return {k for k, v in numbers.items() if v > check.LIMITS[k]}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(tiny_root, cell, seed):
    got = control.readings(tiny_root, cell, seed, 0.5, "cpu")
    assert not over(got["program"]), got
    assert over(got["control"]), got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["vrp-tw-n1000.ts-sweep",
                                  "tsp-n1000.ts-sweep",
                                  "vrp-tw-n1000.ts-intdelta",
                                  "vrp-tw-n1000.ts-plain"])
def test_control_fails_at_the_cells_size(card, cell):
    for seed in SEEDS:
        got = control.readings(_tiny.ROOT, cell, seed, 3.0, card)
        assert not over(got["program"]), got
        assert over(got["control"]), got


@pytest.mark.cuda
def test_cells_run_on_the_card(card):
    """Each cell of BENCHMARK.json, a short window, correct."""
    import time

    from gjbench import harness
    for cell in ("vrp-tw-n1000.ts-sweep", "tsp-n1000.ts-sweep",
                 "vrp-tw-n1000.ts-intdelta", "vrp-tw-n1000.ts-plain"):
        result, _ = harness.run(_tiny.ROOT, cell, 77, 3.0, False, card,
                                time.perf_counter())
        assert result["correct"], result["checks"]
