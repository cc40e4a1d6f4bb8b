"""Nothing a run loads is JAX or the JAX package, judged by whole top-level
module names (the port's name begins with the JAX package's); the
reference loads nothing of the port; a run without a card prints no
result."""

import os
import subprocess
import sys

from gjbench.tests import _tiny

ROOT = _tiny.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "greyjack_tpu"}


def child(code, cwd=ROOT):
    """Run `code` in a fresh interpreter; returns its stdout lines."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


def test_a_run_loads_no_jax(tmp_path):
    lines = child(
        "import sys, time\n"
        "from gjbench.tests import _tiny\n"
        "from gjbench import harness\n"
        f"root = _tiny.make_root({str(tmp_path)!r})\n"
        "for cell in sorted(_tiny.CELLS):\n"
        "    harness.run(root, cell, 5, 0.5, False, 'cpu',"
        " time.perf_counter())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    top = set(eval(lines[-1]))
    assert "greyjack_tpu_torch" in top
    assert not top & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    lines = child(
        "import sys\n"
        "import gjbench.reference.common, gjbench.reference.vrp\n"
        "import gjbench.reference.tsp\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    top = set(eval(lines[-1]))
    assert not top & (FORBIDDEN | {"greyjack_tpu_torch"})


def test_forbidden_names_are_whole_top_level_names():
    sys.path.insert(0, os.path.join(ROOT, "gjbench"))
    try:
        import run
    finally:
        sys.path.pop(0)
    saved = dict(sys.modules)
    try:
        for name in list(sys.modules):
            if name.split(".")[0] in FORBIDDEN:
                del sys.modules[name]
        sys.modules["greyjack_tpu_torch_like"] = sys
        assert run.forbidden_modules() == []
        sys.modules["greyjack_tpu.models"] = sys
        assert run.forbidden_modules() == ["greyjack_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_no_card_no_result():
    """Here there is no CUDA device: the run exits non-zero and prints no
    result line."""
    out = subprocess.run(
        [sys.executable, "gjbench/run.py", "--workload",
         "vrp-tw-n1000.ts-sweep", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""
