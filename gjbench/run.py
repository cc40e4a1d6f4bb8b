#!/usr/bin/env python3
"""Run one cell of the benchmark of `greyjack_tpu_torch` on this machine's
NVIDIA GPU and print its result as the last line of standard output.

    python3 gjbench/run.py --workload vrp-tw-n1000.ts-sweep --seed 7 \\
        --seconds 30 --trace 0

`--trace 0` reports the cell's end-to-end metrics over a timed solve of
`--seconds`, `--trace 1` its per-layer metrics from a profiler trace of a
few chunks, after which the solve ends. Either way the run checks the
timed solve against the plain reference (`gjbench/check.py`) and prints
every number compared beside its limit, on standard error and last in the
result line. Exits non-zero, printing no result, without a
CUDA device, outside a checkout of the repository, or when JAX or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# whole top-level module names that must not be loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "greyjack_tpu")


def fail(msg, code=1):
    print(f"gjbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def caches():
    """Kernel and build caches at fixed paths inside the checkout."""
    base = os.path.join(ROOT, ".gjbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    caches()
    sys.path.insert(0, ROOT)
    from gjbench import harness

    try:
        bench, entry, _, _ = harness.load(ROOT, args.workload)
    except (OSError, KeyError, ValueError, StopIteration) as e:
        fail(f"cannot load cell {args.workload}: {e}")
    import torch

    chips = entry["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        fail(f"needs {chips} CUDA device(s); found {found}")
    try:
        import greyjack_tpu_torch
    except ImportError as e:
        fail(f"the port is not here: {e}")
    if not os.path.abspath(greyjack_tpu_torch.__file__).startswith(
            ROOT + os.sep):
        fail(f"greyjack_tpu_torch comes from {greyjack_tpu_torch.__file__}, "
             f"not from the checkout at {ROOT}")

    result, info = harness.run(ROOT, args.workload, args.seed, args.seconds,
                               bool(args.trace), "cuda:0", T_START)
    result["device"]["power"] = power_line()
    print(f"gjbench: {args.workload} seed {args.seed}: {info['chunks']} "
          f"chunks, window {info['window_s']:.3f} s, path {info['path']}, "
          f"best {info['final_score']}, card {result['device']['power']}",
          file=sys.stderr)
    found = forbidden_modules()
    if found:
        fail(f"loaded forbidden modules: {', '.join(found)}", code=3)
    for name, v in result["checks"].items():
        print(f"check {name}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
