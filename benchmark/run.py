"""Run one cell of BENCHMARK.json once, on the card of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number the check compared beside its limit; the same numbers are the
last lines of standard error.  With no CUDA card, fewer cards than the
cell asks for, no program beside the benchmark, or JAX or the JAX
package loaded once the window has closed, it prints no result and
exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every cache lies inside the checkout, at a fixed path.
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "benchmark_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "benchmark_cache" / "torch_extensions")
sys.path.insert(0, str(ROOT))

FORBIDDEN = {"jax", "jaxlib", "flax", "cfrk_tpu"}
PROGRAM = "cfrk_tpu_torch"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def program_is_beside() -> None:
    import importlib

    mod = importlib.import_module(PROGRAM)
    where = Path(mod.__file__).resolve()
    if ROOT not in where.parents:
        raise RuntimeError(f"{PROGRAM} imported from {where}, not from {ROOT}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)

    from benchmark import harness, spec

    cell = spec.cell(args.workload)
    import torch

    print(f"imports s: {time.perf_counter() - T_START:.3f}", file=sys.stderr)

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s), "
              f"this machine shows {n}", file=sys.stderr)
        return 2
    program_is_beside()
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    from benchmark.card import card_line

    result["device"]["card"] = card_line()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} {c['rule']} {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
