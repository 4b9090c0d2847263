"""The readings that the limits of a cell's check were set from.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 2

runs the cell's window once a seed, in one process, first with the
program as it is (the lower reading: what sound runs compare) and then
with each control in the program's place: the plain reference with one
guarantee of the configuration broken (``entries/<entry>.py``'s
``controls``; for the per-read rows an N read as the base A, and at a
canonical k the forward key).  A control has to come out not correct.
One JSON line a run.  The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness, spec  # noqa: E402


def control_route(entry, variant: str):
    """The entry's reference with the guarantee ``variant`` broken, with
    the program's call signature."""
    def route(codes, k, canonical=False):
        return entry.reference(codes, k, canonical, **{variant: True})
    return route


def readings(cell: spec.Cell, seeds, seconds: float, variants, device) -> list:
    """One result a (variant, seed); ``None`` is the program itself."""
    entry = spec.load_module("entries", cell.traffic["entry"])
    program = importlib.import_module(entry.PROGRAM_MODULE)
    real = getattr(program, entry.PROGRAM_CALL)
    out = []
    for variant in variants:
        for seed in seeds:
            if variant is not None:
                setattr(program, entry.PROGRAM_CALL, control_route(entry, variant))
            try:
                r = harness.run_cell(cell, seed, seconds, False, device, time.perf_counter())
            finally:
                setattr(program, entry.PROGRAM_CALL, real)
            out.append({"variant": variant or "program", "seed": seed,
                        "correct": r["correct"], "attempted": r["attempted"],
                        "checks": r["checks"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--variants", help="comma-separated, of 'program' and the "
                    "entry's controls; all of them by default")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    entry = spec.load_module("entries", cell.traffic["entry"])
    variants = ["program"] + entry.controls(cell.config)
    if args.variants:
        variants = [v for v in args.variants.split(",") if v in variants]
    variants = [None if v == "program" else v for v in variants]
    seeds = [int(s) for s in args.seeds.split(",")]
    for r in readings(cell, seeds, args.seconds, variants, torch.device("cuda", 0)):
        print(json.dumps(dict(r, workload=cell.name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
