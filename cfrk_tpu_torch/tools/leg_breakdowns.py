"""Stage breakdowns of every chip-smoke leg, for one or more checkouts.

    python -m cfrk_tpu_torch.tools.leg_breakdowns --tree build/parent \
        --tree . --tree . --tree build/parent [--work build/chip_smoke] \
        [--legs k8_nonzero,spectrum_k8_stream,...] [--out FILE]

Runs after ``chip_smoke.py``, on the seed-0 FASTAs it leaves in
``--work`` (``r150.fa``, ``r152.fa``, ``r150_half.fa``, ``r1m.fa``).
For each ``--tree`` in the order given (a checkout's root: the process
runs there, so its ``cfrk_tpu_torch`` is the one imported), each leg
runs in a fresh process on the GPU: the in-memory legs through
``tools/stage_breakdown.py`` (host seconds per stage, device time by
kind, busy share), the streamed legs through the CLI with ``--stream
--stats`` (its ``RunMetrics`` line, ``stages_s`` included).  Prints one
JSON line a run (tree, leg, the process's wall seconds and the
result), also appended to ``--out``.  Giving a parent checkout and this
one as parent, change, change, parent compares them on one card; copy
this checkout's ``tools/stage_breakdown.py`` into the parent first, so
that one tool measures both.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

__all__ = ["LEGS", "run_leg"]

# leg -> (kind, input file, arguments): "breakdown" legs take
# stage_breakdown's arguments after IN OUT, "stream" legs the CLI's.
LEGS = {
    "k8_nonzero": ("breakdown", "r150.fa", ["8", "--nonzero"]),
    "k31_canonical_nonzero": ("breakdown", "r152.fa", ["31", "--canonical", "--nonzero"]),
    "k8_dense_api_nonzero": ("breakdown", "r150_half.fa",
                             ["8", "--nonzero", "--impl", "pallas"]),
    "k4_dense_api": ("breakdown", "r150.fa", ["4", "--impl", "pallas"]),
    "spectrum_k8": ("breakdown", "r1m.fa", ["8", "--mode", "spectrum"]),
    "spectrum_k15_hist": ("breakdown", "r1m.fa",
                          ["15", "--mode", "spectrum", "--spectrum-format", "hist"]),
    "sparse_k31_canonical": ("breakdown", "r152.fa",
                             ["31", "--canonical", "--mode", "sparse"]),
    "k8_nonzero_stream": ("stream", "r150.fa", ["8", "--nonzero"]),
    "k8_packed_stream": ("stream", "r150_half.fa", ["8", "--nonzero", "--packed"]),
    "spectrum_k8_stream": ("stream", "r1m.fa", ["-k", "8", "--mode", "spectrum"]),
    "sparse_k31_canonical_stream": ("stream", "r152.fa",
                                    ["-k", "31", "--canonical", "--mode", "sparse"]),
    "spectrum_k15_stream": ("stream", "r1m.fa", ["-k", "15", "--mode", "spectrum",
                                                 "--spectrum-format", "hist"]),
}


def run_leg(tree: Path, leg: str, work: Path, timeout: float = 900) -> dict:
    """One leg in a fresh process run from ``tree``'s root."""
    kind, name, args = LEGS[leg]
    work = work.resolve()
    out = work / f"breakdown_{leg}.out"
    if kind == "breakdown":
        argv = ["-m", "cfrk_tpu_torch.tools.stage_breakdown", str(work / name),
                str(out), *args]
    elif args[0] == "-k":
        argv = ["-m", "cfrk_tpu_torch", str(work / name), *args, "-o", str(out),
                "--stream", "--stats"]
    else:
        argv = ["-m", "cfrk_tpu_torch", str(work / name), str(out), *args,
                "--stream", "--stats"]
    env = dict(os.environ, PYTHONPATH=str(tree.resolve()))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *argv], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=timeout,
                          check=False)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{leg} on {tree}: exit {proc.returncode}\n{proc.stderr[-2000:]}")
    text = proc.stdout if kind == "breakdown" else proc.stderr
    result = next(json.loads(line) for line in reversed(text.splitlines())
                  if line.startswith("{") and ("host_s" in line or "stages_s" in line))
    out.unlink(missing_ok=True)
    return {"tree": str(tree), "leg": leg, "process_wall_s": wall, "result": result}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", type=Path, required=True)
    ap.add_argument("--work", type=Path, default=Path("build/chip_smoke"))
    ap.add_argument("--legs", default=",".join(LEGS))
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    legs = args.legs.split(",")
    for leg in legs:
        if leg not in LEGS:
            ap.error(f"unknown leg {leg!r}; legs: {', '.join(LEGS)}")
    for tree in args.tree:
        for leg in legs:
            line = json.dumps(run_leg(tree, leg, args.work))
            print(line, flush=True)
            if args.out is not None:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
