"""Sets of runs of one cell, each run a fresh process, and their spread.

    python3 benchmark/sets.py --workload <cell> --seeds 1,2,3,4,5,6 --sets 2 \
        [--seconds 10] [--trace 0] [--out sets.jsonl]

runs ``benchmark/run.py`` once a seed in each set (the same seeds in
every set, in order), then prints for each metric and set the median
and the spread: the distance between the first and third quartiles of
``statistics.quantiles(values, n=4)``, as a share of the median, with
and without the run farthest from the median.  Each run's last line
goes to ``--out``.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values) -> list:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def one_run(workload, seed, seconds, trace) -> dict:
    cmd = [sys.executable, "benchmark/run.py", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, check=False)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    err = proc.stderr.strip().splitlines()
    return {"seed": seed, "rc": proc.returncode, "wall_s": wall, "result": result,
            "stderr_tail": err[-6:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = []
    for s in range(args.sets):
        for seed in seeds:
            r = one_run(args.workload, seed, args.seconds, args.trace)
            r["set"] = s
            runs.append(r)
            print(json.dumps({k: r[k] for k in ("set", "seed", "rc", "wall_s")}
                             | {"correct": (r["result"] or {}).get("correct"),
                                "metrics": {m: v["value"] for m, v in
                                            ((r["result"] or {}).get("metrics") or {}).items()},
                                "stderr_tail": r["stderr_tail"] if r["rc"] else []}),
                  flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(dict(r, workload=args.workload)) + "\n")
    names = sorted({m for r in runs if r["result"] for m in r["result"]["metrics"]})
    for name in names:
        for s in range(args.sets):
            vals = [r["result"]["metrics"][name]["value"] for r in runs
                    if r["set"] == s and r["result"] and name in r["result"]["metrics"]]
            if len(vals) >= 3:
                print(json.dumps({"metric": name, "set": s, "n": len(vals),
                                  "median": statistics.median(vals), "spread": spread(vals),
                                  "spread_trimmed": spread(trimmed(vals))
                                  if len(vals) >= 4 else None}), flush=True)
    return 0 if all(r["rc"] == 0 and r["result"]["correct"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
