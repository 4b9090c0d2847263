"""Run the tier-1 suite under load, as ROADMAP.md's "Tier-1 verify" line
runs it, and say how each run ended and what the host looked like.

    python tests/tier1_under_load.py --out DIR [--taskset CPUS] TREE [TREE ...]

One run of the suite a checkout ``TREE``, all started at once (two
archives of one commit: two test runs of it on one host; an older tree
beside: the seed's suite), each with a HOME and a TMPDIR of its own under
``DIR``, pinned to ``CPUS`` with ``taskset`` if given.  While they run,
``/proc`` is read every second.  Prints one
JSON line a run (its return code; passes from its junit XML as the
verify line counts them; ``WORKERS_DOWN``, the ``node down`` /
``replacing crashed worker`` lines and the failed ids from its log;
seconds) and one line for the host: the least ``MemAvailable``, the
highest load, and, over the samples in which the ranks of
``tests/test_torch_distributed.py``'s byte-range launch ran, their most
threads and RSS, the RSS of the worker that started them (their
parent), and the largest RSS of any Python process.
"""

import argparse
import json
import os
import re
import subprocess
import threading
import time
import xml.etree.ElementTree as ET
from pathlib import Path

PYTEST = ["python", "-m", "pytest", "tests/", "-q", "-m", "not slow",
          "--continue-on-collection-errors", "-p", "no:cacheprovider", "-p", "xdist",
          "-n", "6", "--dist", "loadfile", "-p", "no:randomly"]
# The script of a rank of the byte-range launch (``_RANK``), in every tree.
RANK_MARK = b"rank, world, legs = int(sys.argv[1])"


def _python_processes() -> dict:
    """{pid: (rss MiB, parent pid, threads, is a rank)} of every Python process."""
    procs = {}
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            cmd = (entry / "cmdline").read_bytes()
            status = (entry / "status").read_text()
        except OSError:
            continue
        if b"python" not in cmd:
            continue
        field = dict(line.split(":", 1) for line in status.splitlines() if ":" in line)
        procs[int(entry.name)] = (int(field.get("VmRSS", "0 kB").split()[0]) // 1024,
                                  int(field["PPid"]), int(field["Threads"]), RANK_MARK in cmd)
    return procs


def _sample(stop: threading.Event, host: dict) -> None:
    while not stop.wait(1.0):
        avail = re.search(r"MemAvailable:\s*(\d+)", Path("/proc/meminfo").read_text())
        host["min_mem_available_mib"] = min(host.get("min_mem_available_mib", 1 << 40),
                                            int(avail.group(1)) // 1024)
        host["max_load"] = max(host.get("max_load", 0.0),
                               float(Path("/proc/loadavg").read_text().split()[0]))
        procs = _python_processes()
        ranks = [v for v in procs.values() if v[3]]
        if not ranks:
            continue
        workers = {v[1] for v in ranks}
        for key, value in (("rank_max_threads", max(v[2] for v in ranks)),
                           ("rank_max_rss_mib", max(v[0] for v in ranks)),
                           ("rank_parent_max_rss_mib",
                            max(procs.get(w, (0,))[0] for w in workers)),
                           ("python_max_rss_mib_beside_ranks",
                            max(v[0] for v in procs.values()))):
            host[key] = max(host.get(key, 0), value)


def _start(tree: Path, name: str, out: Path, taskset) -> tuple:
    home, tmp = out / name / "home", out / name / "tmp"
    home.mkdir(parents=True, exist_ok=True)
    tmp.mkdir(exist_ok=True)
    log, xml = out / f"{name}.log", out / f"{name}.xml"
    cmd = ["timeout", "-k", "10", "1470", "env", "JAX_PLATFORMS=cpu",
           "ALLOW_MULTIPLE_LIBTPU_LOAD=1", *PYTEST, f"--junitxml={xml}"]
    if taskset:
        cmd = ["taskset", "-c", taskset, *cmd]
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, cwd=tree, stdout=f, stderr=subprocess.STDOUT,
                                stdin=subprocess.DEVNULL,
                                env={**os.environ, "HOME": str(home), "TMPDIR": str(tmp)})
    return name, tree, proc, log, xml, time.monotonic()


def _outcome(name, tree, proc, log, xml, start, end) -> dict:
    rc = proc.wait()
    seconds = end - start
    text = log.read_text(errors="replace")
    passed, failed = None, []
    try:
        suite = ET.parse(xml).getroot().find("testsuite")
        passed = max(0, int(suite.get("tests")) - sum(
            int(suite.get(k)) for k in ("errors", "failures", "skipped")))
        failed = [f"{case.get('classname')}::{case.get('name')}"
                  for case in suite.iter("testcase")
                  if case.find("failure") is not None or case.find("error") is not None]
    except (OSError, ET.ParseError, AttributeError, TypeError):
        pass
    return {"run": name, "tree": str(tree), "rc": rc, "passed": passed,
            "workers_down": len(re.findall(r"\[gw\d+\] node down", text)),
            "down_lines": [line for line in text.splitlines()
                           if "node down" in line or "replacing crashed worker" in line],
            "failed": failed, "seconds": round(seconds, 1)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", type=Path, nargs="+")
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--taskset")
    args = parser.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    host, stop = {}, threading.Event()
    sampler = threading.Thread(target=_sample, args=(stop, host))
    sampler.start()
    runs = [_start(tree.resolve(), f"run{i}", args.out.resolve(), args.taskset)
            for i, tree in enumerate(args.trees)]
    ends = [None] * len(runs)
    try:
        while None in ends:
            for i, run in enumerate(runs):
                if ends[i] is None and run[2].poll() is not None:
                    ends[i] = time.monotonic()
            time.sleep(0.5)
        for run, end in zip(runs, ends):
            print(json.dumps(_outcome(*run, end)), flush=True)
    finally:
        stop.set()
        sampler.join()
    print(json.dumps({"host": host}), flush=True)


if __name__ == "__main__":
    main()
