"""Sweep the compile-time constants of the rowsort kernel on a CUDA device.

    python cfrk_tpu_torch/tools/rowsort_sweep.py [--shapes main short70 ...]

``csrc/rowsort.cu`` fixes the keys a thread holds (``kLogKeys``) and the
threads of a block (``kRegThreads``) of its register path.  This tool
copies the package to ``build/rowsort_sweep/<variant>/`` once for each
pair of values below, rewrites the two constants in the copy's source,
and runs ``tools/rowsort_times.py`` on the copy in a process of its own
(each builds its own library).  It prints that tool's JSON lines, each
with the variant's name added.  The checkout's own source is the variant
``log_keys=3 threads=256`` and is timed first and last, so the spread of
one card shows beside the differences.  ``kLogKeysWide`` and the rule
that sends uint32 rows of ``kWideFrom32`` keys and more to it stay as
they are: to time 8 keys a thread on those rows, raise ``kWideFrom32``
in the copy as well.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
WORK = PKG.parent / "build" / "rowsort_sweep"
VARIANTS = ((3, 256), (2, 256), (4, 256), (3, 128), (4, 128), (3, 256))


def make_variant(log_keys: int, threads: int, tag: str) -> Path:
    """A copy of the package whose rowsort.cu holds these constants;
    returns the directory to put on PYTHONPATH."""
    root = WORK / tag
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, root / PKG.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = root / PKG.name / "csrc" / "rowsort.cu"
    text = src.read_text()
    for name, value in (("kLogKeys", log_keys), ("kRegThreads", threads)):
        text, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", text)
        if n != 1:
            raise RuntimeError(f"{name} not found once in {src}")
    src.write_text(text)
    return root


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=["main", "short70"])
    args = ap.parse_args(argv)
    for i, (log_keys, threads) in enumerate(VARIANTS):
        name = f"log_keys={log_keys} threads={threads}"
        root = make_variant(log_keys, threads, f"v{i}")
        proc = subprocess.run(
            [sys.executable, str(PKG / "tools" / "rowsort_times.py"),
             "--shapes", *args.shapes],
            env={**os.environ, "PYTHONPATH": str(root)},
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            print(json.dumps({"variant": name, "failed": proc.stderr[-2000:]}), flush=True)
            continue
        for line in proc.stdout.splitlines():
            print(json.dumps({"variant": name, **json.loads(line)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
