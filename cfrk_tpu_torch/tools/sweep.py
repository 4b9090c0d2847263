"""Sweep the compile-time constants of one CUDA source on a CUDA device.

    python cfrk_tpu_torch/tools/sweep.py TIMES SOURCE VARIANT [VARIANT ...] [-- ARGS ...]

TIMES is a timing tool of ``cfrk_tpu_torch/tools`` (``rowsort_times.py``,
``hist_times.py``), SOURCE a file of ``cfrk_tpu_torch/csrc`` and each
VARIANT a comma-separated list of ``NAME=value``, where NAME is a
``constexpr int NAME = ...;`` of SOURCE; ARGS go to TIMES.  For example::

    python cfrk_tpu_torch/tools/sweep.py rowsort_times.py rowsort.cu \\
        kLogKeys=2 kLogKeys=4 kRegThreads=128 kLogKeys=4,kRegThreads=128 \\
        -- --shapes main short70
    python cfrk_tpu_torch/tools/sweep.py hist_times.py spectrum.cu \\
        kGlobalThreads=128 kMaxSharedK=6 -- --ks 5 6 7 8

For each variant this tool copies the package to ``build/sweep/v<i>/``,
rewrites the constants in the copy's SOURCE, and runs TIMES on the copy
in a process of its own (each builds its own libraries).  It prints that
tool's JSON lines, each with the variant's name added.  The checkout's
own sources are the variant ``base`` and are timed first and last
(``base again``), so the spread of one card shows beside the
differences.
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
WORK = PKG.parent / "build" / "sweep"


def parse_variant(text: str) -> dict:
    """``"NAME=value,NAME=value"`` → {NAME: value}."""
    constants = {}
    for item in text.split(","):
        name, sep, value = item.partition("=")
        if not (name and sep and value.lstrip("-").isdigit()):
            raise argparse.ArgumentTypeError(f"not NAME=value: {item!r}")
        constants[name] = int(value)
    return constants


def make_variant(source: str, constants: dict, tag: str) -> Path:
    """A copy of the package whose ``csrc/<source>`` holds these
    constants; returns the directory to put on PYTHONPATH."""
    root = WORK / tag
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, root / PKG.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = root / PKG.name / "csrc" / source
    text = src.read_text()
    for name, value in constants.items():
        text, n = re.subn(rf"(constexpr int {name} = )-?\d+;", rf"\g<1>{value};", text)
        if n != 1:
            raise RuntimeError(f"{name} not found once in {src}")
    src.write_text(text)
    return root


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    passed = []
    if "--" in argv:
        i = argv.index("--")
        argv, passed = argv[:i], argv[i + 1:]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("times", help="a timing tool of cfrk_tpu_torch/tools, e.g. rowsort_times.py")
    ap.add_argument("source", help="a file of cfrk_tpu_torch/csrc, e.g. rowsort.cu")
    ap.add_argument("variants", nargs="+", type=parse_variant,
                    metavar="NAME=value[,NAME=value...]")
    args = ap.parse_args(argv)
    for path in (PKG / "tools" / args.times, PKG / "csrc" / args.source):
        if not path.is_file():
            ap.error(f"no file {path}")
    runs = [("base", {})]
    runs += [(",".join(f"{n}={v}" for n, v in c.items()), c) for c in args.variants]
    runs.append(("base again", {}))
    for i, (name, constants) in enumerate(runs):
        root = make_variant(args.source, constants, f"v{i}")
        proc = subprocess.run(
            [sys.executable, str(PKG / "tools" / args.times), *passed],
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
