"""Sweep the compile-time constants of the histogram kernels on a CUDA device.

    python cfrk_tpu_torch/tools/hist_sweep.py [--ks 5 6 7 8 9 10]

``csrc/spectrum.cu`` fixes the threads of a block (``kSharedThreads``,
``kGlobalThreads``) and the largest k whose table is private to a block
in shared memory (``kMaxSharedK``); ``csrc/perread.cu`` the threads of a block, the words
of the largest shared-memory image (``kImageWords``) and the words that
short rows share (``kTileWords``).  This tool copies the package to
``build/hist_sweep/<variant>/`` once for each set of values below,
rewrites the constants in the copy's sources, and runs
``tools/hist_times.py`` on the copy in a process of its own (each builds
its own libraries).  It prints that tool's JSON lines, each with the
variant's name added.  The checkout's own sources are the variant
``base`` and are timed first and last, so the spread of one card shows
beside the differences.
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
WORK = PKG.parent / "build" / "hist_sweep"
# name: {source: {constant: value}}
VARIANTS = {
    "base": {},
    "spectrum kSharedThreads=256": {"spectrum.cu": {"kSharedThreads": 256}},
    "spectrum kGlobalThreads=128": {"spectrum.cu": {"kGlobalThreads": 128}},
    "spectrum kGlobalThreads=512": {"spectrum.cu": {"kGlobalThreads": 512}},
    "spectrum kMaxSharedK=6": {"spectrum.cu": {"kMaxSharedK": 6}},
    "spectrum kMaxSharedK=4": {"spectrum.cu": {"kMaxSharedK": 4}},
    "perread kImageWords=8192": {"perread.cu": {"kImageWords": 8192}},
    "perread kThreads=128": {"perread.cu": {"kThreads": 128}},
    "perread kThreads=512": {"perread.cu": {"kThreads": 512}},
    "base again": {},
}


def make_variant(edits: dict, tag: str) -> Path:
    """A copy of the package whose sources hold these constants; returns
    the directory to put on PYTHONPATH."""
    root = WORK / tag
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, root / PKG.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for source, constants in edits.items():
        src = root / PKG.name / "csrc" / source
        text = src.read_text()
        for name, value in constants.items():
            text, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", text)
            if n != 1:
                raise RuntimeError(f"{name} not found once in {src}")
        src.write_text(text)
    return root


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ks", nargs="+", default=["5", "6", "7", "8", "9", "10"])
    args = ap.parse_args(argv)
    for i, (name, edits) in enumerate(VARIANTS.items()):
        root = make_variant(edits, f"v{i}")
        proc = subprocess.run(
            [sys.executable, str(PKG / "tools" / "hist_times.py"), "--ks", *args.ks],
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
