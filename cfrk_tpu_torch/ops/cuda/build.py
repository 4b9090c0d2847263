"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface, so it compiles with
``nvcc`` alone, without PyTorch's headers, in seconds, into
``build/cfrk_tpu_torch/lib<name>-<hash>.so`` beside the package (the
hash covers the source, the shared ``csrc/*.cuh`` headers and the
flags, so an edited source or header rebuilds).  Nothing is built when
a module is imported: the first kernel launch builds, and
:func:`build_libraries` builds several sources at once, one ``nvcc``
each.  A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_library", "build_libraries", "load_library"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cfrk_tpu_torch"

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler=-fPIC",
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
        Path("/usr/local/cuda/bin/nvcc")
    ]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "cfrk_tpu_torch build from source at first use"
        )
    return found


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date build exists;
    returns the shared library's path.  The compiler's output (with
    ``-Xptxas=-v``: registers, shared memory and spills per kernel) is
    kept beside it as ``.log``."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}-{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build to a private name, then rename: concurrent first uses never
    # load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def build_libraries(names) -> dict:
    """Build several sources at once, one ``nvcc`` process each, all
    started together; returns {name: library path}.  The first failure
    raises once every build has ended."""
    names = list(names)
    with ThreadPoolExecutor(max(len(names), 1)) as pool:
        futures = {n: pool.submit(build_library, n) for n in names}
        return {n: f.result() for n, f in futures.items()}


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library once per
    process."""
    return ctypes.CDLL(str(build_library(name)))
