"""Build the package's C sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` (a CUDA kernel) and ``csrc/<name>.cpp`` (the
host library) exposes a plain C interface, so it compiles without
PyTorch's or Python's headers, in seconds, into
``build/cfrk_tpu_torch/lib<name>-<hash>.so`` beside the package (the
hash covers the source, for ``.cu`` the shared ``csrc/*.cuh`` headers,
and the flags, so an edited source or header rebuilds).  ``.cu`` sources
compile with ``nvcc``, ``.cpp`` ones with the host C++ compiler
(``$CXX``, else ``c++`` or ``g++``) and never with ``nvcc``.  Nothing is
built when a module is imported: the first call builds, and
:func:`build_libraries` builds several sources at once, one compiler
each.  A missing compiler, an unwritable build directory or a failed
build raises; nothing falls back to another route.

The kernel wrappers of ``ops/cuda`` share one seam: :func:`check_codes`
validates a code batch and :func:`launch_kernel` launches a kernel on
the current stream and counts the launch under ``cfrk.<kernel>.launches``
(``KERNELS`` names every kernel so counted).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ...runtime.metrics import count, launch, once_span

__all__ = ["NVCC_FLAGS", "CXX_FLAGS", "KERNELS", "build_library", "build_libraries",
           "check_codes", "host_compiler", "launch_kernel", "load_library", "once"]

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
# The JAX package's extension flags (setup.py) for a shared library.
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")


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


def host_compiler() -> str:
    """The host C++ compiler: ``$CXX``, else ``c++`` or ``g++`` on PATH."""
    cxx = os.environ.get("CXX")
    if cxx:
        return cxx
    for cand in ("c++", "g++"):
        found = shutil.which(cand)
        if found:
            return found
    raise RuntimeError(
        "no host C++ compiler found (set CXX): the host library of "
        "cfrk_tpu_torch builds from csrc/fastaio.cpp at first use"
    )


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (nvcc) or ``csrc/<name>.cpp`` (the host
    C++ compiler) unless an up-to-date build exists; returns the shared
    library's path.  The command, its seconds and the compiler's output
    (for nvcc with ``-Xptxas=-v``: registers, shared memory and spills
    per kernel) are kept beside it as ``.log``."""
    src = CSRC / f"{name}.cu"
    cuda = src.exists()
    if not cuda:
        src = CSRC / f"{name}.cpp"
    flags = NVCC_FLAGS if cuda else CXX_FLAGS
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")) if cuda else ():
        h.update(header.read_bytes())
    h.update("\0".join(flags).encode())
    digest = h.hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}-{digest}.so"
    if so.exists():
        return so
    with once_span(f"cfrk.library.build.{name}"):
        _compile(src, so, _nvcc() if cuda else host_compiler(), flags)
    return so


def _compile(src: Path, so: Path, compiler: str, flags) -> None:
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Build to a private name, then rename: concurrent first uses
        # never load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    except OSError as e:
        raise RuntimeError(
            f"cannot write the build directory {BUILD_DIR} for {src.name}: {e}"
        ) from e
    os.close(fd)
    cmd = [compiler, *flags, "-o", tmp, str(src)]
    try:
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        except OSError as e:
            raise RuntimeError(f"cannot run {compiler} to build {src}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"{compiler} failed to build {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        so.with_suffix(".log").write_text(
            f"{' '.join(cmd)}\n{time.perf_counter() - t0:.3f} s\n"
            f"{proc.stdout}{proc.stderr}"
        )
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_libraries(names) -> dict:
    """Build several sources at once, one compiler process each, all
    started together; returns {name: library path}.  The first failure
    raises once every build has ended."""
    names = list(names)
    with ThreadPoolExecutor(max(len(names), 1)) as pool:
        futures = {n: pool.submit(build_library, n) for n in names}
        return {n: f.result() for n, f in futures.items()}


def once(fn):
    """``functools.cache`` whose first call for given arguments runs
    once per process even when several threads make it together (the
    workflow's tasks reach a library first at the same moment): a lock
    per argument tuple holds the others until the result is cached.  A
    call that raises caches nothing, so the next call tries again."""
    cached = functools.cache(fn)
    locks: dict = {}
    guard = threading.Lock()

    @functools.wraps(fn)
    def call(*args):
        with guard:
            lock = locks.setdefault(args, threading.Lock())
        with lock:
            return cached(*args)

    call.cache_info = cached.cache_info
    call.cache_clear = cached.cache_clear
    return call


@once
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>``'s library once per
    process (span ``cfrk.library.load.<name>``, around the build's
    ``cfrk.library.build.<name>`` when the compiler runs)."""
    with once_span(f"cfrk.library.load.{name}"):
        return ctypes.CDLL(str(build_library(name)))


# Every kernel the wrappers launch, by the name of its launch counter.
KERNELS = ("rowsort_rle", "rowsort_rle_large", "spectrum_hist", "perread_hist",
           "rowsort_probe")


def check_codes(codes: torch.Tensor, k: int, k_lo: int | None, k_hi: int | None,
                ceiling: int | None = None) -> int:
    """Validate a kernel's code batch; returns W = L-k+1.

    Raises ValueError, in this order, for a tensor that is not ``[B, L]``
    int8, rows shorter than k, k outside ``[k_lo, k_hi]`` (``None``: the
    caller refuses k in its own words), a tensor on neither CUDA nor the
    CPU (where the plain twins run) and more than ``ceiling`` windows a
    row."""
    if codes.ndim != 2 or codes.dtype != torch.int8:
        raise ValueError(
            f"codes must be [B, L] int8, got {tuple(codes.shape)} {codes.dtype}")
    w = codes.shape[1] - k + 1
    if w <= 0:
        raise ValueError(f"read length {codes.shape[1]} < k={k}")
    if k_lo is not None and not k_lo <= k <= k_hi:
        raise ValueError(f"the kernel supports {k_lo} <= k <= {k_hi}, got k={k}")
    if codes.device.type not in ("cuda", "cpu"):
        raise ValueError(f"codes on {codes.device}: the kernel needs CUDA")
    if ceiling is not None and w > ceiling:
        raise ValueError(f"{w} windows/read exceeds the kernel ceiling {ceiling}")
    return w


def launch_kernel(kernel: str, fn, device: torch.device, *args) -> None:
    """``fn(*args, stream)``: one launch of ``kernel`` on ``device``'s
    current stream, inside the span of ``runtime.metrics.launch``.  A
    non-zero return (a CUDA error) raises RuntimeError; a launch that
    returns 0 counts one under ``cfrk.<kernel>.launches``."""
    with torch.cuda.device(device):
        err = launch(kernel, fn, *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cfrk_{kernel} launch failed: CUDA error {err}")
    count(f"cfrk.{kernel}.launches")
