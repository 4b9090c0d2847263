"""cfrk_tpu_torch imports without JAX, cfrk_tpu, nvcc or a GPU.

The GPU machine the port runs on has no JAX, so no module of the port
may import it (or cfrk_tpu, whose ``__init__`` imports jax).  Each check
runs in a fresh interpreter, since this test process has jax loaded.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_MODULES = [
    "cfrk_tpu_torch",
    "cfrk_tpu_torch.cli",
    "cfrk_tpu_torch.format",
    "cfrk_tpu_torch.io.fasta",
    "cfrk_tpu_torch.pipeline.batch",
    "cfrk_tpu_torch.pipeline.count",
    "cfrk_tpu_torch.ops.encode",
    "cfrk_tpu_torch.ops.sparse",
    "cfrk_tpu_torch.ops.perread_sparse",
    "cfrk_tpu_torch.ops.reference",
    "cfrk_tpu_torch.ops.cuda.build",
    "cfrk_tpu_torch.ops.cuda.rowsort",
    "cfrk_tpu_torch.ops.cuda.spectrum",
    "cfrk_tpu_torch.ops.cuda.perread",
    "cfrk_tpu_torch.ops.perread",
    "cfrk_tpu_torch.ops.spectrum",
    "cfrk_tpu_torch.tools.rowsort_probe",
    "cfrk_tpu_torch.tools.stage_breakdown",
]


def _run(code: str, env_extra=None) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    env.update(env_extra or {})
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def import_report():
    """One fresh interpreter imports every module in turn and records,
    after each, which jax and cfrk_tpu modules are loaded."""
    return _run(
        "import importlib, json, sys\n"
        "def loaded(pkg):\n"
        "    return sorted(m for m in sys.modules"
        " if m == pkg or m.startswith(pkg + '.'))\n"
        "out = {}\n"
        f"for name in {_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "    out[name] = {'jax': loaded('jax'), 'cfrk_tpu': loaded('cfrk_tpu')}\n"
        "print(json.dumps(out))\n"
    )


@pytest.mark.parametrize("module", _MODULES)
def test_module_imports_no_jax_no_cfrk_tpu(import_report, module):
    assert import_report[module] == {"jax": [], "cfrk_tpu": []}


def test_kernel_module_needs_no_nvcc_until_launch():
    """Importing the kernel module and running its CPU route builds
    nothing: the build happens at the first launch on a CUDA tensor."""
    got = _run(
        "import json, torch\n"
        "from cfrk_tpu_torch.ops.cuda import rowsort, spectrum, build\n"
        "c = torch.zeros((2, 40), dtype=torch.int8)\n"
        "rowsort.rowsort_rle(c, 8)\n"
        "rowsort.rowsort_rle_large(c, 31)\n"
        "spectrum.spectrum_hist(c, 8)\n"
        "print(json.dumps({'loaded': build.load_library.cache_info().currsize,"
        " 'launches': [rowsort.rowsort_rle.launches,"
        " rowsort.rowsort_rle_large.launches,"
        " spectrum.spectrum_hist.launches]}))\n",
        {"PATH": os.path.dirname(sys.executable)},
    )
    assert got == {"loaded": 0, "launches": [0, 0, 0]}


def test_wrapper_off_cpu_launches_or_raises():
    """A tensor that is not on the CPU never takes the plain route: off
    CUDA the wrapper raises instead of computing."""
    from cfrk_tpu_torch.ops.cuda.rowsort import rowsort_rle, rowsort_rle_large

    codes = torch.zeros((2, 40), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="needs CUDA"):
        rowsort_rle(codes, 8)
    with pytest.raises(ValueError, match="needs CUDA"):
        rowsort_rle_large(codes, 31)
    assert rowsort_rle.launches == 0 and rowsort_rle_large.launches == 0


def test_spectrum_wrapper_off_cpu_launches_or_raises():
    """The spectrum kernel's wrapper, like the rowsort ones, never takes
    its plain twin for a tensor that is not on the CPU; the dense op's
    ``pallas`` and ``auto`` routes reach the same wrapper."""
    from cfrk_tpu_torch.ops.cuda.spectrum import spectrum_hist
    from cfrk_tpu_torch.ops.spectrum import spectrum

    codes = torch.zeros((2, 40), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="needs CUDA"):
        spectrum_hist(codes, 8)
    with pytest.raises(ValueError, match="needs CUDA"):
        spectrum(codes, 5, impl="pallas")
    assert spectrum_hist.launches == 0


def test_perread_kernel_needs_no_nvcc_until_launch():
    """The per-read histogram kernel and the probe run their CPU routes
    without building anything."""
    got = _run(
        "import json, torch\n"
        "from cfrk_tpu_torch.ops.cuda import perread, rowsort, build\n"
        "c = torch.zeros((2, 40), dtype=torch.int8)\n"
        "perread.perread_hist(c, 8, packed='b4', checksum=True)\n"
        "rowsort.rowsort_probe(c, 8, 'full')\n"
        "print(json.dumps({'loaded': build.load_library.cache_info().currsize,"
        " 'launches': [perread.perread_hist.launches,"
        " rowsort.rowsort_probe.launches]}))\n",
        {"PATH": os.path.dirname(sys.executable)},
    )
    assert got == {"loaded": 0, "launches": [0, 0]}


def test_perread_wrapper_off_cpu_launches_or_raises():
    """The per-read histogram kernel's wrapper never takes its plain twin
    for a tensor that is not on the CPU; count_perread's ``pallas`` and
    the packed route of pipeline/count.py reach the same wrapper."""
    from cfrk_tpu_torch.ops.cuda.perread import perread_hist
    from cfrk_tpu_torch.ops.perread import count_perread

    codes = torch.zeros((2, 40), dtype=torch.int8, device="meta")
    for packed in (False, "fh", "b4"):
        with pytest.raises(ValueError, match="needs CUDA"):
            perread_hist(codes, 8, packed=packed, checksum=True)
    with pytest.raises(ValueError, match="needs CUDA"):
        count_perread(codes, 5, impl="pallas")
    assert perread_hist.launches == 0


def test_perread_slab_fits_shared_memory():
    """The kernel's shared-memory image of output words fits a block's
    shared memory three times an SM; the numpy model holds the source's
    constants; and at every k and emit a row is a whole number of
    images or an image a whole number of rows, in multiples of 16 bytes
    from k = 2 on (what a bulk copy takes)."""
    from cfrk_tpu_torch.ops.cuda import perread as P

    src = (ROOT / "cfrk_tpu_torch" / "csrc" / "perread.cu").read_text()
    image, tile, max_rows = (
        int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
        for name in ("kImageWords", "kTileWords", "kMaxTileRows"))
    assert (image, tile, max_rows) == (P.IMAGE_WORDS, P.TILE_WORDS, P.MAX_TILE_ROWS)
    assert 3 * (image * 4 + 1024) <= 227 * 1024
    for k in range(1, 9):
        for per in (1, 2, 4):
            row_words = 4**k // per
            chunk = min(row_words, image)
            rows = min(max(tile // row_words, 1), max_rows)
            assert row_words % chunk == 0 and rows * chunk <= image
            assert rows == 1 or chunk == row_words
            if k >= 2:
                assert rows * chunk * 4 % 16 == 0


def test_build_hash_covers_shared_headers(monkeypatch, tmp_path):
    """Editing a shared ``csrc/*.cuh`` header changes every library's
    build name, so no stale build survives the edit."""
    from cfrk_tpu_torch.ops.cuda import build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// kernel\n")
    (csrc / "h.cuh").write_text("// v1\n")
    seen = []

    def fake_run(cmd, **kw):
        seen.append(Path(cmd[cmd.index("-o") + 1]))
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", fake_run)
    first = build.build_libraries(["a"])["a"]
    assert build.build_library("a") == first and len(seen) == 1
    (csrc / "h.cuh").write_text("// v2\n")
    second = build.build_library("a")
    assert second != first and second.exists() and len(seen) == 2


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: the build raises a clear error (never a silent CPU run)."""
    from cfrk_tpu_torch.ops.cuda import build

    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has nvcc")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


def test_kernel_ceilings_fit_shared_memory():
    """The padded row of keys must fit one block's shared memory on the
    H100 (227 KB), uint32 keys for k <= 15 and uint64 keys above."""
    from cfrk_tpu_torch.ops.cuda.rowsort import rowsort_max_windows

    smem = 227 * 1024
    assert rowsort_max_windows(15) * 4 <= smem < rowsort_max_windows(15) * 8
    assert rowsort_max_windows(16) * 8 <= smem < rowsort_max_windows(16) * 16
    assert np.log2(rowsort_max_windows(8)).is_integer()
