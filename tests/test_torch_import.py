"""cfrk_tpu_torch imports without JAX, cfrk_tpu, nvcc or a GPU, and
carries the JAX package's library names.

The GPU machine the port runs on has no JAX, so no module of the port
may import it (or cfrk_tpu, whose ``__init__`` imports jax).  Each
import check runs in a fresh interpreter, since this test process has
jax loaded.  The library checks hold every public name of a ported
``cfrk_tpu`` module to the port (or to a named exception with its
reason), and the functions the port added for them to the JAX ones on
seeded batches, with exact equality.
"""

import importlib
import importlib.util
import io
import json
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfrk_tpu

ROOT = Path(__file__).resolve().parent.parent

_MODULES = [
    "cfrk_tpu_torch",
    "cfrk_tpu_torch.cli",
    "cfrk_tpu_torch.format",
    "cfrk_tpu_torch.io.fasta",
    "cfrk_tpu_torch.io.bgzf",
    "cfrk_tpu_torch.io.native",
    "cfrk_tpu_torch.runtime",
    "cfrk_tpu_torch.runtime.faults",
    "cfrk_tpu_torch.runtime.metrics",
    "cfrk_tpu_torch.runtime.checkpoint",
    "cfrk_tpu_torch.runtime.config",
    "cfrk_tpu_torch.runtime.workflow",
    "cfrk_tpu_torch.pipeline.batch",
    "cfrk_tpu_torch.pipeline.count",
    "cfrk_tpu_torch.pipeline.stream",
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
    "cfrk_tpu_torch.tools.merge_outputs",
    "cfrk_tpu_torch.tools.card",
    "cfrk_tpu_torch.tools.make_synthetic",
    "cfrk_tpu_torch.tools.query_spectrum",
    "cfrk_tpu_torch.tools.reconstruct_fasta",
    "cfrk_tpu_torch.tools.onchip_validate",
    "cfrk_tpu_torch.tools.onchip_fuzz",
    "cfrk_tpu_torch.tools.fuzz_cli",
    "cfrk_tpu_torch.tools.scale_demo",
    "cfrk_tpu_torch.tools.scaling_bench",
    "cfrk_tpu_torch.parallel",
    "cfrk_tpu_torch.parallel.distributed",
    "cfrk_tpu_torch.parallel.mesh",
    "cfrk_tpu_torch.parallel.sharded",
    "cfrk_tpu_torch.parallel.bucket",
    "cfrk_tpu_torch.parallel.seqpar",
    "cfrk_tpu_torch.ops.roofline",
    "cfrk_tpu_torch.bench",
    "cfrk_tpu_torch.tools.bench_suite",
    "cfrk_tpu_torch.tools.bench_format",
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


# ---------------------------------------------------------------- library names

# Public names of ported cfrk_tpu modules that the port does not carry,
# each with the reason.
_NAME_EXCEPTIONS = {
    **{f"cfrk_tpu.io.native.{flag}": "the fallback flags: the port has no fallback"
       for flag in ("HAVE_NATIVE", "HAVE_STREAM_NATIVE", "HAVE_PACK_NATIVE",
                    "HAVE_QUAL_NATIVE", "HAVE_FOLD_NATIVE", "HAVE_KMER_TSV_NATIVE")},
    "cfrk_tpu.ops.perread_sparse.rowsort_eligible":
        "the Mosaic VMEM cap; the port's ceiling is ops/cuda/rowsort.rowsort_max_windows",
    "cfrk_tpu.ops.perread_sparse.ROWSORT_MAX_WINDOWS":
        "the Mosaic VMEM cap; the port's ceiling is ops/cuda/rowsort.rowsort_max_windows",
    "cfrk_tpu.ops.sparse.batch_spectrum_triples":
        "in the port's ops/perread_sparse, beside the drain it runs",
    "cfrk_tpu.ops.sparse.rows_to_triples":
        "in the port's ops/perread_sparse, beside the drain it runs",
    # The TPU v5e's units, which an H100 has not: its bounds count bytes at
    # HBM_BW and integer operations at INT_OPS (ops/roofline.py).
    **{f"cfrk_tpu.ops.roofline.{name}": "a TPU v5e rate (MXU, VPU, cross-lane "
       "permutes, one-hot builds, serial scatter updates); the H100 bound has none"
       for name in ("INT8_MXU_OPS", "BF16_MXU_FLOPS", "VPU_ALU_OPS", "CROSS_LANE_OPS",
                    "ONEHOT_BUILD_ELEMS_PER_S", "SCALAR_UPDATES_PER_S")},
    **{f"cfrk_tpu.runtime{sub}.StageTimer": "nothing in the port read it; the port "
       "times its layers with runtime/metrics.span and RunMetrics.stage"
       for sub in ("", ".metrics")},
    "cfrk_tpu.ops.roofline.onehot_family_sol":
        "the floor of the TPU's compare-built one-hot kernels; the port's "
        "perread_hist builds no one-hot (its bound is ops/roofline.perread_bound)",
}

# cfrk_tpu modules with no module of the same path in the port.
_MODULE_EXCEPTIONS = {
    "cfrk_tpu.io.native._fastaio": "the JAX package's C extension; the port's "
                                   "host library is csrc/fastaio.cpp over ctypes",
    "cfrk_tpu.ops.pallas": "the Pallas kernels, ported as CUDA C++ under ops/cuda",
    "cfrk_tpu.ops.pallas.common": "Mosaic layout helpers, not to port",
    "cfrk_tpu.ops.pallas.perread": "ported as ops/cuda/perread.py (perread_hist)",
    "cfrk_tpu.ops.pallas.rowsort": "ported as ops/cuda/rowsort.py (rowsort_rle, "
                                   "rowsort_rle_large)",
    "cfrk_tpu.ops.pallas.spectrum": "ported as ops/cuda/spectrum.py (spectrum_hist)",
}


def _jax_modules() -> list:
    names = [m.name for m in pkgutil.walk_packages(cfrk_tpu.__path__, "cfrk_tpu.")]
    return ["cfrk_tpu"] + sorted(n for n in names if not n.endswith("__main__"))


@pytest.mark.parametrize("module", _jax_modules())
def test_every_public_name_is_ported_or_excepted(module):
    """Each cfrk_tpu module has a port of the same path, or a named
    exception; each name of a ported module's ``__all__`` exists in the
    port, or is a named exception."""
    port_name = "cfrk_tpu_torch" + module[len("cfrk_tpu"):]
    try:
        ported = importlib.util.find_spec(port_name) is not None
    except ModuleNotFoundError:  # its parent package is not ported either
        ported = False
    if not ported:
        assert module in _MODULE_EXCEPTIONS
        return
    assert module not in _MODULE_EXCEPTIONS
    port = importlib.import_module(port_name)
    for name in getattr(importlib.import_module(module), "__all__", []):
        excepted = f"{module}.{name}" in _NAME_EXCEPTIONS
        assert hasattr(port, name) != excepted, f"{module}.{name}"


def test_package_names_are_cfrk_tpus():
    import cfrk_tpu_torch

    assert sorted(cfrk_tpu_torch.__all__) == sorted(cfrk_tpu.__all__)


def _codes(seed, b=7, length=45):
    """Seeded codes with N (-1) cells, a padded tail, a poly-T row (a 16-T
    hi word equals the sentinel at k = 31) and a row shorter than k."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(b, length)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.04] = -1
    codes[:, length - 6:] = -1
    codes[0] = 3
    codes[1, 4:] = -1
    return codes


@pytest.mark.parametrize("k", [1, 8, 15])
def test_window_components_match_jax(k):
    from cfrk_tpu.ops import encode as jencode
    from cfrk_tpu_torch.ops import encode as tencode

    codes = _codes(k)
    want = jencode.window_components(jnp.asarray(codes), k)
    got = tencode.window_components(torch.from_numpy(codes), k)
    assert isinstance(got, tencode.WindowComponents)
    for field in ("hi", "lo", "rc_hi", "rc_lo", "valid"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    for g, w in zip(tencode.canonical_components(torch.from_numpy(codes), k),
                    jencode.canonical_components(jnp.asarray(codes), k)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_window_components_refusals_match_jax():
    from cfrk_tpu.ops import encode as jencode
    from cfrk_tpu_torch.ops import encode as tencode

    codes = _codes(0, length=12)
    for k, message in ((16, "supports k <= 15"), (13, "read length 12 < k=13"),
                       (0, "k must be >= 1")):
        for fn, arr in ((jencode.window_components, jnp.asarray(codes)),
                        (tencode.window_components, torch.from_numpy(codes))):
            with pytest.raises(ValueError, match=message):
                fn(arr, k)


@pytest.mark.parametrize("k", [1, 8, 15, 16, 31])
@pytest.mark.parametrize("canonical", [False, True])
def test_sparse_spectrum_matches_jax(k, canonical):
    from cfrk_tpu.ops import sparse as jsparse
    from cfrk_tpu_torch.ops import sparse as tsparse

    codes = _codes(100 + k)
    want = jsparse.sparse_spectrum(jnp.asarray(codes), k, canonical)
    got = tsparse.sparse_spectrum(torch.from_numpy(codes), k, canonical)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    assert got[2].dtype == torch.int32 and int(got[2].sum()) > 0


@pytest.mark.parametrize("shape", [(70, 16), (5, 256), (0, 4)], ids=["fast", "py", "empty"])
def test_format_rows_match_jax(shape):
    from cfrk_tpu import format as jfmt
    from cfrk_tpu_torch import format as tfmt

    counts = np.random.default_rng(shape[0]).integers(0, 400, size=shape)
    counts[counts < 300] = 0
    if shape[0]:
        counts[1] = 0  # a row with no k-mers
    assert tfmt.format_rows(counts) == jfmt.format_rows(counts)
    assert tfmt.format_rows_nonzero(counts) == jfmt.format_rows_nonzero(counts)


@pytest.mark.parametrize("fn", ["iter_fasta", "iter_reads"])
@pytest.mark.parametrize("source", ["path", "stream"])
def test_fasta_iterators_take_a_path_or_a_stream(tmp_path, fn, source):
    """As in cfrk_tpu: a path (gzip transparent) or an open stream,
    which is left open."""
    from cfrk_tpu.io import fasta as jfasta
    from cfrk_tpu_torch.io import fasta as tfasta

    data = b">a x\nACGT\nNNac\n\n>b\n>c\nGGT\n"
    path = tmp_path / "r.fa"
    path.write_bytes(data)
    fastq = tmp_path / "r.fq"
    fastq.write_bytes(b"@q\nACGTA\n+\nII#II\n")

    def run(mod, p):
        if source == "path":
            return list(getattr(mod, fn)(str(p)))
        stream = io.BufferedReader(io.BytesIO(p.read_bytes()))
        got = list(getattr(mod, fn)(stream))
        assert not stream.closed
        return got

    assert run(tfasta, path) == run(jfasta, path) == [
        (b"a x", b"ACGTNNac"), (b"b", b""), (b"c", b"GGT")]
    if fn == "iter_reads":
        assert run(tfasta, fastq) == run(jfasta, fastq) == [(b"q", b"ACGTA")]


def test_auto_batch_size_takes_the_jax_arguments():
    """The JAX signature; the read-length hint is not read until it is
    measured on the card (#9), so every length gets 8192, as cfrk_tpu
    gives off a TPU."""
    from cfrk_tpu.pipeline import batch as jbatch
    from cfrk_tpu_torch.pipeline import batch as tbatch

    for hint in (None, 150, 1 << 20):
        assert tbatch.auto_batch_size(hint) == 8192
        assert tbatch.auto_batch_size(hint, backend="gpu") == jbatch.auto_batch_size(
            hint, backend="gpu")
