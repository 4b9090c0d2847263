"""The benchmark modules of cfrk_tpu_torch and the row-sort kernels'
``checksum`` against cfrk_tpu.

* ``rowsort_rle`` / ``rowsort_rle_large`` with ``checksum=True`` on the
  CPU (the plain twins): ``chk.sum()`` equals the sum of the JAX
  kernels' ``chk`` (``rowsort_rle_pallas(..., checksum=True,
  interpret=True)`` and ``_large``) on seeded batches with N codes and
  pad rows; the rows are those of ``checksum=False``.  The blocks are
  each package's own, so only the sums compare.
* ``python -m cfrk_tpu_torch.bench --cpu``, ``tools/bench_suite --cpu``
  and ``tools/bench_format``: the JAX tools' line keys and record names
  (``tests/test_tools.py``); the bench's checksums those of the plain
  twins on its inputs.
* ``io/fasta.peek_first_read_len`` against the JAX function on plain,
  gzip, BGZF, FASTQ, empty and missing inputs, and its call in the CLI.

Tolerance: exact.  The timed numbers of a CPU run are not checked.
"""

import contextlib
import gzip
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfrk_tpu.io.fasta import peek_first_read_len as jax_peek
from cfrk_tpu.ops.pallas.rowsort import rowsort_rle_pallas, rowsort_rle_pallas_large
from cfrk_tpu_torch.io.bgzf import write_bgzf
from cfrk_tpu_torch.io.fasta import peek_first_read_len
from cfrk_tpu_torch.ops.cuda import rowsort as R

ROOT = Path(__file__).resolve().parent.parent
JAX_BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "beats_dense_write_sol", "k8",
                  "k31"}


def _batch(seed: int, b: int, length: int) -> np.ndarray:
    """Seeded codes with N cells, a short read and two pad rows."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(b, length)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.03] = -1
    codes[1, 20:] = -1
    codes[-2:] = -1
    return codes


@pytest.mark.parametrize("k,canonical,length,b", [
    (8, False, 150, 37), (31, True, 152, 21), (15, False, 60, 9), (8, True, 40, 70),
    (16, False, 33, 3),
])
def test_checksum_sum_matches_jax_kernel(k, canonical, length, b):
    codes = _batch(k * 100 + b, b, length)
    jax_fn, fn = ((rowsort_rle_pallas, R.rowsort_rle) if k <= 15
                  else (rowsort_rle_pallas_large, R.rowsort_rle_large))
    want = jax_fn(jnp.asarray(codes), k, canonical=canonical, checksum=True, interpret=True)
    got = fn(torch.from_numpy(codes), k, canonical, checksum=True)
    assert int(got[-1].sum()) == int(np.asarray(want[-1]).sum())
    bare = fn(torch.from_numpy(codes), k, canonical)
    assert len(got) == len(bare) + 1
    for g, w in zip(got[:-1], bare):
        assert torch.equal(g, w)
    w = length - k + 1
    blocks = -(-b // R.checksum_rows_per_block(w, k, b))
    assert got[-1].shape == (blocks,) and got[-1].dtype == torch.int64


def test_checksum_blocks_follow_the_kernels_layout():
    """Reads a block of the CUDA launch (csrc/rowsort.cu ``launch``): 256
    threads of 8 keys (16 for uint32 rows of 256 keys and more, and any
    row above 2048), one block a row above 4096 keys; at k <= 8, rows
    just above a power of two P split, two reads on P / 8 threads, in
    batches of at least 512 such blocks."""
    layout = {(1, 12): 64, (32, 12): 64, (128, 12): 16, (143, 12): 16,
              (249, 12): 16, (122, 31): 16, (226, 31): 8, (2048, 31): 1,
              (2049, 31): 1, (4096, 12): 1, (4097, 12): 1, (32768, 12): 1,
              (1, 8): 64, (128, 8): 16, (143, 8): 32, (144, 7): 32, (160, 8): 32,
              (161, 8): 16, (249, 8): 16, (80, 8): 16, (320, 1): 16, (321, 8): 8,
              (4096, 8): 1}
    for (w, k), rows in layout.items():
        assert R.checksum_rows_per_block(w, k, 100_000) == rows, (w, k)
    small = {(143, 8, 7): 16, (143, 8, 16383): 16, (143, 8, 16384): 32,
             (160, 8, 16385): 32, (320, 1, 8191): 8, (320, 1, 8192): 16,
             (143, 12, 16384): 16}
    for (w, k, b), rows in small.items():
        assert R.checksum_rows_per_block(w, k, b) == rows, (w, k, b)


def test_checksum_counts_run_starts_of_each_block():
    """A block's entry: (count & 3) + (key & 3) over its run starts; reads
    past B add nothing."""
    codes = np.full((17, 12), -1, np.int8)
    codes[0, :10] = 0  # AAAAAAAAAA at k = 8: one run of 3, key 0
    codes[16, :8] = 3  # TTTTTTTT: one run of 1, key 4**8 - 1
    idx, cnt, chk = R.rowsort_rle(torch.from_numpy(codes), 8, checksum=True)
    assert chk.tolist() == [(3 & 3) + 0 + (1 & 3) + ((4**8 - 1) & 3)]


def _run(args, timeout=300) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    proc = subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def test_bench_cpu_prints_one_line_with_jax_keys():
    from cfrk_tpu_torch import bench

    lines = _run(["-m", "cfrk_tpu_torch.bench", "--cpu"]).stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert JAX_BENCH_KEYS <= set(line) and line["unit"] == "bases/s"
    assert line["device"]["platform"] == "cpu" and line["value"] > 0
    for case, k, length in (("k8", 8, 150), ("k31", 31, 152)):
        rec = line[case]
        assert {"step_ms", "bases_per_s", "vs_sort_sol"} <= set(rec)
        assert (rec["k"], rec["read_len"]) == (k, length)
        # The plain route leaves the card's shares null.
        assert rec["vs_sort_sol"] is None
        # The total: each step's checksum over the cycled inputs.
        xs = bench._inputs(rec["batch"], k, length, torch.device("cpu"))
        fn = R.rowsort_rle if k <= 15 else R.rowsort_rle_large
        want = sum(int(fn(xs[i % bench.DISTINCT], k, k > 15, checksum=True)[-1].sum())
                   for i in range(rec["steps"]))
        assert rec["checksum"] == want
    assert "vs_dense_sol" in line["k8"] and "vs_dense_sol" not in line["k31"]
    assert line["launches"] == dict.fromkeys(line["launches"], 0)


def test_bench_without_a_card_exits_non_zero():
    proc = subprocess.run([sys.executable, "-m", "cfrk_tpu_torch.bench"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert proc.stdout == ""


def _suite(argv) -> list:
    from cfrk_tpu_torch.tools import bench_suite

    bench_suite.RECORDS.clear()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bench_suite.main(argv) == 0
    return [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]


def test_bench_suite_cpu_golden_and_sparse():
    """The case of JAX's tests/test_tools.py::test_bench_suite_cpu_golden_only."""
    lines = _suite(["--cpu", "--reads", "64", "--only", "golden,sparse_k31"])
    assert [d["bench"] for d in lines] == ["golden_k2_exact", "sparse_k31_canonical"]
    assert lines[0]["byte_exact"] is True
    assert {"bench", "wall_s", "value", "unit", "checksum", "step_ms", "vs_sol",
            "sol_model"} <= set(lines[1])


def test_bench_suite_cpu_every_case_and_json_out(tmp_path):
    """Every case, in the JAX suite's order and names (k = 11 for the
    k = 15 cases off the card, as there), and the --json-out document."""
    out = tmp_path / "suite.json"
    lines = _suite(["--cpu", "--reads", "3", "--ingest-reads", "300", "--stream-reads",
                    "200", "--json-out", str(out)])
    assert [d["bench"] for d in lines] == [
        "golden_k2_exact", "perread_k8_dense", "perread_k8_rowsort", "perread_k8_short70",
        "contig_k8_32kb", "contig_k8_128kb", "spectrum_k11_dense", "spectrum_k8_pallas",
        "spectrum_k8_sort_device", "spectrum_k11_sort", "spectrum_k9_auto_e2e",
        "sparse_k31_canonical", "ingest_stream_batches", "stream_spectrum_k8",
        "stream_perread_k2_cfrk", "stream_perread_k8_nonzero"]
    doc = json.loads(out.read_text())
    assert doc["platform"] == "cpu" and doc["device"]["card"] is None
    assert doc["cases"] == lines and doc["steps"] == 512
    by = {d["bench"]: d for d in lines}
    assert by["ingest_stream_batches"]["reads"] == 300
    assert by["stream_perread_k8_nonzero"]["reads"] == 200
    assert by["spectrum_k9_auto_e2e"]["distinct_kmers"] > 0
    assert all(d["vs_sol"] is None for d in lines if "sol_model" in d)


def test_bench_suite_refuses_an_unknown_case():
    with pytest.raises(SystemExit):
        _suite(["--cpu", "--only", "golden,nope"])


def test_bench_format_prints_the_jax_shapes():
    from cfrk_tpu_torch.tools import bench_format

    before = os.environ.get("CFRK_FORMAT_THREADS")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bench_format.main() == 0
    shapes = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(shapes) == ["pairs_k8", "pairs64_k31", "dense_k2", "dense_pairs_k8"]
    assert all(r["mb_s"] > 0 and r["out_mb"] > 0 for r in shapes.values())
    # The emitted bytes do not depend on the route: the dense walk's rows
    # are 65536 cells each.
    assert shapes["dense_pairs_k8"]["out_mb"] > 512 * 65536 * 2 / 1e6
    assert os.environ.get("CFRK_FORMAT_THREADS") == before


@pytest.fixture(scope="module")
def peek_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("peek")
    fasta = b"\n>r0 first\nACGTAC\nGTN\n>r1\nAC\n"
    paths = {"plain": d / "a.fasta", "gzip": d / "a.fasta.gz", "bgzf": d / "b.fasta.gz",
             "fastq": d / "q.fastq", "empty": d / "e.fasta", "missing": d / "none.fasta",
             "headers_only": d / "h.fasta"}
    paths["plain"].write_bytes(fasta)
    paths["gzip"].write_bytes(gzip.compress(fasta))
    write_bgzf(paths["bgzf"], fasta * 50, block=40)
    paths["fastq"].write_bytes(b"@q0\nACGTACGTAAA\n+\nIIIIIIIIIII\n")
    paths["empty"].write_bytes(b"")
    paths["headers_only"].write_bytes(b">a\n>b\nACG\n")
    return {name: str(p) for name, p in paths.items()}


@pytest.mark.parametrize("kind", ["plain", "gzip", "bgzf", "fastq", "empty", "missing",
                                  "headers_only"])
def test_peek_first_read_len_matches_jax(peek_inputs, kind):
    path = peek_inputs[kind]
    want = {"plain": 9, "gzip": 9, "bgzf": 9, "fastq": 11, "empty": None, "missing": None,
            "headers_only": 0}[kind]
    assert peek_first_read_len(path) == jax_peek(path) == want


@pytest.mark.parametrize("first", ["plain", "stdin"])
def test_cli_sizes_its_batch_from_the_first_regular_input(monkeypatch, tmp_path,
                                                          peek_inputs, first):
    """The CLI hands ``auto_batch_size`` the first record's length of its
    first input, or None for a pipe, as cfrk_tpu's CLI does."""
    from cfrk_tpu_torch import cli
    from cfrk_tpu_torch.pipeline import batch

    monkeypatch.chdir(tmp_path)
    seen = []
    real = batch.auto_batch_size
    monkeypatch.setattr(batch, "auto_batch_size", lambda hint=None, backend=None: (
        seen.append(hint), real(hint, backend))[1])
    if first == "stdin":
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(
            Path(peek_inputs["plain"]).read_bytes())))
        argv = ["-", "-k", "2", "-o", "o.cfrk", "--device", "cpu"]
    else:
        argv = [peek_inputs["plain"], "o.cfrk", "2", "--device", "cpu"]
    assert cli.main(argv) == 0
    assert seen[0] == (None if first == "stdin" else 9)
    assert Path("o.cfrk").read_bytes().count(b"\n") == 1  # two reads
