"""Benchmark suite over the BASELINE.json configs (one JSON line each).

The port of ``tools/bench_suite.py``: its flags, case names and record
shape.  Device cases (steady state over ``--steps`` steps, each with a
``vs_sol`` fraction of its H100 bound from ``ops/roofline.py``, which
must not exceed 1 on the card):

- perread_k8          — ``perread_hist``, ``b4`` emit, with its checksum
- perread_k8_rowsort  — ``rowsort_rle`` with ``checksum=True`` (the route
                        of every per-read ``.cfrk``)
- perread_k8_short    — the same on 70 bp reads
- contig_k8_32kb      — ``count_perread_rows`` on 32 kb contigs (the
                        kernel's one-block-a-row network)
- contig_k8_128kb     — 128 kb contigs, past the kernel's ceiling: the
                        tiled route and its host merge
- spectrum_k15        — the scatter route (``index_add_`` twin) into a
                        running 4**15 table
- spectrum_k8_pallas  — ``spectrum_hist``
- spectrum_k8_sort / spectrum_k15_sort — the device side of the sorted
                        spectrum route: the row-sort kernels
- spectrum_k9_e2e     — the k = 9 sorted route end to end: the rows,
                        their fetch and ``DenseFoldAccumulator``'s fold
- sparse_k31          — ``rowsort_rle_large``, canonical, with its checksum

Host / end-to-end cases:

- golden  — ``count_reads`` + ``format_file_bytes`` on the smallest
            golden sample, its sha256 held to ``tests/data/goldens.json``
- ingest  — ``stream_batches`` over an on-disk synthetic FASTA
- stream / stream_spectrum — the streaming drivers, with
            ``RunMetrics.stages_s``

A device case's steps run the kernel's wrapper on ``DISTINCT``-cycled
seeded batches and add a scalar that depends on each step's output
(its checksum, or ``sum(counts & 3)``) to a total on the card, timed by
``bench.time_steps``: on the card a CUDA graph of ``GRAPH_STEPS`` steps
replayed between CUDA events, the total fetched after the last.  Eager loops between
CUDA events time the contig cases, whose steps take milliseconds, the
scatter route, whose step drops the invalid windows by a mask (a sync
with the host, which a graph cannot hold), and the two cases with host
work in a step (``contig_k8_128kb``'s merge, ``spectrum_k9_e2e``'s
fetch and fold), these two for ``HOST_STEPS`` steps.  ``--cpu`` runs the plain
route, 2 steps a device case and k = 11 for the k = 15 cases (a 4**15
table is 4.3 GB), and leaves ``vs_sol`` null: the bounds are the card's.

The batch is ``--reads`` or the port's ``auto_batch_size()`` (8192 for
every length until it is measured on the card); a contig case takes
``CONTIGS`` contigs, about the bases of one 8192-read batch.

    python -m cfrk_tpu_torch.tools.bench_suite [--reads N] [--read-len 150]
        [--cpu] [--ingest-reads N] [--stream-reads N] [--only a,b]
        [--steps 512] [--json-out GPU_BENCHSUITE.json]

``--json-out`` writes every record with the card record (name and power
limit) and the kernels' launch counts (a captured graph counts each
launch once).
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..format import format_file_bytes
from ..io.fasta import read_fasta_encoded
from ..ops.cuda.perread import perread_hist
from ..ops.cuda.rowsort import rowsort_rle, rowsort_rle_large
from ..ops.perread_sparse import count_perread_rows, narrow_for_fetch, valid_pair_prefix
from ..bench import time_steps
from ..ops.roofline import bases_per_s, perread_bound, scatter_sol, sort_sol
from ..ops.sparse import DenseFoldAccumulator
from ..ops.spectrum import spectrum
from ..pipeline.batch import auto_batch_size, len_bucket
from ..pipeline.count import count_reads
from . import card

__all__ = ["CASES", "RECORDS", "main"]

ROOT = Path(__file__).resolve().parents[2]
CASES = ("golden", "perread_k8", "perread_k8_rowsort", "perread_k8_short",
         "contig_k8_32kb", "contig_k8_128kb", "spectrum_k15", "spectrum_k8_pallas",
         "spectrum_k8_sort", "spectrum_k9_e2e", "spectrum_k15_sort", "sparse_k31",
         "ingest", "stream", "stream_spectrum")
DISTINCT = 4  # distinct input batches cycled through a case's steps
HOST_STEPS = 8
# Contigs a step: 64 of 32 kb and 16 of 128 kb, about the 2.1 M bases of
# an 8192-read batch in 256 columns.
CONTIGS = {32700: 64, 131041: 16}

RECORDS: list[dict] = []


def _emit(name: str, seconds: float, work: float, unit: str, extra=None) -> None:
    rec = {"bench": name, "wall_s": seconds,
           "value": work / seconds if seconds > 0 else 0.0, "unit": unit}
    if extra:
        rec.update(extra)
    RECORDS.append(rec)
    print(json.dumps(rec))
    sys.stdout.flush()


class _Suite:
    def __init__(self, args, device: torch.device):
        self.args, self.device = args, device
        self.on_card = device.type == "cuda"
        self.steps = args.steps if self.on_card else 2
        self.rng = np.random.default_rng(0)

    def batches(self, reads: int, read_len: int, *, first=None) -> torch.Tensor:
        """``DISTINCT`` seeded batches of random bases (``first`` the
        first one)."""
        rest = [self.rng.integers(0, 4, size=(reads, read_len)).astype(np.int8)
                for _ in range(DISTINCT - (first is not None))]
        return torch.from_numpy(np.stack(([first] if first is not None else []) + rest)).to(
            self.device)

    def device_case(self, name: str, step, xs: torch.Tensor, sol_bps: float,
                    sol_model: str, *, graph: bool = True, steps=None, extra=None,
                    finish=None, reset=None) -> None:
        reads, read_len = xs.shape[1], xs.shape[2]
        dt, chk, ran = time_steps(step, xs, steps or self.steps, graph=graph,
                                  finish=finish, reset=reset)
        bases = reads * read_len * ran
        rec = {"checksum": chk, "reads": reads, "steps": ran, "step_ms": dt / ran * 1e3,
               "vs_sol": bases / dt / sol_bps if self.on_card else None,
               "sol_model": sol_model}
        if self.on_card:
            assert rec["vs_sol"] <= 1.0, (
                f"{name}: {bases / dt:.6e} bases/s exceeds its bound {sol_bps:.6e}: "
                "a measurement bug")
            if ran < 512:
                rec["unquotable"] = True
        rec.update(extra or {})
        _emit(name, dt, bases, "bases/s", rec)


def _rowsort_step(k: int, canonical: bool = False):
    """The row-sort kernel with ``checksum=True``: its checksum."""
    fn = rowsort_rle if k <= 15 else rowsort_rle_large
    return lambda x: fn(x, k, canonical, checksum=True)[-1].sum()


def _synth_fasta(path: str, n_reads: int, read_len: int, seed: int = 0) -> int:
    """A synthetic FASTA of random reads, written in blocks; returns its
    bases."""
    block = 100_000
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    g = np.random.default_rng(seed)
    total = 0
    with open(path, "wb") as f:
        for start in range(0, n_reads, block):
            n = min(block, n_reads - start)
            seqs = lut[g.integers(0, 4, size=(n, read_len))]
            f.write(b"".join(b">r%d\n%s\n" % (start + i, seqs[i].tobytes())
                             for i in range(n)))
            total += n * read_len
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=None,
                    help="reads per device batch (default: auto_batch_size(), 8192)")
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--cpu", action="store_true",
                    help="the plain route on the CPU, 2 steps a device case")
    ap.add_argument("--ingest-reads", type=int, default=2_000_000,
                    help="reads in the on-disk ingest bench (10_000_000 = config 5)")
    ap.add_argument("--stream-reads", type=int, default=100_000,
                    help="reads through the full streaming driver bench")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of: " + ",".join(CASES))
    ap.add_argument("--steps", type=int, default=512,
                    help="steps a device case on the card (< 512 is tagged unquotable)")
    ap.add_argument("--json-out", default=None,
                    help="also write every record to FILE as one JSON document")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    if only and only - set(CASES):
        ap.error(f"unknown cases: {sorted(only - set(CASES))}")

    def want(name: str) -> bool:
        return only is None or name in only

    device = card.resolve_device("cpu" if args.cpu else "cuda")
    before = card.launches()
    suite = _Suite(args, device)
    explicit_reads = args.reads
    reads = args.reads or auto_batch_size(args.read_len)
    codes = suite.rng.integers(0, 4, size=(reads, args.read_len)).astype(np.int8)
    codes[suite.rng.random(codes.shape) < 0.01] = -1
    xs = suite.batches(reads, args.read_len, first=codes)
    on_card = suite.on_card

    # 1. golden: the whole path on the smallest golden sample, hash-checked.
    if want("golden"):
        data_dir = ROOT / "tests" / "data"
        manifest = json.loads((data_dir / "goldens.json").read_text())
        name, meta = min(manifest["files"].items(), key=lambda kv: kv[1]["n_reads"])
        t0 = time.perf_counter()
        golden = read_fasta_encoded(str(data_dir / name))
        out = format_file_bytes(count_reads(golden, manifest["k"], device=device))
        dt = time.perf_counter() - t0
        ok = hashlib.sha256(out).hexdigest() == meta["sha256"]
        _emit("golden_k2_exact", dt, sum(len(r) for r in golden), "bases/s",
              {"byte_exact": ok})
        assert ok, "golden mismatch!"

    # 2. dense per-read k = 8: perread_hist's "b4" emit and its checksum.
    if want("perread_k8"):
        suite.device_case(
            "perread_k8_dense",
            lambda x: perread_hist(x, 8, packed="b4", checksum=True)[1].sum(dtype=torch.int64),
            xs, bases_per_s(reads, args.read_len, perread_bound(reads, args.read_len, 8, "b4")),
            "perread_b4")

    # 2a. per-read k = 8 pairs through the row-sort kernel.
    if want("perread_k8_rowsort"):
        suite.device_case("perread_k8_rowsort", _rowsort_step(8), xs,
                          sort_sol(reads, args.read_len, 8), "sort")

    # 2b. short reads (70 bp).
    if want("perread_k8_short"):
        n_short = explicit_reads or auto_batch_size(70)
        suite.device_case("perread_k8_short70", _rowsort_step(8),
                          suite.batches(n_short, 70), sort_sol(n_short, 70, 8), "sort")

    # 2c-d. contigs: one block a row below the kernel's ceiling, the
    # tiled route (tiles on the card, merge on the host) above it.
    for case, clen in (("contig_k8_32kb", 32700), ("contig_k8_128kb", 131041)):
        if not want(case):
            continue
        n_contig = explicit_reads or CONTIGS[clen]
        tiled = clen - 8 + 1 > 32768
        suite.device_case(
            case, lambda x: (count_perread_rows(x, 8)[-1] & 3).sum(dtype=torch.int64),
            suite.batches(n_contig, clen), sort_sol(n_contig, clen, 8),
            "sort (tiled: host merge)" if tiled else "sort", graph=False,
            steps=min(suite.steps, HOST_STEPS) if tiled else None)

    # 3. dense spectrum at large k through the scatter route, into a
    #    running table.
    if want("spectrum_k15"):
        ks = 15 if on_card else 11
        table = torch.zeros(4**ks, dtype=torch.int32, device=device)

        def scatter_step(x):
            spectrum(x, ks, impl="scatter", out=table)

        suite.device_case(
            f"spectrum_k{ks}_dense", scatter_step, xs,
            scatter_sol(reads, args.read_len, ks), "spectrum", graph=False,
            # The table's total, the valid windows of every step (its
            # cells' low bits cancel: each batch adds 512 / 4 times).
            finish=lambda: table.sum(dtype=torch.int64), reset=table.zero_)
        del table

    # 3a. dense spectrum k = 8 through spectrum_hist (the auto route on
    #     the card for k <= 10), a fresh table a step.
    if want("spectrum_k8_pallas"):
        suite.device_case(
            "spectrum_k8_pallas",
            lambda x: (spectrum(x, 8, impl="pallas" if on_card else "scatter") & 3).sum(
                dtype=torch.int64),
            xs, scatter_sol(reads, args.read_len, 8), "spectrum")

    # 3b-c. the sorted spectrum route's device side.
    if want("spectrum_k8_sort"):
        suite.device_case("spectrum_k8_sort_device", _rowsort_step(8), xs,
                          sort_sol(reads, args.read_len, 8), "sort")
    if want("spectrum_k15_sort"):
        ks = 15 if on_card else 11
        suite.device_case(f"spectrum_k{ks}_sort", _rowsort_step(ks), xs,
                          sort_sol(reads, args.read_len, ks), "sort")

    # 3d. the k = 9 sorted route end to end: device rows, their fetch and
    #     the native fold, two batches in flight as in the drivers.
    if want("spectrum_k9_e2e"):
        _spectrum_k9_e2e(suite, xs, reads, args.read_len)

    # 4. canonical k = 31 per-read rows (config 4's core).
    if want("sparse_k31"):
        suite.device_case("sparse_k31_canonical", _rowsort_step(31, True), xs,
                          sort_sol(reads, args.read_len, 31, canonical=True),
                          "sort (uint64 keys)")

    _disk_cases(args, want, device)
    launches = card.launches_since(before)
    if args.json_out:
        record = card.device_record(device)
        doc = {
            "platform": record["platform"],
            "device_kind": record["device_kind"],
            "device": record,
            "timestamp": datetime.datetime.now(datetime.timezone.utc)
            .strftime("%Y-%m-%dT%H:%M:%SZ"),
            "reads": reads,
            "read_len": args.read_len,
            "steps": args.steps,
            "launches": launches,
            "cases": RECORDS,
        }
        Path(args.json_out).write_text(json.dumps(doc, indent=1) + "\n")
        print(f"# wrote {args.json_out} ({len(RECORDS)} cases)")
    return 0


def _spectrum_k9_e2e(suite: _Suite, xs: torch.Tensor, reads: int, read_len: int) -> None:
    ks, w = 9, read_len - 9 + 1
    on_card = suite.on_card

    def pairs_step(a):
        return valid_pair_prefix(narrow_for_fetch(count_perread_rows(a, ks), ks), w)

    # (a) the device side alone.
    dev_s, _, dev_steps = time_steps(_rowsort_step(ks), xs, suite.steps)
    dev_ms = dev_s / dev_steps * 1e3
    # (b) the driver's loop: dispatch, at most two batches pending, fetch, fold.
    n_loop = HOST_STEPS if on_card else 3
    acc = DenseFoldAccumulator(ks)

    def fetch(rows):  # as the drivers fetch: in the narrowed dtypes
        return [a.cpu().numpy() for a in rows]

    batch_bytes = sum(a.nbytes for a in fetch(pairs_step(xs[0])))
    t_fetch = t_fold = 0.0
    pending: list = []

    def drain():
        nonlocal t_fetch, t_fold
        t = time.perf_counter()
        arrs = fetch(pending.pop(0))
        t_fetch += time.perf_counter() - t
        t = time.perf_counter()
        acc.add_pairs(*arrs)
        t_fold += time.perf_counter() - t
        return arrs

    t0 = time.perf_counter()
    for i in range(n_loop):
        pending.append(pairs_step(xs[i % len(xs)]))
        if len(pending) > 2:
            arrs = drain()
    while pending:
        arrs = drain()
    wall = time.perf_counter() - t0
    # (c) the fold alone on the last batch, by threads (0 = all cores).
    fold_by_threads = {}
    for nt in (1, 2, 0):
        if nt:
            os.environ["CFRK_FOLD_THREADS"] = str(nt)
        else:
            os.environ.pop("CFRK_FOLD_THREADS", None)
        best = math.inf
        for _ in range(5):
            t = time.perf_counter()
            acc.add_pairs(*arrs)
            best = min(best, time.perf_counter() - t)
        fold_by_threads[nt or "all"] = best * 1e3
    fetch_ms = t_fetch / n_loop * 1e3
    fold_ms = fold_by_threads["all"]
    step_ms = max(dev_ms, fetch_ms, fold_ms)
    e2e = n_loop * reads * read_len / wall
    rec = {
        "e2e_this_host_bases_per_s": e2e,
        "fetch_ms_per_batch": fetch_ms,
        "fold_ms_per_batch": fold_ms,
        "fold_ms_by_threads": fold_by_threads,
        "device_step_ms": dev_ms,
        "fetched_mb_per_batch": batch_bytes / 1e6,
        "binding_term": ("fold" if step_ms == fold_ms
                         else "device" if step_ms == dev_ms else "fetch"),
        "distinct_kmers": int((acc.table > 0).sum()),
        # The whole route's rate on this host over the device sort bound.
        "vs_sol": e2e / sort_sol(reads, read_len, ks) if on_card else None,
        "sol_model": "sort (e2e: fetch and fold included)",
        "step_ms": step_ms,
    }
    if on_card:
        assert rec["vs_sol"] <= 1.0, f"spectrum_k9_auto_e2e: vs_sol {rec['vs_sol']} > 1"
        if dev_steps < 512:
            rec["unquotable"] = True
    _emit("spectrum_k9_auto_e2e", wall, n_loop * reads * read_len, "bases/s", rec)


def _disk_cases(args, want, device: torch.device) -> None:
    """The on-disk cases: ingest, the streamed spectrum and per-read runs,
    each over a synthetic FASTA of its own."""
    from ..pipeline.stream import stream_batches, stream_count_file, stream_spectrum_file
    from ..runtime.metrics import RunMetrics

    def stages(m) -> dict:
        return dict(sorted(m.stages.items()))

    if want("ingest"):
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "ingest.fasta")
            n_bases = _synth_fasta(path, args.ingest_reads, args.read_len)
            t0 = time.perf_counter()
            n = sum(b.n_reads for b in stream_batches(path, 8, 8192))
            dt = time.perf_counter() - t0
            assert n == args.ingest_reads
            _emit("ingest_stream_batches", dt, os.path.getsize(path), "bytes/s",
                  {"reads": n, "mbases_per_s": n_bases / dt / 1e6})

    dummy = torch.zeros((8192, len_bucket(args.read_len)), dtype=torch.int8, device=device)
    if want("stream_spectrum"):
        ks = 8
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "spect.fasta")
            n_bases = _synth_fasta(path, args.stream_reads, args.read_len)
            # The kernel's build and first launch stay out of the timed run.
            t0 = time.perf_counter()
            int(spectrum(dummy, ks).sum())
            warm_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            table, m = stream_spectrum_file(path, ks, device=device, batch_size=8192,
                                            metrics=RunMetrics(k=ks, mode="spectrum"))
            dt = time.perf_counter() - t0
            _emit(f"stream_spectrum_k{ks}", dt, n_bases, "bases/s",
                  {"reads": m.reads, "distinct_kmers": int((np.asarray(table) > 0).sum()),
                   "warm_s": warm_s, "stages_s": stages(m)})

    if want("stream"):
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "stream.fasta")
            n_bases = _synth_fasta(path, args.stream_reads, args.read_len)
            for tag, ks, nz in (("stream_perread_k2_cfrk", 2, False),
                                ("stream_perread_k8_nonzero", 8, True)):
                # Both run the per-read rows (the drivers' auto route).
                t0 = time.perf_counter()
                int(count_perread_rows(dummy, ks)[-1].sum())
                warm_s = time.perf_counter() - t0
                out = os.path.join(td, f"out_{tag}.cfrk")
                t0 = time.perf_counter()
                m = stream_count_file(path, out, ks, device=device, batch_size=8192,
                                      nonzero=nz)
                dt = time.perf_counter() - t0
                _emit(tag, dt, n_bases, "bases/s",
                      {"reads": m.reads, "warm_s": warm_s, "stages_s": stages(m),
                       "out_bytes": os.path.getsize(out)})
                os.remove(out)


if __name__ == "__main__":
    sys.exit(main())
