"""Command-line interface: per-read `.cfrk` rows and k-mer spectra on a
GPU.

The single-device CLI of ``cfrk_tpu/cli.py``, in memory or streamed
with checkpoint and resume, with the reference binary's positional
contract (``cfrk <dataset.fasta> <out.cfrk> <k> [nt] [chunkSize]``,
reference ``src/main.cu:239-250``) and its Swift/K workflow layer (many
files per run, reference ``swift/cfrk.swf:14-20``)::

    python -m cfrk_tpu_torch reads.fasta out.cfrk 8 --nonzero
    python -m cfrk_tpu_torch reads.fasta out.cfrk 8 --impl pallas [--nonzero]
    python -m cfrk_tpu_torch reads.fa -k 8 --mode spectrum [--impl auto] \
        [--spectrum-format cfrk|tsv|npy|hist] [--min-count N] [-o out]
    python -m cfrk_tpu_torch reads.fa -k 31 --canonical --mode sparse \
        [--spectrum-format tsv|hist] [--min-count N] [-o out]
    python -m cfrk_tpu_torch reads.fa out.cfrk 8 --nonzero --stream \
        [--checkpoint-every N] [--packed]
    python -m cfrk_tpu_torch reads.fa out.cfrk 8 --nonzero --resume
    python -m cfrk_tpu_torch reads.fa -k 31 --canonical --mode sparse --stream \
        [--mem-budget-mb MB] [--resume] -o out
    python -m cfrk_tpu_torch a.fa b.fa c.fa -k 8 --nonzero --out-dir parts \
        [--max-parallel-tasks 2] [--retries 1] [--provenance prov.jsonl]
    zcat reads.fa.gz | python -m cfrk_tpu_torch - -k 8 -o out.cfrk
    python -m cfrk_tpu_torch reads.fa out.cfrk 8 --config site.json \
        [--profile trace_dir]
    python -m cfrk_tpu_torch --list-devices
    python -m cfrk_tpu_torch reads.fa -k 8 --mode spectrum --devices 4 --tp 2
    python -m cfrk_tpu_torch contigs.fa out.cfrk 5 --impl scatter --seqpar
    JAX_COORDINATOR_ADDRESS=host:port JAX_NUM_PROCESSES=N JAX_PROCESS_ID=i \
        python -m cfrk_tpu_torch reads.fa out.cfrk 8 --nonzero --distributed

Each writes the same bytes as ``cfrk_tpu``'s CLI.  ``--device cuda``
(the default) runs the CUDA kernels and refuses to run without a
visible GPU; ``--device cpu`` runs the plain PyTorch route.  A
``cfrk.json`` in the working directory supplies flag defaults, as in
``cfrk_tpu``.  As there, the run is one mesh over every visible device
of this process (``--devices N`` the first N, ``--devices 1`` one
device; ``--tp`` splits the spectrum's bins, ``--seqpar`` the positions,
``--slack`` sizes the sparse spectrum's bucket exchange; ``parallel/``).
``--distributed`` with one input splits it by record-aligned byte
ranges across the processes of a gloo group (one process a rank,
started with the JAX package's coordinator variables), and process 0
merges the parts; with several inputs each process runs the inputs dealt
to it round-robin.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

__all__ = ["main", "build_parser", "count_one_file"]

_FASTA_EXTS = (".fasta", ".fa", ".fna", ".fastq", ".fq")


def build_parser() -> argparse.ArgumentParser:
    from .version import __version__

    p = argparse.ArgumentParser(
        prog="cfrk-tpu-torch",
        description="GPU k-mer counting (reference-compatible .cfrk output)",
    )
    p.add_argument(
        "--version", action="version", version=f"cfrk-tpu-torch {__version__}"
    )
    p.add_argument(
        "--list-devices",
        action="store_true",
        help=(
            "print the visible CUDA devices and exit (the reference's "
            "DeviceInfo dump, src/main.cu:64-81)"
        ),
    )
    p.add_argument(
        "paths",
        nargs="*",
        help=(
            "FASTA/FASTQ file(s), optionally gzipped, or - for stdin; "
            "reference-style trailing positionals <out.cfrk> <k> [nt] "
            "[chunkSize] are also accepted"
        ),
    )
    p.add_argument("-k", type=int, default=None, help="k-mer length")
    p.add_argument("-o", "--output", default=None, help="output path (single input)")
    p.add_argument("--out-dir", default=None, help="output directory (many inputs)")
    p.add_argument(
        "--mode", choices=["perread", "spectrum", "sparse"], default="perread",
        help=(
            "per-read rows (.cfrk), one global dense spectrum (k <= 15), "
            "or a sparse distinct-kmer spectrum (any k <= 31)"
        ),
    )
    p.add_argument("--canonical", action="store_true", help="strand-neutral k-mers")
    p.add_argument(
        "--nonzero", action="store_true",
        help="per-read rows list only nonzero idx:count cells",
    )
    p.add_argument(
        "--impl", default="auto",
        choices=["auto", "compare", "matmul", "scatter", "pallas", "host", "sort"],
        help=(
            "kernel route (auto picks by device and k).  Per-read mode: auto "
            "= per-read sort + RLE rows; any other value runs the dense "
            "per-read API, where pallas is the CUDA per-read histogram "
            "kernel.  --mode spectrum: pallas is the CUDA histogram "
            "kernel; sort = per-read sort + RLE accumulation, auto for "
            "k >= 11 on CUDA.  On --device cpu pallas runs the kernels' "
            "plain twins"
        ),
    )
    p.add_argument(
        "--spectrum-format", choices=["cfrk", "tsv", "npy", "hist"],
        default="cfrk",
        help=(
            "spectrum output: cfrk = one dense row, tsv = index<TAB>count, "
            "npy = the int64 table, hist = count-of-counts.  --mode sparse "
            "writes hist, or KMER<TAB>count tsv for any other format"
        ),
    )
    p.add_argument(
        "--min-count", type=int, default=1, metavar="N",
        help="tsv outputs: drop k-mers with count < N",
    )
    p.add_argument(
        "--batch-size", type=int, default=None,
        help="reads per device batch (default 8192; chunkSize overrides it)",
    )
    p.add_argument("--max-len", type=int, default=None, help="pad reads to this length")
    p.add_argument(
        "--min-qual", type=int, default=0, metavar="Q",
        help="FASTQ: treat bases with Phred+33 quality < Q as N (0 = off)",
    )
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="cuda runs the CUDA kernels; cpu runs the plain PyTorch route",
    )
    p.add_argument("--stats", action="store_true", help="print a JSON stats line to stderr")
    p.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help=(
            "capture a torch.profiler trace of the run (host and CUDA "
            "activity) into DIR as a Chrome trace (the reference had no "
            "in-process tracing at all, SURVEY.md §5)"
        ),
    )
    p.add_argument(
        "--stream", action="store_true",
        help=(
            "constant-memory streaming driver with checkpoint/resume "
            "(for inputs too large to hold in memory)"
        ),
    )
    p.add_argument(
        "--resume", action="store_true",
        help="resume a checkpointed --stream run (implies --stream)",
    )
    p.add_argument(
        "--checkpoint-every", type=int, default=None, metavar="N",
        help=(
            "checkpoint every N batches in --stream mode (default: 1 for "
            "perread, 16 for spectrum, 64 for sparse; a spectrum or "
            "sparse checkpoint writes the whole accumulator, so they are "
            "rarer)"
        ),
    )
    p.add_argument(
        "--mem-budget-mb", type=int, default=None, metavar="MB",
        help=(
            "sparse --stream mode, k >= 11: cap host accumulator memory "
            "— merged (key, count) arrays beyond the budget spill to "
            "sorted on-disk runs next to the checkpoint and the final "
            "result is a bounded-memory multiway merge (byte-identical "
            "to the unbounded run).  The reference OOM-exited instead, "
            "src/kmer_main.cu:51-56"
        ),
    )
    p.add_argument(
        "--packed", action="store_true",
        help=(
            "stream mode, k<=8: the per-read histogram kernel's packed emit "
            "(1-2 bytes/bin of device-to-host traffic)"
        ),
    )
    p.add_argument(
        "--max-parallel-tasks",
        type=int,
        default=2,
        metavar="N",
        help=(
            "concurrent file tasks for multi-input runs "
            "(Swift/K maxParallelTasks analog; default 2 as in swift.conf)"
        ),
    )
    p.add_argument(
        "--retries",
        type=int,
        default=0,
        metavar="N",
        help="per-file retry count (Swift/K executionRetries analog)",
    )
    p.add_argument(
        "--no-lazy-errors",
        action="store_true",
        help="abort the whole run on the first file failure",
    )
    p.add_argument(
        "--provenance",
        default=None,
        metavar="PATH",
        help="append per-task JSONL provenance records (durations, errors)",
    )
    p.add_argument(
        "--devices",
        type=int,
        default=None,
        metavar="N",
        help=(
            "shard work over the first N visible devices as one mesh "
            "(default: all devices when more than one is visible; "
            "--devices 1 forces single-device).  Replaces the "
            "reference's per-process GPU fan-out, src/main.cu:281-289"
        ),
    )
    p.add_argument(
        "--tp",
        type=int,
        default=1,
        metavar="N",
        help=(
            "table-parallel degree for --mode spectrum: the 4**k table "
            "is reduce-scattered so each device sums 4**k/N bins "
            "(dp = devices/N)"
        ),
    )
    p.add_argument(
        "--seqpar",
        action="store_true",
        help=(
            "shard the POSITION axis over the devices (sequence "
            "parallelism for few very long contigs; halo exchange with "
            "the right neighbour).  The reference silently dropped bases "
            "past 1024 per read, src/kmer_kernel.cu:83-85"
        ),
    )
    p.add_argument(
        "--slack",
        type=float,
        default=2.0,
        metavar="X",
        help=(
            "sparse sharded mode: initial bucket-box capacity factor for "
            "the all_to_all exchange (auto-doubles on overflow)"
        ),
    )
    p.add_argument(
        "--distributed",
        action="store_true",
        help=(
            "start a torch.distributed (gloo) group from "
            "JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID; "
            "split one input by record-aligned byte ranges across its "
            "processes, or deal several inputs across them round-robin"
        ),
    )
    p.add_argument(
        "--config",
        default=None,
        metavar="PATH",
        help=(
            "JSON config supplying flag defaults (argv wins); cfrk.json "
            "in the cwd is auto-discovered — the swift.conf analog"
        ),
    )
    return p


def _looks_like_input(p: str) -> bool:
    """True for FASTA/FASTQ paths, optionally gzipped (a bare ``.gz``,
    such as ``out.cfrk.gz``, stays an output positional)."""
    if p.endswith(".gz"):
        p = p[:-3]
    return p.endswith(_FASTA_EXTS)


def _split_reference_positionals(args) -> None:
    """Split ``paths`` into inputs + reference-style trailing positionals
    ``<out> <k> [nt] [chunkSize]``.  The first path is always an input;
    later paths count as inputs while they look like FASTA/FASTQ."""
    paths = list(args.paths)
    args.inputs = [paths.pop(0)]
    while paths and _looks_like_input(paths[0]):
        args.inputs.append(paths.pop(0))
    if paths and args.output is None and not paths[0].isdigit():
        args.output = paths.pop(0)
    if paths and args.k is None:
        args.k = int(paths.pop(0))
    if paths:
        paths.pop(0)  # nt: host copy threads — obsolete, ignored
    if paths:
        args.batch_size = int(paths.pop(0))  # chunkSize
    if paths:
        raise SystemExit(f"unexpected extra positional arguments: {paths}")


def _out_path(inp: str, out_dir: str, mode: str) -> str:
    """Default output: the input's base name with the mode's suffix, in
    ``out_dir``."""
    base = os.path.basename(inp)
    for ext in (".gz",) + _FASTA_EXTS:
        if base.endswith(ext):
            base = base[: -len(ext)]
    suffix = {"perread": ".cfrk", "spectrum": ".spectrum", "sparse": ".kmers.tsv"}[mode]
    return os.path.join(out_dir, base + suffix)


def _open_out(path: str, mode: str):
    """Output opener; a ``.gz`` path is written gzip-compressed."""
    if str(path).endswith(".gz"):
        import gzip

        return gzip.open(path, mode)
    return open(path, mode)


def _write_hist(path: str, counts: np.ndarray) -> None:
    """Count-of-counts lines ``count<TAB>kmers``: how many distinct
    k-mers occur each number of times (np.unique, not a bincount: one
    k-mer seen 1e9 times must not allocate 1e9 bins)."""
    with _open_out(path, "wt") as f:
        if counts.size:
            vals, occ = np.unique(counts, return_counts=True)
            for c, n in zip(vals.tolist(), occ.tolist()):
                f.write(f"{c}\t{n}\n")


def _write_spectrum(path: str, table: np.ndarray, fmt: str,
                    min_count: int = 1) -> None:
    """Write a dense int64 spectrum in ``fmt``."""
    if fmt == "npy":
        # Through a handle, so np.save cannot append ".npy".
        with _open_out(path, "wb") as f:
            np.save(f, table)
    elif fmt == "tsv":
        from .format import format_spectrum_tsv_bytes

        with _open_out(path, "wb") as f:
            f.write(format_spectrum_tsv_bytes(table, min_count))
    elif fmt == "hist":
        _write_hist(path, table[table > 0])
    else:  # cfrk: one dense row; the digit writer takes int64 counts
        from .format import CfrkWriter

        with CfrkWriter(path) as w:
            w.write_batch(np.asarray(table)[None, :])


def _write_sparse(path: str, keys: np.ndarray, counts: np.ndarray, k: int,
                  fmt: str = "tsv", min_count: int = 1) -> None:
    """Write a key-sorted sparse spectrum (one chunk of
    :func:`_write_sparse_chunks`)."""
    _write_sparse_chunks(path, [(keys, counts)], k, fmt, min_count)


def _write_sparse_chunks(path: str, chunks, k: int, fmt: str = "tsv",
                         min_count: int = 1) -> None:
    """Write a sparse spectrum from ascending (keys, counts) chunks (an
    accumulator's ``iter_merged_chunks``), so that the whole key set
    never has to exist at once: ``hist`` (count-of-counts of the k-mers
    with count >= min_count, summed chunk by chunk: distinct abundance
    values are few even where distinct k-mers are billions), else
    ``KMER<TAB>count`` tsv through the host library's threaded
    formatter.  Any chunking writes the same bytes."""
    if fmt == "hist":
        occ: dict = {}
        for _, counts in chunks:
            counts = np.asarray(counts)
            vals, ns = np.unique(
                counts[counts >= max(min_count, 1)], return_counts=True
            )
            for c, n in zip(vals.tolist(), ns.tolist()):
                occ[c] = occ.get(c, 0) + n
        with _open_out(path, "wt") as f:
            for c in sorted(occ):
                f.write(f"{c}\t{occ[c]}\n")
        return
    from .io.native import format_kmer_tsv_bytes

    with _open_out(path, "wb") as f:
        for keys, counts in chunks:
            f.write(format_kmer_tsv_bytes(keys, counts, k, min_count))


def _resolve_device(name: str):
    import torch

    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda: no CUDA device is visible "
            "(torch.cuda.is_available() is False); --device cpu runs the "
            "plain PyTorch route"
        )
    return torch.device(name)




def count_one_file(inp: str, out: str, opts, device, resume: bool = False) -> tuple:
    """One input to one output: the per-file work of a single-input run
    and of every workflow task (``runtime/workflow.count_one_factory``).

    ``opts`` carries the CLI's per-file destinations (``k``, ``mode``,
    ``canonical``, ``impl``, ``batch_size``, ``max_len``, ``min_qual``,
    ``nonzero``, ``packed``, ``stream``, ``checkpoint_every``,
    ``mem_budget_mb``, ``spectrum_format``, ``min_count``, ``mesh``,
    ``seqpar``, ``slack``).  Returns the
    reads counted and the streamed run's ``RunMetrics`` (None in
    memory); as in ``cfrk_tpu``, an in-memory spectrum or sparse run
    reports 0 reads.  A streamed spectrum's or sparse run's checkpoint
    survives until the real output exists, so a crash while it is
    written stays resumable."""
    if opts.stream:
        return _count_streamed(inp, out, opts, device, resume)
    from .pipeline import count

    k = opts.k
    common = dict(device=device, canonical=opts.canonical,
                  batch_size=opts.batch_size, max_len=opts.max_len,
                  min_qual=opts.min_qual, mesh=opts.mesh)
    if opts.mode == "perread" and (
            (opts.nonzero and k > 8) or (opts.impl == "auto" and not opts.seqpar)):
        # Rows through the per-read sort + RLE whenever the kernel choice
        # is ours: pairs cross to the host instead of dense rows (the
        # same bytes either way).
        if opts.seqpar:
            raise ValueError(
                "seqpar does not compose with per-read k > 8 "
                "(per-row sort needs the whole row on one device)"
            )
        return count.count_file_sparse_rows(inp, out, k, nonzero=opts.nonzero,
                                            **common), None
    if opts.mode == "perread":
        return count.count_file_dense_rows(inp, out, k, impl=opts.impl,
                                           nonzero=opts.nonzero, seqpar=opts.seqpar,
                                           **common), None
    if opts.mode == "spectrum":
        table = count.spectrum_file(inp, k, impl=opts.impl, seqpar=opts.seqpar,
                                    **common)
        _write_spectrum(out, table, opts.spectrum_format, opts.min_count)
    else:
        keys, counts = count.sparse_spectrum_arrays(
            inp, k, slack=opts.slack, seqpar=opts.seqpar, **common)
        _write_sparse(out, keys, counts, k, opts.spectrum_format, opts.min_count)
    return 0, None


def _count_streamed(inp: str, out: str, opts, device, resume: bool) -> tuple:
    """``--stream``: the constant-memory drivers of pipeline/stream.py."""
    from .pipeline.batch import auto_batch_size
    from .pipeline.stream import (
        stream_count_file,
        stream_sparse_spectrum_file,
        stream_spectrum_file,
    )
    from .runtime.checkpoint import cleanup_checkpoint

    k = opts.k
    common = dict(device=device, canonical=opts.canonical,
                  batch_size=opts.batch_size or auto_batch_size(),
                  resume=resume, min_qual=opts.min_qual, mesh=opts.mesh,
                  seqpar=opts.seqpar)
    if opts.mode == "perread":
        m = stream_count_file(
            inp, out, k, checkpoint_every=opts.checkpoint_every or 1,
            nonzero=opts.nonzero, packed=opts.packed, impl=opts.impl, **common,
        )
        return m.reads, m
    if opts.mode == "sparse":
        acc, _, m = stream_sparse_spectrum_file(
            inp, k, out_path=out, cleanup=False,
            checkpoint_every=opts.checkpoint_every or 64, slack=opts.slack,
            mem_budget_mb=opts.mem_budget_mb, finalize="accumulator", **common,
        )
        # The merged chunks go straight into the writer: under a budget
        # the whole key set never exists in memory.
        _write_sparse_chunks(out, acc.iter_merged_chunks(), k,
                             opts.spectrum_format, opts.min_count)
    else:
        table, m = stream_spectrum_file(
            inp, k, out_path=out, cleanup=False,
            checkpoint_every=opts.checkpoint_every or 16, impl=opts.impl,
            **common,
        )
        _write_spectrum(out, table, opts.spectrum_format, opts.min_count)
    cleanup_checkpoint(out)
    return m.reads, m


def _list_devices() -> int:
    """``--list-devices``: one JSON line a CUDA device, with the keys of
    ``cfrk_tpu``'s lines; on a host without one, the CPU line that
    ``jax.devices()`` gives there."""
    import torch

    if not torch.cuda.is_available():
        print(json.dumps({"id": 0, "platform": "cpu", "kind": "cpu", "process": 0}))
        return 0
    for i in range(torch.cuda.device_count()):
        print(json.dumps({
            "id": i,
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(i),
            "process": 0,
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }))
    return 0


@contextlib.contextmanager
def _profiled(trace_dir: str, device):
    """``--profile DIR``: ``torch.profiler`` over the run, host activity
    and, on a CUDA device, the card's kernels and copies; the Chrome
    trace is written into ``trace_dir`` when the run ends, also when it
    fails."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        with prof:
            yield
    finally:
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"cfrk.{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def _stats_line(args, reads: int, wall_s: float, **extra) -> None:
    print(json.dumps({"files": len(args.inputs), **extra, "reads": reads,
                      "k": args.k, "mode": args.mode, "wall_s": round(wall_s, 3)}),
          file=sys.stderr)


def _run_inputs(args, device, t0: float) -> int:
    """One input: to ``-o``, else to its default name in ``--out-dir``
    (or the cwd).  A process of a ``--distributed`` run that was dealt
    one of several inputs writes it into ``--out-dir``; one dealt none
    writes nothing."""
    if not args.inputs:
        if args.stats:
            _stats_line(args, 0, time.perf_counter() - t0)
        return 0
    inp = args.inputs[0]
    out = args.output or _out_path(inp, args.out_dir or ".", args.mode)
    if args.dealt:
        out = _out_path(inp, args.out_dir, args.mode)
    if (args.seqpar and not args.stream and args.mode == "perread"
            and args.nonzero and args.k > 8):
        raise SystemExit(
            "--seqpar does not compose with per-read k > 8 "
            "(per-row sort needs the whole row on one device)"
        )
    if not args.stream and inp != "-":
        big = os.path.getsize(inp)
        if big > 4 << 30:
            print(
                f"cfrk-tpu-torch: note: {big / (1 << 30):.1f} GiB of input will "
                "be held in memory; --stream runs in constant memory "
                "with checkpoint/resume",
                file=sys.stderr,
            )
    try:
        reads, m = count_one_file(inp, out, args, device, resume=args.resume)
    except (ValueError, NotImplementedError) as e:
        if not args.stream:
            raise
        raise SystemExit(str(e))
    if args.stats:
        if m is not None:
            print(m.json_line(), file=sys.stderr)
        _stats_line(args, reads, time.perf_counter() - t0)
    return 0


def _run_workflow(args, device) -> int:
    """Many inputs: the Swift/K workflow layer's analog (reference
    ``swift/cfrk.swf:14-20``), one task a file into ``--out-dir``, with
    retries and provenance."""
    from .runtime.workflow import count_one_factory, run_workflow

    if args.mesh is not None and args.max_parallel_tasks > 1:
        # A mesh run already uses every device; two tasks interleaving
        # their launches and copies on the same devices buy nothing.
        print(
            "# mesh run: --max-parallel-tasks forced to 1 (concurrent "
            "collective programs on shared devices can deadlock)",
            file=sys.stderr,
        )
        args.max_parallel_tasks = 1
    pairs = [(inp, _out_path(inp, args.out_dir, args.mode)) for inp in args.inputs]
    result = run_workflow(
        pairs,
        count_one_factory(
            args.k, device=device, mode=args.mode, canonical=args.canonical,
            impl=args.impl, batch_size=args.batch_size, stream=args.stream,
            spectrum_format=args.spectrum_format, max_len=args.max_len,
            nonzero=args.nonzero, packed=args.packed, resume=args.resume,
            checkpoint_every=args.checkpoint_every, min_count=args.min_count,
            mem_budget_mb=args.mem_budget_mb, min_qual=args.min_qual,
            mesh=args.mesh, seqpar=args.seqpar, slack=args.slack,
        ),
        max_parallel_tasks=args.max_parallel_tasks,
        retries=args.retries,
        lazy_errors=not args.no_lazy_errors,
        provenance_path=args.provenance,
    )
    if args.stats:
        _stats_line(args, sum(t.reads for t in result.tasks), result.wall_s,
                    failed=len(result.failed))
    for t in result.failed:
        print(f"FAILED {t.input}: {t.error}", file=sys.stderr)
    return 0 if result.ok else 1


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.list_devices:
        return _list_devices()
    if not args.paths:
        parser.error("the following arguments are required: paths")
    # Positionals first: config-supplied defaults (e.g. "output") must
    # not change how reference-style trailing positionals are consumed.
    _split_reference_positionals(args)
    from .runtime.config import apply_config, explicit_dests, load_config

    apply_config(
        args, load_config(args.config), parser,
        explicit=explicit_dests(argv if argv is not None else sys.argv[1:], parser),
    )
    if "-" in args.inputs:
        # Pipe ingest: `zcat x.gz | cfrk-tpu-torch - -k 8 -o out.cfrk`.
        # One-shot stream: nothing to resume or derive a name from.
        if len(args.inputs) > 1:
            raise SystemExit("'-' (stdin) cannot mix with file inputs")
        if not args.output:
            raise SystemExit("stdin input needs an explicit -o/--output")
        if args.resume:
            raise SystemExit("cannot --resume from a pipe; use a file")
        if args.distributed:
            raise SystemExit(
                "--distributed needs file inputs (a pipe cannot be "
                "byte-range sharded)"
            )
    for inp in args.inputs:
        if inp != "-" and not os.path.exists(inp):
            raise SystemExit(f"input not found: {inp}")
    if args.k is None:
        raise SystemExit("k is required (positional or -k)")
    if not 1 <= args.k <= 31:
        raise SystemExit(f"k={args.k} out of range: 1 <= k <= 31")
    if args.mode == "spectrum" and args.k > 15:
        raise SystemExit(
            f"dense spectrum needs k <= 15 (4**{args.k} bins); "
            "use --mode sparse for larger k"
        )
    if args.impl == "sort" and args.mode != "spectrum":
        raise SystemExit(
            "--impl sort is the sorted-spectrum accumulation route; "
            "it only applies to --mode spectrum"
        )
    if (args.mode == "perread" and args.k > 8 and not args.nonzero
            and len(args.inputs) == 1):
        # Many inputs fail task by task instead (FAILED lines, exit 1),
        # as in cfrk_tpu.
        raise SystemExit(
            f"per-read k={args.k} > 8 requires --nonzero "
            "(dense 4**k rows would be gigabytes per read)"
        )
    if len(args.inputs) > 1 and not args.out_dir:
        raise SystemExit("multiple inputs require --out-dir")
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    if args.resume:
        args.stream = True
    device = _resolve_device(args.device)
    from .pipeline.batch import auto_batch_size

    with _process_group(args.distributed) as world:
        args.rank_card = _rank_card(device) if args.distributed else None
        if args.rank_card is not None:
            device = args.rank_card
        args.byte_ranged = args.dealt = False
        if args.distributed and len(args.inputs) > 1:
            # Several inputs: each process runs those dealt to it, with
            # no barrier; its mesh is its own devices.
            from .parallel.distributed import host_shard

            args.inputs = host_shard(args.inputs)
            args.dealt = True
        elif world > 1:
            # One input over several processes: each streams a byte range.
            _check_rangeable(args.inputs[0])
            args.stream = args.byte_ranged = True
        if args.batch_size is None:
            # Auto batch sizing: the first record's length of the first
            # regular input (a pipe cannot be peeked).
            from .io.fasta import is_stdin, peek_first_read_len

            hint = next((peek_first_read_len(inp) for inp in args.inputs
                         if not is_stdin(inp)), None)
            args.batch_size = auto_batch_size(hint)
        args.mesh = _build_mesh(args, device)
        if args.mesh is not None and not args.seqpar:
            # Row-sharded batches must divide across the devices; the
            # batches are padded to the full size anyway, so rounding up
            # changes the padding, not the output.
            bs = args.batch_size
            if bs % args.mesh.size:
                new = -(-bs // args.mesh.size) * args.mesh.size
                print(f"# batch size {bs} -> {new} "
                      f"(multiple of the {args.mesh.size}-device mesh)",
                      file=sys.stderr)
                args.batch_size = new
        return _run(args, device)


def _run(args, device) -> int:
    """The run itself, once the flags are settled."""
    from .pipeline.count import _use_sorted_spectrum

    if args.stream and (args.mode == "sparse" or (
            args.mode == "spectrum" and _use_sorted_spectrum(args.k, args.impl, device))):
        # The host fold's large, short-lived arrays: keep glibc from
        # caching them.  A setting for the whole process, so the CLI
        # makes it once, before any task starts; the drivers only trim
        # at checkpoints.
        from .runtime.metrics import pin_malloc_for_streaming

        pin_malloc_for_streaming()
    profile_cm = (_profiled(args.profile, device) if args.profile
                  else contextlib.nullcontext())
    t0 = time.perf_counter()
    with profile_cm:
        if args.byte_ranged:
            return _run_byte_ranged(args, device)
        if len(args.inputs) > 1:
            return _run_workflow(args, device)
        return _run_inputs(args, device, t0)


def _build_mesh(args, device):
    """``--devices`` / ``--tp`` / ``--seqpar`` → a mesh, or None for one
    device: ``cfrk_tpu``'s decisions and words over this process's
    devices of ``device``'s type (every CUDA device for ``--device
    cuda``, the one CPU for ``--device cpu``; ``parallel.mesh.
    local_devices``).  The default is every such device, so a host with
    several cards runs a mesh unless ``--devices 1`` is given.  Under
    ``--distributed`` the mesh is this process's devices only: the card
    of its local process id where SLURM or Open MPI gives one
    (``args.rank_card``)."""
    from .parallel import mesh as pmesh
    from .parallel.seqpar import make_seq_mesh

    devs = [args.rank_card] if args.rank_card is not None else pmesh.local_devices(device)
    n = args.devices if args.devices is not None else len(devs)
    if n > len(devs):
        raise SystemExit(
            f"--devices {n} but only {len(devs)} addressable (use --list-devices)"
        )
    if n <= 1 and args.tp == 1 and not args.seqpar:
        return None
    if args.seqpar:
        if args.tp > 1:
            raise SystemExit("--seqpar and --tp are mutually exclusive")
        return make_seq_mesh(devs[:n])
    if args.mode == "sparse" and args.tp > 1:
        raise SystemExit("--mode sparse shards keys over one axis; use --tp 1")
    if args.tp < 1:
        raise SystemExit(f"--tp {args.tp}: the table-parallel degree must be >= 1")
    try:
        return pmesh.make_mesh(devs[:n], tp=args.tp)
    except ValueError as e:
        raise SystemExit(str(e))


def _rank_card(device):
    """``--distributed`` under SLURM or Open MPI on ``--device cuda``: the
    card of this process's local id (``cuda:<local id>``, JAX's
    ``local_device_ids = [local_process_id]``); None elsewhere (no
    detected cluster, or the CPU)."""
    from .parallel.distributed import local_process_id

    local = local_process_id()
    if local is None or device.type != "cuda":
        return None
    import torch

    n = torch.cuda.device_count()
    if not 0 <= local < n:
        raise SystemExit(
            f"--distributed: this process's local id is {local}, but only {n} "
            "CUDA device(s) are visible; one process a card takes ids 0.."
            f"{n - 1} on each host"
        )
    return torch.device("cuda", local)


@contextlib.contextmanager
def _process_group(distributed: bool):
    """``--distributed``: the run's ``torch.distributed`` group, started
    from the coordinator variables or a SLURM / Open MPI job's
    (``parallel/distributed``); yields
    its world size (1 without the flag).  A group this run starts is
    joined by every process before any goes on (a barrier): a process
    that then ends at once, as every process does on a refused input,
    would otherwise close its connections while another is still
    connecting, and that one would fail with a broken connection in
    place of the refusal.  A group this run started is destroyed when
    the run ends, also when it fails: a failing rank then exits and
    frees its port, and the others' barriers fail instead of waiting on
    it."""
    if not distributed:
        yield 1
        return
    import torch.distributed as dist

    from .parallel.distributed import maybe_initialize_distributed

    owns = maybe_initialize_distributed(force=True)
    try:
        if owns:
            dist.barrier()  # cfrk-group-joined: every process is connected
        yield dist.get_world_size()
    finally:
        if owns:
            dist.destroy_process_group()


def _check_rangeable(inp: str) -> None:
    """A byte-ranged run needs record starts it can find from any
    offset: plain and BGZF FASTA.  Plain gzip and FASTQ are refused with
    the way out, never run at 1/N throughput on process 0."""
    if _sniff_fasta(inp):
        return
    try:
        with open(inp, "rb") as f:
            is_gz = f.read(2) == b"\x1f\x8b"
    except OSError as e:
        raise SystemExit(
            f"--distributed could not read {inp!r} to plan byte ranges: {e}"
        )
    if is_gz:
        why = (
            "plain (non-BGZF) gzip permits no random access, so byte-range "
            "sharding is impossible.  Recompress with bgzip (`python -m "
            "cfrk_tpu_torch.tools.make_synthetic --help`, "
            "cfrk_tpu_torch/tools/make_synthetic.py, shows the --bgzf "
            "writer; any htslib bgzip works) or pre-shard the file"
        )
    else:
        why = (
            "FASTQ record starts are ambiguous for byte-range sharding ('@' "
            "also begins quality lines).  Pre-shard the input into one file "
            "per host, or convert to FASTA/bgzf"
        )
    raise SystemExit(
        f"--distributed with a single input needs a byte-rangeable file, and "
        f"{inp!r} is not: {why}; or drop --distributed to run on one host"
    )


def _sniff_fasta(path) -> bool:
    """True when the (decompressed) first non-blank byte is '>' (FASTA:
    byte-range sharding needs unambiguous record starts; '@' quality
    lines make FASTQ ranges ambiguous).  BGZF-compressed FASTA sniffs
    through the block reader; plain gzip returns False (no random
    access for ranges anyway)."""
    try:
        with open(path, "rb") as f:
            head = f.read(256)
        if head[:2] == b"\x1f\x8b":
            from .io.bgzf import is_bgzf, open_maybe_bgzf

            if not is_bgzf(path):
                return False
            with open_maybe_bgzf(path) as bf:
                head = bf.read(256)
    except OSError:
        return False
    return head.lstrip(b"\r\n")[:1] == b">"


def _run_byte_ranged(args, device) -> int:
    """One input over the processes of the group: each streams its
    record-aligned byte range into ``<out>.part<rank>``; after a barrier
    process 0 merges the parts (splices per-read ``.cfrk`` rows, sums
    the dense spectrum tables, merges the sparse (keys, counts)) and
    removes them; a second barrier keeps every process alive until the
    merge is done.  A rank whose count raised never reaches a barrier:
    it exits, and the others' barriers fail."""
    import torch.distributed as dist

    from .parallel.distributed import host_byte_range
    from .runtime.checkpoint import cleanup_checkpoint

    inp = args.inputs[0]
    out = args.output or _out_path(inp, args.out_dir or ".", args.mode)
    rank, world = dist.get_rank(), dist.get_world_size()
    part = f"{out}.part{rank}"
    common = dict(device=device, canonical=args.canonical, batch_size=args.batch_size,
                  resume=args.resume, byte_range=host_byte_range(inp),
                  min_qual=args.min_qual, mesh=args.mesh, seqpar=args.seqpar)
    if args.mode == "perread":
        from .pipeline.stream import stream_count_file

        m = stream_count_file(
            inp, part, args.k, checkpoint_every=args.checkpoint_every or 1,
            nonzero=args.nonzero, packed=args.packed, impl=args.impl, **common,
        )
        # Row-count sidecar: part BYTES cannot tell "zero reads" from
        # "one read whose --nonzero row is empty" (both are 0 bytes).
        # total_reads, not reads: a resumed range that was already
        # complete counts 0 new reads, but its part holds every row.
        with open(part + ".nreads", "w") as f:
            f.write(str(m.total_reads))
    elif args.mode == "spectrum":
        from .pipeline.stream import stream_spectrum_file

        # cleanup=False: the checkpoint stays until the part exists.
        table, m = stream_spectrum_file(
            inp, args.k, out_path=part, cleanup=False, impl=args.impl,
            checkpoint_every=args.checkpoint_every or 16, **common,
        )
        with open(part, "wb") as f:
            np.save(f, table)
        cleanup_checkpoint(part)
    else:
        from .pipeline.stream import stream_sparse_spectrum_file

        keys, counts, m = stream_sparse_spectrum_file(
            inp, args.k, out_path=part, cleanup=False,
            checkpoint_every=args.checkpoint_every or 64, slack=args.slack,
            mem_budget_mb=args.mem_budget_mb, **common,
        )
        with open(part, "wb") as f:
            np.savez(f, keys=keys, counts=counts)
        cleanup_checkpoint(part)
    if args.stats:
        print(m.json_line(), file=sys.stderr)
    dist.barrier()  # cfrk-parts-written: every part exists
    if rank == 0:
        parts = [f"{out}.part{i}" for i in range(world)]
        if args.mode == "perread":
            _splice_perread_parts(parts, out)
        elif args.mode == "spectrum":
            total = None
            for p in parts:
                t = np.load(p)
                total = t if total is None else total + t
            _write_spectrum(out, total, args.spectrum_format, args.min_count)
        else:
            from .ops.sparse import merge_sorted_key_counts

            # Sparse keys repeat across ranges: a sorted merge that sums
            # them (each part is sorted and unique).
            pairs = []
            for p in parts:
                with np.load(p) as z:
                    pairs.append((z["keys"], z["counts"]))
            keys, counts = merge_sorted_key_counts(pairs)
            _write_sparse(out, keys, counts, args.k, args.spectrum_format,
                          args.min_count)
        for p in parts:
            os.remove(p)
            if args.mode == "perread":
                os.remove(p + ".nreads")
    dist.barrier()  # cfrk-parts-merged: nobody exits before the merge
    return 0


def _splice_perread_parts(parts, out: str) -> None:
    """Concatenate per-range ``.cfrk`` parts with the reference row
    framing ('\\n' BEFORE each later row, no trailing newline).

    Parts are skipped by their ``.nreads`` sidecar READ COUNT, never by
    size: a 0-byte part can be one read whose ``--nonzero`` row is
    empty, which must still contribute a row or every later row
    misaligns.  Chunked copy: parts are gigabytes at scale.
    """
    import shutil

    with _open_out(out, "wb") as f:
        wrote_any = False
        for p in parts:
            with open(p + ".nreads") as nf:
                if int(nf.read()) == 0:
                    continue
            with open(p, "rb") as pf:
                if wrote_any:
                    f.write(b"\n")
                shutil.copyfileobj(pf, f, 1 << 20)
                wrote_any = True


if __name__ == "__main__":
    sys.exit(main())
