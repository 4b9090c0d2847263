"""Command-line interface: per-read `.cfrk` rows and k-mer spectra on a
GPU.

The single-device modes of ``cfrk_tpu/cli.py``, in memory or streamed
with checkpoint and resume, with the reference binary's positional
contract (``cfrk <dataset.fasta>
<out.cfrk> <k> [nt] [chunkSize]``, reference ``src/main.cu:239-250``)::

    python -m cfrk_tpu_torch reads.fasta out.cfrk 8 --nonzero
    python -m cfrk_tpu_torch reads.fasta out.cfrk 8 --impl pallas [--nonzero]
    python -m cfrk_tpu_torch reads.fa -k 8 --mode spectrum [--impl auto] \
        [--spectrum-format cfrk|tsv|npy|hist] [--min-count N] [-o out]
    python -m cfrk_tpu_torch reads.fa -k 31 --canonical --mode sparse \
        [--spectrum-format tsv|hist] [--min-count N] [-o out]
    python -m cfrk_tpu_torch reads.fa out.cfrk 8 --nonzero --stream \
        [--checkpoint-every N] [--packed]
    python -m cfrk_tpu_torch reads.fa out.cfrk 8 --nonzero --resume
    python -m cfrk_tpu_torch reads.fa -k 8 --mode spectrum --stream -o out
    python -m cfrk_tpu_torch reads.fa -k 31 --canonical --mode sparse --stream \
        [--mem-budget-mb MB] [--resume] -o out

Each writes the same bytes as ``cfrk_tpu``'s CLI.  ``--device cuda``
(the default) runs the CUDA kernels and refuses to run without a
visible GPU; ``--device cpu`` runs the plain PyTorch route.  The JAX
package's other modes and flags are not ported yet: each exits with an
error that says so.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

__all__ = ["main", "build_parser"]

# Flags of cfrk_tpu's CLI this package does not serve yet.
_NOT_PORTED = (
    "--list-devices", "--out-dir", "--profile",
    "--max-parallel-tasks", "--retries",
    "--no-lazy-errors", "--provenance", "--devices", "--tp", "--seqpar",
    "--slack", "--distributed", "--config",
)
_FASTA_EXTS = (".fasta", ".fa", ".fna", ".fastq", ".fq")


def _not_ported(what: str) -> SystemExit:
    return SystemExit(f"{what} is not yet ported to cfrk_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    from .version import __version__

    p = argparse.ArgumentParser(
        prog="cfrk-tpu-torch",
        description="GPU k-mer counting (reference-compatible .cfrk output)",
        allow_abbrev=False,
    )
    p.add_argument(
        "--version", action="version", version=f"cfrk-tpu-torch {__version__}"
    )
    p.add_argument(
        "paths",
        nargs="*",
        help=(
            "FASTA/FASTQ file, optionally gzipped; reference-style trailing "
            "positionals <out.cfrk> <k> [nt] [chunkSize] are also accepted"
        ),
    )
    p.add_argument("-k", type=int, default=None, help="k-mer length")
    p.add_argument("-o", "--output", default=None, help="output path")
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


def _out_path(inp: str, mode: str) -> str:
    """Default output: the input's base name with the mode's suffix, in
    the cwd."""
    base = os.path.basename(inp)
    for ext in (".gz",) + _FASTA_EXTS:
        if base.endswith(ext):
            base = base[: -len(ext)]
    return base + {"perread": ".cfrk", "spectrum": ".spectrum",
                   "sparse": ".kmers.tsv"}[mode]


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


def _run_stream(args, inp: str, out: str, device) -> int:
    """``--stream``: the constant-memory drivers of pipeline/stream.py;
    returns the reads this run counted.  A spectrum's or sparse run's
    checkpoint survives until the real output exists, so a crash while
    it is written stays resumable."""
    from .pipeline.batch import auto_batch_size
    from .pipeline.count import _use_sorted_spectrum
    from .pipeline.stream import (
        stream_count_file,
        stream_sparse_spectrum_file,
        stream_spectrum_file,
    )
    from .runtime.checkpoint import cleanup_checkpoint
    from .runtime.metrics import pin_malloc_for_streaming

    if args.mode == "sparse" or (
        args.mode == "spectrum" and _use_sorted_spectrum(args.k, args.impl, device)
    ):
        # The host fold's large, short-lived arrays: keep glibc from
        # caching them (a setting for the whole process, which the CLI
        # owns; the drivers only trim at checkpoints).
        pin_malloc_for_streaming()
    common = dict(device=device, canonical=args.canonical,
                  batch_size=args.batch_size or auto_batch_size(),
                  resume=args.resume, min_qual=args.min_qual)
    try:
        if args.mode == "sparse":
            acc, _, m = stream_sparse_spectrum_file(
                inp, args.k, out_path=out, cleanup=False,
                checkpoint_every=args.checkpoint_every or 64,
                mem_budget_mb=args.mem_budget_mb, finalize="accumulator",
                **common,
            )
            # The merged chunks go straight into the writer: under a
            # budget the whole key set never exists in memory.
            _write_sparse_chunks(out, acc.iter_merged_chunks(), args.k,
                                 args.spectrum_format, args.min_count)
            cleanup_checkpoint(out)
        elif args.mode == "perread":
            m = stream_count_file(
                inp, out, args.k, checkpoint_every=args.checkpoint_every or 1,
                nonzero=args.nonzero, packed=args.packed, impl=args.impl,
                **common,
            )
        else:
            table, m = stream_spectrum_file(
                inp, args.k, out_path=out, cleanup=False,
                checkpoint_every=args.checkpoint_every or 16, impl=args.impl,
                **common,
            )
            _write_spectrum(out, table, args.spectrum_format, args.min_count)
            cleanup_checkpoint(out)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(str(e))
    if args.stats:
        print(m.json_line(), file=sys.stderr)
    return m.reads


def main(argv=None) -> int:
    parser = build_parser()
    args, unknown = parser.parse_known_args(argv)
    for tok in unknown:
        if tok.split("=", 1)[0] in _NOT_PORTED:
            raise _not_ported(tok.split("=", 1)[0])
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    if not args.paths:
        parser.error("the following arguments are required: paths")
    _split_reference_positionals(args)
    if len(args.inputs) > 1:
        raise _not_ported("a multi-file run")
    inp = args.inputs[0]
    if inp == "-":
        raise _not_ported("stdin input ('-')")
    if not os.path.exists(inp):
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
    if args.mode == "perread":
        if args.k > 8 and not args.nonzero:
            raise SystemExit(
                f"per-read k={args.k} > 8 requires --nonzero "
                "(dense 4**k rows would be gigabytes per read)"
            )
    if args.resume:
        args.stream = True
    device = _resolve_device(args.device)
    out = args.output or _out_path(inp, args.mode)
    big = os.path.getsize(inp)
    if big > 4 << 30 and not args.stream:
        print(
            f"cfrk-tpu-torch: note: {big / (1 << 30):.1f} GiB of input will "
            "be held in memory; --stream runs in constant memory "
            "with checkpoint/resume",
            file=sys.stderr,
        )
    from .pipeline import count

    common = dict(device=device, canonical=args.canonical,
                  batch_size=args.batch_size, max_len=args.max_len,
                  min_qual=args.min_qual)
    t0 = time.perf_counter()
    reads = None
    if args.stream:
        reads = _run_stream(args, inp, out, device)
    elif args.mode == "perread" and (
        (args.nonzero and args.k > 8) or args.impl == "auto"
    ):
        # Rows through the per-read sort + RLE whenever the kernel choice
        # is ours: pairs cross to the host instead of dense rows (the
        # same bytes either way).
        reads = count.count_file_sparse_rows(
            inp, out, args.k, nonzero=args.nonzero, **common
        )
    elif args.mode == "perread":
        reads = count.count_file_dense_rows(
            inp, out, args.k, impl=args.impl, nonzero=args.nonzero, **common
        )
    elif args.mode == "spectrum":
        table = count.spectrum_file(inp, args.k, impl=args.impl, **common)
        _write_spectrum(out, table, args.spectrum_format, args.min_count)
    else:
        keys, counts = count.sparse_spectrum_arrays(inp, args.k, **common)
        _write_sparse(out, keys, counts, args.k, args.spectrum_format,
                      args.min_count)
    if args.stats:
        print(
            json.dumps({
                "files": 1,
                "reads": reads,
                "k": args.k,
                "mode": args.mode,
                "wall_s": round(time.perf_counter() - t0, 3),
            }),
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
