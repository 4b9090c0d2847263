"""Merge per-shard outputs of a multi-file run into one file.

The port's copy of ``tools/merge_outputs.py`` over
``cfrk_tpu_torch.format`` (it imports nothing of the JAX package).

The Swift/K cluster workflow the reference shipped (swift/cfrk.swf:14-20,
SURVEY §2#12) produced one output per input shard and left combining
them to the user.  This tool closes that loop for every output mode:

  perread   .cfrk parts      -> byte-exact concatenation in shard order
                               (the reference's row framing: '\n' BEFORE
                               each subsequent row, no trailing newline)
  spectrum  .npy parts       -> elementwise sum -> .npy
  spectrum  .tsv parts       -> per-index sum   -> .tsv (index\tcount)
  spectrum  .cfrk parts      -> parse one dense row each, sum -> .cfrk
  sparse    .kmers.tsv parts -> streaming k-way merge summing counts
                               per k-mer (parts are sorted; O(1) memory,
                               so config-4-scale shards merge fine)

'hist' spectrum outputs are NOT mergeable (count-of-counts is not
additive across shards) — merge the tsv/npy tables, then re-derive.

Usage:
  python -m cfrk_tpu_torch.tools.merge_outputs --mode perread -o all.cfrk p0.cfrk ...
  python -m cfrk_tpu_torch.tools.merge_outputs --mode spectrum --format npy -o all.npy ...
  python -m cfrk_tpu_torch.tools.merge_outputs --mode sparse -o all.kmers.tsv ...
"""

from __future__ import annotations

import argparse
import gzip
import heapq
import itertools
import os
import shutil

import numpy as np

from ..format import CfrkWriter, format_file_bytes, parse_cfrk


def _open_in(path: str, mode: str = "rb"):
    """Transparent gzip: the CLI gzip-compresses outputs ending .gz."""
    return gzip.open(path, mode) if path.endswith(".gz") else open(path, mode)


def _open_out(path: str, mode: str = "wb"):
    return gzip.open(path, mode) if path.endswith(".gz") else open(path, mode)


def merge_perread(parts: list[str], out: str) -> None:
    # A 0-byte part is treated as a ZERO-READ shard.  Dense .cfrk rows
    # are never empty (all 4^k cells are printed), so this is only
    # ambiguous for a --nonzero part holding exactly one read with no
    # valid windows.
    with _open_out(out, "wb") as f:
        wrote_any = False
        for p in parts:
            with _open_in(p, "rb") as pf:
                head = pf.read(1)
                if not head:
                    continue
                if wrote_any:
                    f.write(b"\n")
                f.write(head)
                shutil.copyfileobj(pf, f, 1 << 20)
                wrote_any = True


def merge_spectrum(parts: list[str], out: str, fmt: str) -> None:
    total = None
    for p in parts:
        if fmt == "npy":
            with _open_in(p, "rb") as f_in:
                t = np.load(f_in).astype(np.int64)
        elif fmt == "tsv":
            t = None  # handled below (sparse indices)
            with _open_in(p, "rt") as f_in:
                pairs = np.loadtxt(f_in, dtype=np.int64, ndmin=2)
            if pairs.size:
                size = int(pairs[:, 0].max()) + 1
                t = np.zeros(size, dtype=np.int64)
                t[pairs[:, 0]] = pairs[:, 1]
            else:
                t = np.zeros(0, dtype=np.int64)
        elif fmt == "cfrk":
            with _open_in(p, "rb") as f_in:
                rows = parse_cfrk(f_in.read())
            if rows.shape[0] != 1:
                raise SystemExit(
                    f"{p}: spectrum .cfrk must hold exactly one dense row"
                )
            t = rows[0].astype(np.int64)
        else:
            raise SystemExit(
                f"spectrum format {fmt!r} is not mergeable "
                "(hist is not additive; merge tsv/npy then re-derive)"
            )
        if total is None:
            total = t
        elif len(t) != len(total):
            n = max(len(t), len(total))
            total = np.pad(total, (0, n - len(total)))
            total = total + np.pad(t, (0, n - len(t)))
        else:
            total = total + t
    if total is None:
        raise SystemExit("no parts given")
    if fmt == "npy":
        with _open_out(out, "wb") as f:
            np.save(f, total)
    elif fmt == "tsv":
        (nz,) = np.nonzero(total)
        with _open_out(out, "wt") as f:
            for i in nz:
                f.write(f"{i}\t{int(total[i])}\n")
    else:
        if total.max(initial=0) < 2**31:
            with CfrkWriter(out) as w:
                w.write_batch(total[None, :].astype(np.int32))
        else:
            # int64 fallback: keep the .gz transparency of the fast path
            with _open_out(out, "wb") as f:
                f.write(format_file_bytes(total[None, :]))


def _tsv_rows(path: str):
    with _open_in(path, "rt") as f:
        for line in f:
            kmer, _, cnt = line.rstrip("\n").partition("\t")
            yield kmer, int(cnt)


def merge_sparse(parts: list[str], out: str, min_count: int = 1) -> None:
    # Parts are sorted by k-mer (code order == lexicographic for equal
    # k), so a heap merge + groupby streams in O(#parts) memory.
    streams = [_tsv_rows(p) for p in parts]
    with _open_out(out, "wt") as f:
        merged = heapq.merge(*streams, key=lambda kv: kv[0])
        for kmer, group in itertools.groupby(merged, key=lambda kv: kv[0]):
            total = sum(cnt for _, cnt in group)
            if total >= min_count:
                f.write(f"{kmer}\t{total}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parts", nargs="+", help="shard outputs, in shard order")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument(
        "--mode", required=True, choices=["perread", "spectrum", "sparse"]
    )
    ap.add_argument(
        "--format", default=None,
        help="spectrum part format: npy|tsv|cfrk (default: from extension)",
    )
    ap.add_argument("--min-count", type=int, default=1)
    args = ap.parse_args(argv)
    for p in args.parts:
        if not os.path.exists(p):
            raise SystemExit(f"missing part: {p}")
    if args.mode == "perread":
        merge_perread(args.parts, args.output)
    elif args.mode == "spectrum":
        fmt = args.format
        if fmt is None:
            base = args.parts[0]
            if base.endswith(".gz"):
                base = base[:-3]
            ext = os.path.splitext(base)[1].lstrip(".")
            fmt = {"npy": "npy", "tsv": "tsv", "spectrum": "cfrk",
                   "cfrk": "cfrk"}.get(ext)
            if fmt is None:
                raise SystemExit(
                    f"cannot infer spectrum format from {args.parts[0]!r}; "
                    "pass --format npy|tsv|cfrk"
                )
        merge_spectrum(args.parts, args.output, fmt)
    else:
        merge_sparse(args.parts, args.output, args.min_count)
    print(f"merged {len(args.parts)} parts -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
