"""Query spectrum outputs: stats, top-N, multiplicity histogram, lookup.

The port's copy of ``tools/query_spectrum.py`` over
``cfrk_tpu_torch.format.parse_cfrk`` and ``ops/sparse.decode_key`` (it
imports nothing of the JAX package); same output lines and exit codes.

The reference had no way to interrogate its outputs at all (its workflow
left raw .cfrk text, SURVEY §2#14); this closes the loop for the
spectrum/sparse modes the way `jellyfish stats/query` does for hash
dumps.  Works on every spectrum artifact the CLI writes:

  .npy               dense int table (index = k-mer code)
  .tsv               `index<TAB>count` rows (dense spectra, min-count filtered)
  .kmers.tsv[.gz]    `KMERSTRING<TAB>count` rows (sparse mode)
  .cfrk              single dense spectrum row (reference cell format)

Exit status: 1 if any queried k-mer is absent from the table (so shell
scripts can gate on presence), 0 otherwise.

Usage:
  python -m cfrk_tpu_torch.tools.query_spectrum spect.npy --stats
  python -m cfrk_tpu_torch.tools.query_spectrum spect.npy --top 10 --k 8
  python -m cfrk_tpu_torch.tools.query_spectrum out.kmers.tsv.gz ACGTACGTACGT ...
  python -m cfrk_tpu_torch.tools.query_spectrum spect.tsv --k 8 ACGTACGT
"""

from __future__ import annotations

import argparse
import gzip

import numpy as np

from ..format import parse_cfrk
from ..ops.sparse import decode_key

_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}


def encode_kmer(kmer: str) -> int:
    """Base string -> integer k-mer code (inverse of ops.sparse.decode_key)."""
    code = 0
    for ch in kmer.upper():
        if ch not in _CODE:
            raise SystemExit(f"invalid base {ch!r} in k-mer {kmer!r}")
        code = (code << 2) | _CODE[ch]
    return code


def _nonzero(dense: np.ndarray):
    keys = np.flatnonzero(dense).astype(np.uint64)
    return keys, np.asarray(dense)[keys].astype(np.int64), None


def load_table(path: str):
    """-> (keys uint64 sorted, counts int64, k_or_None).

    k is only known for .kmers.tsv inputs (from the string length);
    dense artifacts carry indices, decode with --k.
    """
    base = path[:-3] if path.endswith(".gz") else path
    opener = gzip.open if path.endswith(".gz") else open
    if base.endswith(".npy"):
        with opener(path, "rb") as f:
            return _nonzero(np.load(f))
    if base.endswith(".cfrk"):
        with opener(path, "rb") as f:
            rows = parse_cfrk(f.read())
        if rows.shape[0] != 1:
            raise SystemExit(
                f"{path}: expected one dense spectrum row, got {rows.shape[0]} "
                "(per-read .cfrk files are not spectra)"
            )
        return _nonzero(rows[0])
    if base.endswith(".tsv"):
        with opener(path, "rt") as f:
            first = f.readline()
        k = None
        if first and first.split("\t", 1)[0][:1].upper() in _CODE:
            k = len(first.split("\t", 1)[0])  # k-mer-string keyed
        keys, counts = [], []
        with opener(path, "rt") as f:
            for line in f:
                key, _, cnt = line.rstrip("\n").partition("\t")
                keys.append(encode_kmer(key) if k else int(key))
                counts.append(int(cnt))
        keys = np.asarray(keys, dtype=np.uint64)
        counts = np.asarray(counts, dtype=np.int64)
        order = np.argsort(keys)
        return keys[order], counts[order], k
    raise SystemExit(f"unrecognised spectrum artifact: {path}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("table", help="spectrum artifact (.npy/.tsv/.kmers.tsv[.gz]/.cfrk)")
    ap.add_argument("kmers", nargs="*", help="k-mer strings to look up")
    ap.add_argument("--stats", action="store_true",
                    help="print distinct/total/max-count summary")
    ap.add_argument("--top", type=int, default=0, metavar="N",
                    help="print the N most frequent k-mers")
    ap.add_argument("--hist", type=int, nargs="?", const=100, default=0,
                    metavar="MAX",
                    help="multiplicity histogram (jellyfish-histo style): "
                         "rows `c<TAB>#distinct k-mers seen c times` for "
                         "c = 1..MAX (default 100), last row aggregates "
                         ">= MAX")
    ap.add_argument("--k", type=int, default=None,
                    help="k (to decode indices of dense artifacts; "
                         "inferred for .kmers.tsv)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    keys, counts, k = load_table(args.table)
    k = args.k if args.k is not None else k
    if not (args.stats or args.top or args.hist or args.kmers):
        ap.error("nothing to do: pass --stats, --top N, --hist, and/or k-mers")

    def label(code) -> str:
        return decode_key(int(code), k) if k else str(int(code))

    if args.stats:
        print(f"distinct\t{len(keys)}")
        print(f"total\t{int(counts.sum())}")
        if len(keys):
            am = int(np.argmax(counts))
            print(f"max\t{int(counts[am])}\t{label(keys[am])}")
            print(f"unique\t{int((counts == 1).sum())}")

    if args.hist:
        # Multiplicity histogram (the GenomeScope/jellyfish-histo input):
        # how many DISTINCT k-mers occur exactly c times, c clipped at MAX.
        mx = max(1, args.hist)
        h = np.bincount(np.minimum(counts, mx).astype(np.int64), minlength=mx + 1)
        for c in range(1, mx):
            if h[c]:
                print(f"{c}\t{int(h[c])}")
        if h[mx]:
            print(f"{mx}+\t{int(h[mx])}")

    if args.top and len(keys):
        # partial-select then sort: top-N of a config-4-size table
        # must not sort all of it.
        n = min(args.top, len(keys))
        sel = np.argpartition(counts, len(counts) - n)[len(counts) - n:]
        sel = sel[np.argsort(counts[sel])[::-1]]
        for i in sel:
            print(f"{label(keys[i])}\t{int(counts[i])}")

    missing = 0
    for km in args.kmers:
        if k is not None and len(km) != k:
            raise SystemExit(f"k-mer {km!r} has length {len(km)}, table k={k}")
        code = np.uint64(encode_kmer(km))
        pos = int(np.searchsorted(keys, code))
        if pos < len(keys) and keys[pos] == code:
            print(f"{km}\t{int(counts[pos])}")
        else:
            print(f"{km}\t0")
            missing += 1
    # exit 1 when any queried k-mer is absent (the jellyfish-query-style
    # contract: scripts can gate on presence), 0 otherwise
    return 1 if missing else 0


if __name__ == "__main__":
    raise SystemExit(main())
