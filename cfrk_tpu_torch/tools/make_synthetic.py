"""Generate synthetic metagenome-like FASTA/FASTQ for benchmarks and demos.

The port's copy of ``tools/make_synthetic.py`` over
``cfrk_tpu_torch.io.bgzf`` (it imports nothing of the JAX package).  It
keeps that tool's draw sequence, so the same seed and arguments give the
same bytes: plain FASTA and FASTQ and ``--bgzf`` byte-equal, ``--gzip``
equal once decompressed (a gzip header carries its mtime).

The reference was exercised on a 2.5 GB SRA metagenome split into shards
(reference ``swift/roda.sh:3``); that dataset is not redistributable, so
streaming-scale runs (BASELINE.json config 5) use synthetic read sets:
reads are sampled from a small set of random "genomes" with mutations
and a configurable N rate, which produces realistic repeated-k-mer
structure (unlike iid bases).

Usage:
    python -m cfrk_tpu_torch.tools.make_synthetic out.fasta --reads 1000000 \
        --read-len 150 [--genomes 8] [--n-rate 0.002] [--fastq] [--gzip|--bgzf]
"""

from __future__ import annotations

import argparse
import gzip
import io
import sys

import numpy as np

from ..io.bgzf import write_bgzf

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_FLUSH = 1 << 20  # record text buffered before it is cut into bgzf blocks


class _BgzfSink:
    """Buffer record text and emit whole bgzf blocks, 1 MiB at a time
    (the JAX tool's framing, so the bytes are the same)."""

    def __init__(self, path):
        self._f = open(path, "wb")
        self._buf = bytearray()

    def write(self, b: bytes) -> None:
        self._buf += b
        while len(self._buf) >= _FLUSH:
            head = bytes(self._buf[:_FLUSH])
            del self._buf[:_FLUSH]
            self._write_blocks(head, final=False)

    def _write_blocks(self, data: bytes, final: bool) -> None:
        sink = io.BytesIO()
        write_bgzf(sink, data)
        raw = sink.getvalue()
        if not final:
            raw = raw[:-28]  # strip the EOF marker between flushes
        self._f.write(raw)

    def __enter__(self) -> "_BgzfSink":
        return self

    def __exit__(self, *exc) -> None:
        try:
            if exc[0] is None:
                self._write_blocks(bytes(self._buf), final=True)
        finally:
            self._f.close()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out")
    ap.add_argument("--reads", type=int, default=100_000)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--genomes", type=int, default=8)
    ap.add_argument("--genome-len", type=int, default=100_000)
    ap.add_argument("--mut-rate", type=float, default=0.01)
    ap.add_argument("--n-rate", type=float, default=0.002)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fastq", action="store_true")
    ap.add_argument("--gzip", action="store_true")
    ap.add_argument(
        "--bgzf", action="store_true",
        help="blocked gzip (bgzip framing): the port inflates bgzf blocks "
             "in parallel, plain --gzip single-threaded",
    )
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.bgzf and args.gzip:
        raise SystemExit("--bgzf and --gzip are mutually exclusive")

    rng = np.random.default_rng(args.seed)
    genomes = [
        rng.integers(0, 4, size=args.genome_len).astype(np.uint8)
        for _ in range(args.genomes)
    ]
    if args.read_len > args.genome_len:
        raise SystemExit(
            f"--read-len {args.read_len} exceeds --genome-len "
            f"{args.genome_len}: reads are sampled as genome windows"
        )
    if args.bgzf:
        sink = _BgzfSink(args.out)
    elif args.gzip:
        sink = gzip.open(args.out, "wb")
    else:
        sink = open(args.out, "wb")
    chunk = 10_000
    written = 0
    random, integers, read_len = rng.random, rng.integers, args.read_len
    with sink as f:
        while written < args.reads:
            n = min(chunk, args.reads - written)
            gi = rng.integers(0, args.genomes, size=n)
            # +1: the final window genome[len-read_len:] is a valid start
            # (and read_len == genome_len must not raise).
            starts = rng.integers(0, args.genome_len - args.read_len + 1, size=n)
            lines = []
            for j, (g, s) in enumerate(zip(gi.tolist(), starts.tolist())):
                read = genomes[g][s : s + read_len].copy()
                mut = random(read_len) < args.mut_rate
                read[mut] = integers(0, 4, size=np.count_nonzero(mut))
                seq = BASES[read]
                if args.n_rate > 0:
                    seq[random(read_len) < args.n_rate] = ord("N")
                seq = seq.tobytes()
                rid = written + j
                if args.fastq:
                    lines.append(b"@r%d\n%s\n+\n%s\n" % (rid, seq, b"I" * len(seq)))
                else:
                    lines.append(b">r%d\n%s\n" % (rid, seq))
            f.write(b"".join(lines))
            written += n
    print(f"wrote {written} reads to {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
