"""Reconstruct FASTA inputs from golden k=2 `.cfrk` files.

The port's copy of ``tools/reconstruct_fasta.py`` over
``cfrk_tpu_torch.format``, ``ops/reference`` and ``io/fasta`` (it
imports nothing of the JAX package).  It walks the trails in the same
order, so the FASTA bytes are the JAX tool's.

The reference repo's sample FASTAs were LFS-stripped from the mirror
(`.MISSING_LARGE_BLOBS`), but its golden outputs survive.  At k=2 each
golden row is a dimer histogram, i.e. a multigraph on the 4 bases where
each dimer x→y is a directed edge; any read with those dimer counts is an
Eulerian trail decomposition of that multigraph.  We rebuild, per row, a
minimal set of edge-disjoint trails (Hierholzer with virtual balancing
edges) and join trails with 'N' (windows spanning N are invalid and count
nothing, so the joined read reproduces the row exactly).

This gives deterministic synthetic inputs on which the k=2 output is
byte-identical to the reference goldens — the strongest correctness
anchor available without the original samples.

Usage:
    python -m cfrk_tpu_torch.tools.reconstruct_fasta GOLDEN.cfrk OUT.fasta[.gz]
"""

from __future__ import annotations

import argparse
import gzip
from pathlib import Path

import numpy as np

from ..format import parse_cfrk
from ..io.fasta import encode_seq
from ..ops.reference import count_perread_np

BASES = "ACGT"


def _eulerian_trails(counts16: np.ndarray) -> list[list[int]]:
    """Decompose a 4x4 dimer multigraph into a minimal set of trails.

    Returns trails as base-code sequences (each of length #edges+1).
    """
    mat = counts16.reshape(4, 4).astype(int)
    if mat.sum() == 0:
        return []
    # Undirected components over nodes that touch any edge.
    active = [v for v in range(4) if mat[v].sum() + mat[:, v].sum() > 0]
    parent = list(range(4))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a in range(4):
        for b in range(4):
            if mat[a, b]:
                parent[find(a)] = find(b)

    trails: list[list[int]] = []
    for comp_root in {find(v) for v in active}:
        nodes = [v for v in active if find(v) == comp_root]
        sub = np.zeros((4, 4), dtype=int)
        for a in nodes:
            sub[a] = mat[a]
        # Balance with virtual edges end→start; each virtual edge splits the
        # Eulerian circuit into one more trail.
        out_in = sub.sum(axis=1) - sub.sum(axis=0)
        starts = [v for v in range(4) for _ in range(max(out_in[v], 0))]
        ends = [v for v in range(4) for _ in range(max(-out_in[v], 0))]
        virtual: list[tuple[int, int]] = list(zip(ends, starts))
        # Multiset adjacency incl. virtual edges (marked).
        adj: list[list[tuple[int, bool]]] = [[] for _ in range(4)]
        for a in range(4):
            for b in range(4):
                adj[a].extend([(b, False)] * int(sub[a, b]))
        for e, s in virtual:
            adj[e].append((s, True))
        # Iterative Hierholzer with edge tracking: push (node, incoming-edge-
        # is-virtual); the reversed pop order is an Euler circuit whose
        # consecutive pairs consume exactly the recorded edges.
        root = starts[0] if starts else nodes[0]
        stack = [(root, False)]
        circuit: list[tuple[int, bool]] = []
        while stack:
            v, _ = stack[-1]
            if adj[v]:
                stack.append(adj[v].pop())
            else:
                circuit.append(stack.pop())
        circuit.reverse()  # list of (node, edge-into-node-was-virtual)
        # Split circuit at virtual edges → trails.
        cur_trail: list[int] = [circuit[0][0]]
        segs: list[list[int]] = []
        for node, via_virtual in circuit[1:]:
            if via_virtual:
                segs.append(cur_trail)
                cur_trail = [node]
            else:
                cur_trail.append(node)
        segs.append(cur_trail)
        # The circuit is cyclic (ends at root): the first and last linear
        # segments are halves of one trail split at the seam — glue them.
        if virtual and len(segs) > 1 and segs[0][0] == segs[-1][-1]:
            last = segs.pop()
            segs[0] = last + segs[0][1:]
        trails.extend(s for s in segs if len(s) >= 2)
    return trails


def row_to_read(counts16: np.ndarray) -> bytes:
    """One golden row → a read whose k=2 histogram equals the row."""
    trails = _eulerian_trails(counts16)
    if not trails:
        return b"A"
    return b"N".join("".join(BASES[c] for c in t).encode() for t in trails)


def reconstruct(golden_path: str, out_path: str, verify: bool = True) -> int:
    """Write the FASTA of ``golden_path``'s rows to ``out_path`` (gzipped
    for a ``.gz`` path); returns the number of reads.  ``verify`` counts
    the reads again with the numpy reference and raises on any row that
    differs from the golden's."""
    counts = parse_cfrk(Path(golden_path).read_bytes())
    if counts.shape[1] != 16:
        raise ValueError(f"reconstruction requires k=2 goldens, got "
                         f"{counts.shape[1]} cells a row")
    reads = [row_to_read(row) for row in counts]
    if verify:
        got = count_perread_np([encode_seq(r) for r in reads], 2)
        bad = np.nonzero((got != counts).any(axis=1))[0]
        if bad.size:
            raise RuntimeError(f"reconstruction mismatch on rows {bad[:10]}")
    opener = gzip.open if out_path.endswith(".gz") else open
    with opener(out_path, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b">read%d reconstructed-from-golden\n" % i)
            f.write(r + b"\n")
    return len(reads)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("golden", help="a k=2 .cfrk file")
    ap.add_argument("out", help="FASTA to write (.gz: gzipped)")
    args = ap.parse_args(argv)
    n = reconstruct(args.golden, args.out)
    print(f"reconstructed {n} reads -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
