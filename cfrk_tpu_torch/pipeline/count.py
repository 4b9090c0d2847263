"""End-to-end file counting: FASTA in → per-read `.cfrk` rows out.

The counterpart of the per-read driver of ``cfrk_tpu/pipeline/count.py``
(``count_file_sparse_rows``): parse → fixed-shape padded batches → the
per-read sort + RLE on the device → narrowed device→host copy → `.cfrk`
writer.  The other drivers of that module are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..format import CfrkWriter
from ..io.fasta import read_fasta_encoded
from ..ops.perread_sparse import count_perread_rows, narrow_for_fetch, pairs_to_host
from .batch import auto_batch_size, iter_batches, round_up

__all__ = ["count_file_sparse_rows"]


def _plan_shapes(reads: Sequence[np.ndarray], k: int, batch_size: int | None,
                 max_len: int | None) -> tuple[int, int | None]:
    """Batch size + pad length.  ``None`` pad length means per-batch
    geometric buckets (iter_batches): a lone long contig then widens
    only its own batch."""
    bs = min(batch_size or auto_batch_size(), max(len(reads), 1))
    if max_len is not None:
        return bs, max_len
    longest = max((len(r) for r in reads), default=1)
    if longest <= 512:
        # Uniform short reads: one shared batch shape.
        return bs, round_up(max(longest, k), 128)
    return bs, None


def count_file_sparse_rows(
    path,
    out_path,
    k: int,
    *,
    device: torch.device | str,
    canonical: bool = False,
    batch_size: int | None = None,
    max_len: int | None = None,
    min_qual: int = 0,
    nonzero: bool = True,
) -> int:
    """Per-read rows of a FASTA/FASTQ file, streamed straight to disk.

    ``nonzero=True`` writes the ``idx:count`` cells of each read (for
    k > 15 the idx is the combined code ``hi * 4**15 + lo``);
    ``nonzero=False`` (k <= 8 only) writes dense rows, densified on host
    from the same pairs.  The batches run on ``device``: a CUDA device
    goes through the CUDA kernels, the CPU through the plain route.
    Returns the number of reads written.
    """
    if not nonzero and k > 8:
        raise ValueError("dense rows require k <= 8")
    device = torch.device(device)
    reads = read_fasta_encoded(path, min_qual)
    n_written = 0
    with CfrkWriter(out_path) as w:
        if not reads:
            return 0
        bs, ml = _plan_shapes(reads, k, batch_size, max_len)
        for batch in iter_batches(reads, bs, ml):
            codes = torch.from_numpy(batch.codes).to(device)
            out = count_perread_rows(codes, k, canonical)
            idx, counts = pairs_to_host(narrow_for_fetch(out, k), batch.n_reads)
            if nonzero:
                w.write_pairs(idx, counts)
            else:
                w.write_pairs_dense(idx, counts, 4**k)
            n_written += batch.n_reads
    return n_written
