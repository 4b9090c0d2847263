"""cfrk-tpu-torch: the PyTorch + CUDA port of cfrk_tpu.

The per-read ``.cfrk`` path and the global spectra of the JAX package,
run on an NVIDIA GPU: FASTA in, per-read k-mer rows, a dense spectrum
(k <= 15) or a sparse one (k <= 31) out, byte-identical to
``cfrk_tpu``.  The per-read sort + run-length encode, the dense per-read
histograms and the dense spectrum histogram run in hand-written CUDA
kernels (``ops/cuda/``, sources in ``csrc/``, built with ``nvcc`` at
first use); on CPU tensors the same functions take their plain PyTorch
route, which is also the kernels' oracle.

The package imports torch and numpy only — never jax, never cfrk_tpu —
so it runs on a machine that has no JAX.  The host modules it shares
with the JAX package in spirit (FASTA parsing, batching, the `.cfrk`
formatter) are numpy copies.

CLI, compatible with the reference binary's positional form::

    python -m cfrk_tpu_torch reads.fasta out.cfrk 8 --nonzero
    python -m cfrk_tpu_torch reads.fasta out.cfrk 8 --impl pallas
    python -m cfrk_tpu_torch reads.fasta -k 8 --mode spectrum
    python -m cfrk_tpu_torch reads.fasta -k 31 --canonical --mode sparse
    python -m cfrk_tpu_torch reads.fasta out.cfrk 8 --nonzero --stream
    python -m cfrk_tpu_torch reads.fasta out.cfrk 8 --nonzero --resume
    python -m cfrk_tpu_torch reads.fasta -k 31 --canonical --mode sparse \
        --stream --mem-budget-mb 4096 -o out.kmers.tsv

The library exports every name of ``cfrk_tpu.__all__``: the FASTA
readers and encoder, the window index functions, the dense and sparse
per-read ops and the spectrum, the batching helpers, the file-level
counts (which take the ``device`` their batches run on), the streamed
counts with checkpoint and resume (``stream_sparse_spectrum_file`` with disk
spilling under a memory budget), the run metrics and checkpoint, and
the multi-file workflow.
"""

from .format import CfrkWriter, format_file_bytes, parse_cfrk
from .io.fasta import encode_seq, iter_fasta, read_fasta, read_fasta_encoded
from .ops.encode import window_components, window_indices
from .ops.perread import count_perread
from .ops.perread_sparse import count_perread_sparse
from .ops.spectrum import spectrum
from .pipeline.batch import ReadBatch, iter_batches, pad_reads
from .pipeline.count import (
    count_file,
    count_file_sparse_rows,
    sparse_spectrum_file,
    spectrum_file,
    write_cfrk,
)
from .pipeline.stream import (
    stream_count_file,
    stream_sparse_spectrum_file,
    stream_spectrum_file,
)
from .runtime import RunMetrics, StreamCheckpoint, run_workflow
from .version import __version__

__all__ = [
    "__version__",
    "CfrkWriter",
    "format_file_bytes",
    "parse_cfrk",
    "encode_seq",
    "iter_fasta",
    "read_fasta",
    "read_fasta_encoded",
    "window_components",
    "window_indices",
    "count_perread",
    "count_perread_sparse",
    "spectrum",
    "ReadBatch",
    "iter_batches",
    "pad_reads",
    "count_file",
    "count_file_sparse_rows",
    "sparse_spectrum_file",
    "spectrum_file",
    "write_cfrk",
    "stream_count_file",
    "stream_sparse_spectrum_file",
    "stream_spectrum_file",
    "RunMetrics",
    "StreamCheckpoint",
    "run_workflow",
]
