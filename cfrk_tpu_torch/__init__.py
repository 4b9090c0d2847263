"""cfrk-tpu-torch: the PyTorch + CUDA port of cfrk_tpu.

The per-read ``.cfrk`` path of the JAX package, run on an NVIDIA GPU:
FASTA in, per-read k-mer rows out, byte-identical to ``cfrk_tpu``.  The
per-read sort + run-length encode runs in hand-written CUDA kernels
(``ops/cuda/rowsort.py``, sources in ``csrc/``, built with ``nvcc`` at
first use); on CPU tensors the same functions take their plain PyTorch
route, which is also the kernels' oracle.

The package imports torch and numpy only — never jax, never cfrk_tpu —
so it runs on a machine that has no JAX.  The host modules it shares
with the JAX package in spirit (FASTA parsing, batching, the `.cfrk`
formatter) are numpy copies.

CLI, compatible with the reference binary's positional form::

    python -m cfrk_tpu_torch reads.fasta out.cfrk 8 --nonzero
"""

from .version import __version__

__all__ = ["__version__"]
