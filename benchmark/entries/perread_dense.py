"""Entry: dense per-read k-mer histograms of read chunks held on the card.

The timed call is the program's dispatcher
``cfrk_tpu_torch.ops.perread.count_perread(chunk, k, canonical=...)``
on one ``[reads, read_len]`` int8 chunk already on the device: every
read's full ``[4**k]`` int32 row of counts, zeros included, the output of
the reference CFRK's ``kmer_main``, kept on the card as a library caller
keeps it.

The configuration gives ``k``, ``canonical``, ``read_len`` and the read
model; the traffic gives ``reads_per_call`` and ``distinct_inputs``
(chunks cycled in turn).  The check holds every cell of a sampled
call's matrix to ``references/perread_dense.py`` over the same codes.
"""

from __future__ import annotations

import importlib

import torch

from benchmark import reads
from benchmark.references import perread_dense as reference_dense

PROGRAM_MODULE = "cfrk_tpu_torch.ops.perread"
PROGRAM_CALL = "count_perread"


class Workload:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.k = config["k"]
        self.canonical = config["canonical"]
        self.read_len = config["read_len"]
        self.reads = traffic["reads_per_call"]
        self.inputs = reads.shards(seed, traffic["distinct_inputs"], self.reads,
                                   self.read_len, config["read_model"], device)
        self.bases_per_call = self.reads * self.read_len
        self._program = importlib.import_module(PROGRAM_MODULE)

    def call(self, chunk: torch.Tensor):
        # Looked up at each call, so that a test or the control can put
        # another route in the program's place.
        return getattr(self._program, PROGRAM_CALL)(chunk, self.k, canonical=self.canonical)

    def reference(self, chunk: torch.Tensor):
        return reference(chunk, self.k, self.canonical)

    @staticmethod
    def mismatches(out, ref) -> int:
        """Cells that differ; an output that is no tensor, or whose shape
        or dtype differs, counts every cell of the reference."""
        if (not isinstance(out, torch.Tensor) or out.shape != ref.shape
                or out.dtype != ref.dtype):
            return ref.numel()
        return int((out != ref).sum())


def reference(codes: torch.Tensor, k: int, canonical: bool = False, **broken):
    """The matrix the program's call has to return, from the plain
    reference (``broken`` names a guarantee to break: the control)."""
    return reference_dense.counts(codes, k, canonical, **broken)


def controls(config: dict) -> list:
    """The guarantees the control may break for this configuration."""
    out = ["n_as_base"]
    if config["canonical"]:
        out.append("forward_only")
    return out
