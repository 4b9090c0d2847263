"""Entry: per-read k-mer rows of whole shards held on the card.

The timed call is the program's dispatcher
``cfrk_tpu_torch.ops.perread_sparse.count_perread_rows(shard, k,
canonical)`` on one ``[reads, read_len]`` int8 shard already on the
device: the route of every ``.cfrk`` output of the port, with the
row-sort kernels (``rowsort_rle`` for k <= 15, ``rowsort_rle_large``
above) doing nearly all of the device's work.

The configuration gives ``k``, ``canonical``, ``read_len`` and the read
model; the traffic gives ``reads_per_call`` and ``distinct_inputs``
(shards cycled in turn).  The check holds every cell of a sampled
call's rows to ``references/perread_rows.py`` over the same codes.
"""

from __future__ import annotations

import importlib

import torch

from benchmark import reads
from benchmark.references import perread_rows as reference_rows

PROGRAM_MODULE = "cfrk_tpu_torch.ops.perread_sparse"
PROGRAM_CALL = "count_perread_rows"


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

    def call(self, shard: torch.Tensor):
        # Looked up at each call, so that a test or the control can put
        # another route in the program's place.
        return getattr(self._program, PROGRAM_CALL)(shard, self.k, self.canonical)

    def reference(self, shard: torch.Tensor):
        return reference(shard, self.k, self.canonical)

    @staticmethod
    def mismatches(out, ref) -> int:
        """Cells that differ, over every array of the rows; a shape or
        dtype that differs counts every cell of the reference."""
        if len(out) != len(ref):
            return sum(r.numel() for r in ref)
        bad = 0
        for o, r in zip(out, ref):
            if o.shape != r.shape or o.dtype != r.dtype:
                bad += r.numel()
            else:
                bad += int((o != r).sum())
        return bad


def reference(codes: torch.Tensor, k: int, canonical: bool = False, **broken):
    """The rows the program's call has to return, from the plain
    reference (``broken`` names a guarantee to break: the control)."""
    return reference_rows.rows(codes, k, canonical, **broken)


def controls(config: dict) -> list:
    """The guarantees the control may break for this configuration."""
    out = ["n_as_base"]
    if config["canonical"]:
        out.append("forward_only")
    return out
