"""Entry: a chip's share of a sample counted into one dense k-mer table.

The timed call is the program's dispatcher
``cfrk_tpu_torch.ops.spectrum.spectrum(shard, k, canonical=...,
out=table)`` on one ``[reads, read_len]`` int8 shard already on the
device, adding the shard's counts into one ``[4**k]`` int32 table that
lives on the card from set-up on and is neither zeroed nor fetched in
the window: one chip's count of its reads before the merge across chips.

The shards come from a community read model (:func:`community_shards`):
``genomes`` random genomes of ``genome_len`` bases, each read's genome
drawn by ``torch.multinomial`` over lognormal abundances (drawn once a
seed), its start uniform, point mutations to a uniformly drawn base and
N bases (code -1), as ``benchmark/reads.py`` draws them otherwise.

The check.  The table is one tensor, the same at every kept call, so it
is held as a sum: the entry counts its own calls by input, and after the
window the table has to equal, cell for cell, the sum over the inputs of
(calls of that input) x (its spectrum from
``references/spectrum_table.py``).  The comparison is sparse, so that no
second ``4**k`` table is made: the cells at the expected keys that
differ, plus the nonzero cells elsewhere.

No control: ``control.py`` puts a route with the signature ``(codes, k,
canonical)`` that returns outputs in the program's place, and a call
that adds into ``out`` cannot be stood in for that way.  The benchmark's
tests break the call instead (an N read as A, a canonical key where a
forward one is due, a call dropped, a bin off by one) and find each run
not correct.
"""

from __future__ import annotations

import importlib

import torch

from benchmark.references import spectrum_table as reference_table

PROGRAM_MODULE = "cfrk_tpu_torch.ops.spectrum"
PROGRAM_CALL = "spectrum"
COUNT_LIMIT = 2**31  # an int32 bin is exact below this


def community_shards(seed: int, n_shards: int, reads: int, read_len: int, model: dict,
                     device: torch.device) -> list:
    """``n_shards`` int8 code tensors ``[reads, read_len]`` on ``device``.

    ``model``: ``genomes``, ``genome_len``, ``abundance_mu``,
    ``abundance_sigma``, ``mut_rate``, ``n_rate``.  The genomes are
    drawn as int8 directly, one byte a base.
    """
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**64)
    n_gen, gen_len = model["genomes"], model["genome_len"]
    if gen_len < read_len:
        raise ValueError(f"genome_len {gen_len} < read_len {read_len}")
    genomes = torch.randint(0, 4, (n_gen * gen_len,), generator=g, device=device,
                            dtype=torch.int8)
    abundance = torch.empty(n_gen, dtype=torch.float64, device=device).log_normal_(
        model["abundance_mu"], model["abundance_sigma"], generator=g)
    offsets = torch.arange(read_len, device=device)
    out = []
    for _ in range(n_shards):
        which = torch.multinomial(abundance, reads, replacement=True, generator=g)
        start = torch.randint(0, gen_len - read_len + 1, (reads,), generator=g,
                              device=device)
        codes = genomes[(which * gen_len + start)[:, None] + offsets]
        mutated = torch.rand((reads, read_len), generator=g, device=device) < model["mut_rate"]
        base = torch.randint(0, 4, (reads, read_len), generator=g, device=device,
                             dtype=torch.int8)
        codes = torch.where(mutated, base, codes)
        n_base = torch.rand((reads, read_len), generator=g, device=device) < model["n_rate"]
        out.append(torch.where(n_base, torch.tensor(-1, dtype=torch.int8, device=device),
                               codes).contiguous())
    return out


class Workload:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.k = config["k"]
        self.canonical = config["canonical"]
        self.read_len = config["read_len"]
        self.reads = traffic["reads_per_call"]
        self.inputs = community_shards(seed, traffic["distinct_inputs"], self.reads,
                                       self.read_len, config["read_model"], device)
        self.bases_per_call = self.reads * self.read_len
        self.table = torch.zeros(4**self.k, dtype=torch.int32, device=device)
        self.calls = [0] * len(self.inputs)
        self._index = {x.data_ptr(): j for j, x in enumerate(self.inputs)}
        self._spectra = {}
        self._program = importlib.import_module(PROGRAM_MODULE)

    def call(self, shard: torch.Tensor):
        self.calls[self._index[shard.data_ptr()]] += 1
        # Looked up at each call, so that a test can put another route
        # in the program's place.
        return getattr(self._program, PROGRAM_CALL)(shard, self.k, canonical=self.canonical,
                                                    out=self.table)

    def spectrum_of(self, j: int):
        """Input ``j``'s exact spectrum ``(keys, counts)``, worked out
        once."""
        if j not in self._spectra:
            self._spectra[j] = reference_table.spectrum(self.inputs[j], self.k, self.canonical)
        return self._spectra[j]

    def reference(self, shard: torch.Tensor):
        return self.spectrum_of(self._index[shard.data_ptr()])

    def expected(self):
        """``(keys, counts)``: the table's nonzero cells after every call
        so far, int64, keys ascending."""
        keys, counts = [], []
        for j, n in enumerate(self.calls):
            if n:
                k, c = self.spectrum_of(j)
                keys.append(k)
                counts.append(c * n)
        if not keys:
            empty = torch.zeros(0, dtype=torch.int64, device=self.table.device)
            return empty, empty.clone()
        keys, inverse = torch.unique(torch.cat(keys), sorted=True, return_inverse=True)
        total = torch.zeros(keys.numel(), dtype=torch.int64, device=keys.device)
        return keys, total.index_add_(0, inverse, torch.cat(counts))

    def mismatches(self, out, _ref) -> int:
        """Cells of the running table that differ from the expected one;
        a dtype or shape that differs counts every cell."""
        if (not isinstance(out, torch.Tensor) or out.dtype != torch.int32
                or tuple(out.shape) != (4**self.k,)):
            return 4**self.k
        keys, counts = self.expected()
        if counts.numel() and int(counts.max()) >= COUNT_LIMIT:
            raise RuntimeError(f"an expected bin reaches {int(counts.max())} >= 2**31: "
                               "the cell overflows an int32 table, whatever the program")
        at_keys = out[keys].to(torch.int64)
        wrong_at_keys = int((at_keys != counts).sum())
        nonzero_elsewhere = int(torch.count_nonzero(out)) - int(torch.count_nonzero(at_keys))
        return wrong_at_keys + nonzero_elsewhere


def controls(config: dict) -> list:
    """None: see the module's docstring."""
    return []
