"""Seeded synthetic reads, made on the device.

The read model of ``chip_smoke.synthetic_reads`` (``tools/make_synthetic
.py``'s, vectorised), kept here so that no later change to the program's
files can move it: random genomes, reads sampled from them at uniform
starts, point mutations to a uniformly drawn base, and N bases (code
-1).  It is drawn with a ``torch.Generator`` on the device in a few
large calls, so set-up spends no host time on it; the same seed on the
same device and PyTorch gives the same reads.  Every shard of one run
samples the same genomes, as the shards of one metagenome do.
"""

from __future__ import annotations

import torch


def shards(seed: int, n_shards: int, reads: int, read_len: int, model: dict,
           device: torch.device) -> list:
    """``n_shards`` int8 code tensors ``[reads, read_len]`` on ``device``.

    ``model``: ``genomes``, ``genome_len``, ``mut_rate``, ``n_rate``.
    """
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**64)
    n_gen, gen_len = model["genomes"], model["genome_len"]
    if gen_len < read_len:
        raise ValueError(f"genome_len {gen_len} < read_len {read_len}")
    genomes = torch.randint(0, 4, (n_gen * gen_len,), generator=g, device=device,
                            dtype=torch.int64).to(torch.int8)
    offsets = torch.arange(read_len, device=device)
    out = []
    for _ in range(n_shards):
        which = torch.randint(0, n_gen, (reads, 1), generator=g, device=device)
        start = torch.randint(0, gen_len - read_len + 1, (reads, 1), generator=g,
                              device=device)
        codes = genomes[which * gen_len + start + offsets]
        mutated = torch.rand((reads, read_len), generator=g, device=device) < model["mut_rate"]
        base = torch.randint(0, 4, (reads, read_len), generator=g, device=device,
                             dtype=torch.int64).to(torch.int8)
        codes = torch.where(mutated, base, codes)
        n_base = torch.rand((reads, read_len), generator=g, device=device) < model["n_rate"]
        out.append(torch.where(n_base, torch.tensor(-1, dtype=torch.int8, device=device),
                               codes).contiguous())
    return out
