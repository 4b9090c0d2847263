"""Times of the two histogram kernels on a CUDA device.

    python cfrk_tpu_torch/tools/hist_times.py [--seed 0] [--iters 50] \
        [--ks 7 8 9 10]

``spectrum_hist`` at k = 7, 8, 9, 10 (or ``--ks``) on four [8192, 256]
batches of 150 bp reads (the rest of each row is -1 padding), all seeded:

    random      random bases, N at rate 0.002
    polyA       every base A: one key
    genome500   reads drawn from one 500 bp sequence: a few hundred keys
    dinuc       the repeat ACAC...: two alternating keys

each as one CUDA-graph replay of ``iters`` launches into one running
table (a 20 us kernel in an eager loop times the host's launch rate).
Then ``perread_hist`` at k = 8 on the random batch, "b4", "fh" and
unpacked, as CUDA events around eager calls (the wrapper allocates a
0.5-2.1 GB output a call, too much to hold 50 of in a graph), each
beside two yardsticks of the same output block: ``Tensor.zero_()``, the
write rate the card gives a plain fill, and the plain alternative to the
kernel's design, ``zero_()`` followed by one global atomic a window
(``cfrk_perread_hist_scatter``; skipped where the library lacks it).
One JSON object per line; the first line is the card.

Run as a script, it imports whichever ``cfrk_tpu_torch`` is first on
``PYTHONPATH``: to compare two checkouts on one card, run it once with
each checkout's root there, in one job.  Needs a CUDA device: without
one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

__all__ = ["BATCH", "COLUMNS", "READ_LEN", "SPECTRUM_KS", "skew_batches",
           "time_spectrum", "time_perread"]

BATCH, COLUMNS, READ_LEN = 8192, 256, 150
SPECTRUM_KS = (7, 8, 9, 10)
_PACKINGS = {"b4": 2, "fh": 1, "unpacked": 0}


def skew_batches(seed: int) -> dict:
    """{name: [8192, 256] int8 codes}: the four batches of the module
    docstring, 150 valid bases a row."""
    rng = np.random.default_rng(seed)
    reads = {}
    reads["random"] = rng.integers(0, 4, size=(BATCH, READ_LEN)).astype(np.int8)
    reads["random"][rng.random((BATCH, READ_LEN)) < 0.002] = -1
    reads["polyA"] = np.zeros((BATCH, READ_LEN), np.int8)
    genome = rng.integers(0, 4, size=500).astype(np.int8)
    starts = rng.integers(0, 500 - READ_LEN + 1, size=BATCH)
    reads["genome500"] = genome[starts[:, None] + np.arange(READ_LEN)]
    reads["dinuc"] = np.tile(np.resize(np.array([0, 1], np.int8), READ_LEN),
                             (BATCH, 1))
    out = {}
    for name, r in reads.items():
        codes = np.full((BATCH, COLUMNS), -1, np.int8)
        codes[:, :READ_LEN] = r
        out[name] = codes
    return out


def time_spectrum(batches: dict, iters: int = 50, ks=SPECTRUM_KS) -> list:
    """ms per launch of ``spectrum_hist`` for each batch and k: one graph
    replay of ``iters`` launches into one running table."""
    from cfrk_tpu_torch.ops.cuda.spectrum import spectrum_hist
    from cfrk_tpu_torch.tools.rowsort_times import time_graph

    out = []
    for k in ks:
        table = torch.zeros(4**k, dtype=torch.int32, device="cuda")
        for name, codes in batches.items():
            dev = torch.from_numpy(codes).cuda()
            # Graph capture, warm-up and two replays: 2 * iters + 3
            # launches of under 2**21 windows stay far below 2**31 a bin.
            table.zero_()
            ms = time_graph(lambda: spectrum_hist(dev, k, False, out=table), iters)
            out.append({"kernel": "spectrum_hist", "batch": name, "k": k,
                        "codes": list(codes.shape), "ms": ms})
    return out


def time_perread(codes: np.ndarray, iters: int = 20, k: int = 8) -> list:
    """ms per call of ``perread_hist`` at ``k`` for each emit, beside
    ``zero_()`` of the same output and, where the library has it,
    ``zero_()`` + the scatter alternative."""
    from cfrk_tpu_torch.ops.cuda import perread as P
    from cfrk_tpu_torch.tools.rowsort_times import time_eager

    dev = torch.from_numpy(codes).cuda()
    b, length = dev.shape
    lib = P._library()
    scatter = getattr(lib, "cfrk_perread_hist_scatter", None)
    if scatter is not None:
        scatter.argtypes = [P._PTR, P._PTR] + [P._INT] * 6 + [P._PTR]
        scatter.restype = P._INT
    out = []
    for name, packing in _PACKINGS.items():
        packed = False if name == "unpacked" else name

        def kernel():
            return P.perread_hist(dev, k, False, packed=packed)

        block = kernel()
        rec = {"kernel": "perread_hist", "emit": name, "k": k,
               "codes": list(codes.shape), "written_bytes": block.numel() * 4,
               "ms": time_eager(kernel, iters),
               "zero_ms": time_eager(block.zero_, iters)}
        if scatter is not None:
            def zero_and_scatter():
                block.zero_()
                stream = torch.cuda.current_stream().cuda_stream
                err = scatter(dev.data_ptr(), block.data_ptr(), b, length,
                              length - k + 1, k, 0, packing, stream)
                if err != 0:
                    raise RuntimeError(f"cfrk_perread_hist_scatter: CUDA error {err}")
                return block

            if not torch.equal(zero_and_scatter(), kernel()):
                raise RuntimeError(f"{name}: the scatter alternative disagrees")
            rec["zero_and_scatter_ms"] = time_eager(zero_and_scatter, iters)
        rec["ms_again"] = time_eager(kernel, iters)
        rec["written_GB_per_s"] = rec["written_bytes"] / rec["ms"] / 1e6
        out.append(rec)
        del block
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--ks", type=int, nargs="+", default=list(SPECTRUM_KS),
                    help="the k values of spectrum_hist to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hist_times: no CUDA device is visible", file=sys.stderr)
        return 2
    import cfrk_tpu_torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "package": cfrk_tpu_torch.__file__}), flush=True)
    batches = skew_batches(args.seed)
    for rec in time_spectrum(batches, args.iters, args.ks):
        print(json.dumps(rec), flush=True)
    for rec in time_perread(batches["random"]):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
