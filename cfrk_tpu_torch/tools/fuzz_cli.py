"""Differential fuzz of the whole CLI surface against the numpy spec.

The port's counterpart of ``tools/fuzz_cli.py``.  Each trial synthesises
a random FASTA/FASTQ (random lengths, N rate, optional CRLF, optional
gzip/bgzf, zero-length and multiline records), draws a random
configuration (mode x k x canonical x stream x nonzero x batch size x
mesh), runs the real CLI (``cfrk_tpu_torch.cli.main``) on ``--device`` and
checks the OUTPUT FILE against the numpy specification
(``ops/reference.py``), parsing the bytes back, so the format layer is
covered too.  Some trials run as a two-file workflow, through stdin, or
crash after a random checkpoint and resume.

It keeps the JAX tool's draw sequence: the same seed gives the same
configurations.  With ``--devices N`` (N >= 8, as the JAX tool draws
meshes of 2, 4 and 8 devices) half the trials run on a mesh of
``--device`` repeated N times (``parallel.mesh.repeat_devices``, the
counterpart of XLA's forced host device count), through ``--devices``,
and some of those shard positions (``--seqpar``).  On the card each new
shape costs a launch, not a compile, so a campaign runs there: batches
of 1-23 reads, the spectrum kernel at k = 1-7 and the row-sort kernels up
to k = 31.

    python -m cfrk_tpu_torch.tools.fuzz_cli --trials 500 [--seed 0] [--devices 8]
        [--device cuda|cpu]

It stops at the first mismatch (an AssertionError naming the config).
"""

from __future__ import annotations

import argparse
import gzip
import io
import json
import os
import shutil
import sys
import tempfile
import time
from collections import Counter

import numpy as np

from ..cli import main as cli_main
from ..format import parse_cfrk
from ..io.bgzf import write_bgzf
from ..io.fasta import decode_codes
from ..ops.reference import (
    canonical_indices_np,
    count_perread_np,
    spectrum_np,
    window_indices_np,
)
from ..ops.sparse import decode_key
from ..parallel.mesh import repeat_devices
from ..runtime import faults
from . import card


def _cells(out_path: str, want: np.ndarray, n_reads: int, cfg: dict,
           nonzero: bool) -> np.ndarray:
    """A per-read .cfrk file parsed back into ``want``'s shape."""
    rows = open(out_path, "rb").read().split(b"\n")
    assert len(rows) == n_reads, (out_path, len(rows), cfg)
    got = np.zeros_like(want)
    for r, row in enumerate(rows):
        for cell in row.split(b" "):
            if cell:
                i, c = cell.split(b":")
                got[r, int(i)] += int(c)
        if not nonzero:
            # dense rows enumerate every index in order
            assert row.endswith(b" ") or want.shape[1] == 0, cfg
    return got


def run_trial(rng: np.random.Generator, tmp: str, device: str,
              use_mesh: bool = False) -> dict:
    """One random configuration end to end on ``device``; returns the
    config dict (raises AssertionError on a mismatch).  ``use_mesh``
    draws mesh trials, which need ``device`` repeated 8 times
    (``parallel.mesh.repeat_devices(8)``)."""
    # Adversarial shape drawers:
    #   lowcomplex   — poly-A / 2-letter reads: every window is the same
    #                  few keys (single-run RLE rows).
    #   contig       — 1-3 multi-kilobase reads (the tiled route past the
    #                  kernel ceiling at k >= 16).
    #   pathological — zero-length records, blank lines, multiline FASTA
    #                  records, forced CRLF (parser edge shapes at block
    #                  boundaries).
    shape = str(rng.choice(
        ["uniform", "lowcomplex", "contig", "pathological"],
        p=[0.55, 0.2, 0.1, 0.15],
    ))
    if shape == "contig":
        n_reads = int(rng.integers(1, 4))
    elif shape == "lowcomplex":
        n_reads = int(rng.integers(1, 30))
    else:
        n_reads = int(rng.integers(1, 60))
    fastq = bool(rng.integers(0, 2)) and shape != "contig"
    crlf = bool(rng.integers(0, 4) == 0) or (
        shape == "pathological" and bool(rng.integers(0, 2))
    )
    compress = rng.choice(["plain", "gzip", "bgzf"], p=[0.6, 0.2, 0.2])
    nl = b"\r\n" if crlf else b"\n"
    # FASTQ-only quality filtering (Phred+33): the oracle reads get the
    # same masking the parsers apply.
    min_qual = int(rng.choice([0, 0, 0, 10, 30])) if fastq else 0
    reads, blob = [], []
    for i in range(n_reads):
        if shape == "contig":
            length = int(rng.integers(2000, 30000))
        elif shape == "pathological" and rng.integers(0, 4) == 0:
            length = 0  # zero-length record
        else:
            length = int(rng.integers(1, 90))
        if shape == "lowcomplex":
            # poly-A or 2-letter alphabet, long enough to repeat keys
            length = int(rng.integers(100, 1500))
            alphabet = int(rng.integers(1, 3))
            codes = rng.integers(0, alphabet, size=length).astype(np.int8)
        else:
            codes = rng.integers(0, 4, size=length).astype(np.int8)
            codes[rng.random(length) < 0.05] = -1  # N bases
        seq = decode_codes(codes)
        if fastq:
            qual = (33 + rng.integers(0, 42, size=len(codes))).astype(np.uint8)
            if min_qual:
                codes = codes.copy()
                codes[qual < 33 + min_qual] = -1
            blob.append(b"@r%d" % i + nl + seq + nl + b"+" + nl + qual.tobytes() + nl)
        elif shape == "pathological":
            # multiline record + stray blank lines (the reference's
            # getline loop concatenated multiline sequences)
            parts = []
            pos = 0
            while pos < len(seq) or not parts:
                cut = pos + int(rng.integers(1, max(len(seq) - pos, 1) + 1))
                parts.append(seq[pos:cut])
                pos = cut
            body = nl.join(parts)
            extra = nl if rng.integers(0, 2) else b""
            blob.append(b">r%d" % i + nl + body + nl + extra)
        else:
            blob.append(b">r%d" % i + nl + seq + nl)
        reads.append(codes)
    data = b"".join(blob)
    ext = ".fastq" if fastq else ".fasta"
    inp = os.path.join(tmp, f"in{ext}")
    if compress == "gzip":
        inp += ".gz"
        with gzip.open(inp, "wb") as f:
            f.write(data)
    elif compress == "bgzf":
        inp += ".gz"
        write_bgzf(inp, data, block=int(rng.integers(200, 4096)))
    else:
        with open(inp, "wb") as f:
            f.write(data)

    mode = str(rng.choice(["perread", "spectrum", "sparse"]))
    if mode == "perread":
        # contigs: a dense [rows, 4**k] oracle at k=12 over 30 kb reads
        # is hundreds of MB — keep dense k small, nonzero covers big k.
        k = int(rng.integers(1, 13 if shape != "contig" else 9))
    elif mode == "spectrum":
        k = int(rng.integers(1, 8))  # dense table parsed back: keep small
    else:
        k = int(rng.integers(2, 32))
    canonical = bool(rng.integers(0, 2))
    stream = bool(rng.integers(0, 2))
    nonzero = k > 8 or (
        mode == "perread"
        and (bool(rng.integers(0, 2)) or (shape == "contig" and k > 6))
    )
    batch = int(rng.integers(1, 24))
    mesh_n = int(rng.choice([2, 4, 8])) if use_mesh and bool(rng.integers(0, 2)) else 0
    cfg = dict(
        mode=mode, k=k, canonical=canonical, stream=stream, nonzero=nonzero,
        batch=batch, fastq=fastq, crlf=crlf, compress=str(compress),
        n_reads=n_reads, mesh=mesh_n, min_qual=min_qual, shape=shape,
    )
    dev = ["--device", device, "--devices", str(mesh_n) if mesh_n else "1"]

    # Sometimes run as a MULTI-FILE workflow (--out-dir, the Swift/K
    # analog): duplicate the input under two names; both outputs must
    # match the oracle of the (identical) per-file read set.
    workflow = mode == "perread" and compress == "plain" and bool(
        rng.integers(0, 5) == 0
    )
    cfg["workflow"] = workflow
    if workflow:
        inp2 = os.path.join(tmp, "b" + ext)
        shutil.copy(inp, inp2)
        outdir = os.path.join(tmp, "out")
        argv = [inp, inp2, "-k", str(k), "--out-dir", outdir,
                "--mode", mode, "--batch-size", str(batch), *dev]
        if canonical:
            argv.append("--canonical")
        if stream:
            argv.append("--stream")
        if nonzero:
            argv.append("--nonzero")
        if min_qual:
            argv += ["--min-qual", str(min_qual)]
        rc = cli_main(argv)
        assert rc == 0, f"workflow CLI rc={rc} for {cfg}"
        want = count_perread_np(reads, k, canonical)
        for base in ("in", "b"):
            got = _cells(os.path.join(outdir, base + ".cfrk"), want, n_reads, cfg,
                         nonzero=True)
            np.testing.assert_array_equal(got, want, err_msg=f"{base} {cfg}")
        return cfg

    out = os.path.join(tmp, "out.dat")
    argv = [inp, "-k", str(k), "-o", out, "--mode", mode,
            "--batch-size", str(batch), *dev]
    if canonical:
        argv.append("--canonical")
    if stream:
        argv.append("--stream")
    if mode == "perread" and nonzero:
        argv.append("--nonzero")
    if mode == "sparse":
        argv += ["--spectrum-format", "tsv"]
    if min_qual:
        argv += ["--min-qual", str(min_qual)]
    # Sequence-parallel draw: shard the POSITION axis (halo exchange)
    # instead of rows; small k keeps every per-device slice wider than
    # the k-1 halo for the short reads drawn here.
    seqpar = (mesh_n in (2, 4) and mode != "sparse" and k <= 6
              and bool(rng.integers(0, 3) == 0))
    cfg["seqpar"] = seqpar
    if seqpar:
        argv.append("--seqpar")
        if mode == "spectrum" and bool(rng.integers(0, 2)):
            # each device row-sorts its own position slice; the host fold
            # merges the duplicates
            argv += ["--impl", "sort"]
            cfg["impl"] = "sort"

    # Stdin draw: feed the same bytes through '-' (pipe ingest).  It
    # excludes the crash/resume draw below and the seqpar draw.
    stdin = (not seqpar) and bool(rng.integers(0, 6) == 0)
    cfg["stdin"] = stdin
    if stdin:
        raw = open(inp, "rb").read()

        class _FakeStdin:
            buffer = io.BufferedReader(io.BytesIO(raw))

        old_stdin = sys.stdin
        sys.stdin = _FakeStdin()
        try:
            rc = cli_main([a if a != inp else "-" for a in argv])
        finally:
            sys.stdin = old_stdin
        assert rc == 0, f"stdin CLI rc={rc} for {cfg}"
    # Crash/resume draw: inject a crash right after a random checkpoint
    # save (runtime/faults.py), resume through the real --resume path,
    # and demand the final bytes equal an uninterrupted run's.
    crash = (not stdin) and stream and bool(rng.integers(0, 2))
    cfg["crash"] = crash
    if crash:
        argv += ["--checkpoint-every", "1"]
        # perread streams also have the torn-tail site (rows written,
        # checkpoint not yet saved); spectrum/sparse only checkpoint.
        site = str(rng.choice(
            ["checkpoint", "batch-written"] if mode == "perread" else ["checkpoint"]
        ))
        cfg["crash_site"] = site
        faults.arm(site, int(rng.integers(1, 4)))
        try:
            rc = cli_main(argv)
            assert rc == 0, f"CLI rc={rc} for {cfg}"
            fired = False
        except faults.InjectedFault:
            fired = True
        finally:
            faults.disarm()
        cfg["crash_fired"] = fired
        if fired:
            rc = cli_main(argv + ["--resume"])
            assert rc == 0, f"resume CLI rc={rc} for {cfg}"
            full = os.path.join(tmp, "full.dat")
            rc = cli_main([a if a != out else full for a in argv])
            assert rc == 0, f"full-run CLI rc={rc} for {cfg}"
            assert open(out, "rb").read() == open(full, "rb").read(), (
                f"crash-resume bytes differ from uninterrupted run: {cfg}"
            )
    elif not stdin:  # stdin already produced `out` above
        rc = cli_main(argv)
        assert rc == 0, f"CLI rc={rc} for {cfg}"

    # oracle check
    if mode == "perread":
        want = count_perread_np(reads, k, canonical)
        got = _cells(out, want, n_reads, cfg, nonzero)
        np.testing.assert_array_equal(got, want, err_msg=str(cfg))
    elif mode == "spectrum":
        want = spectrum_np(reads, k, canonical)
        got = parse_cfrk(open(out, "rb").read())[0]
        np.testing.assert_array_equal(got, want, err_msg=str(cfg))
    else:
        fn = canonical_indices_np if canonical else window_indices_np
        oracle: Counter = Counter()
        for codes in reads:
            idx = fn(codes, k)
            oracle.update(int(v) for v in idx[idx >= 0])
        got = {}
        for line in open(out, "rb").read().splitlines():
            kmer, cnt = line.split(b"\t")
            got[kmer.decode()] = int(cnt)
        want = {decode_key(code, k): c for code, c in oracle.items()}
        assert got == want, f"sparse mismatch for {cfg}"
    return cfg


def run_campaign(trials: int, seed: int, device: str, log=None,
                 use_mesh: bool = False) -> dict:
    """``trials`` trials from ``seed`` on ``device``, each in a fresh
    temporary directory; returns the campaign's record (trials, wall,
    kernel launches, configurations drawn by mode, mesh trials by size,
    seqpar trials)."""
    rng = np.random.default_rng(seed)
    before = card.launches()
    modes: Counter = Counter()
    meshes: Counter = Counter()
    seqpar = 0
    t0 = time.perf_counter()
    for t in range(trials):
        with tempfile.TemporaryDirectory() as tmp:
            cfg = run_trial(rng, tmp, device, use_mesh)
        modes[cfg["mode"]] += 1
        if cfg["mesh"]:
            meshes[str(cfg["mesh"])] += 1
        seqpar += cfg.get("seqpar", False)
        if log is not None and (t + 1) % 10 == 0:
            log(f"# {t + 1}/{trials} ok, last: {json.dumps(cfg)}")
    wall = time.perf_counter() - t0
    return {"trials": trials, "seed": seed, "wall_s": wall,
            "trials_per_s": trials / wall if wall > 0 else None,
            "modes": dict(modes), "mesh_trials": dict(meshes), "seqpar_trials": seqpar,
            "launches": card.launches_since(before)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--devices", type=int, default=0,
        help="also draw mesh trials over --device repeated this many times "
             "(at least 8: meshes of 2, 4 and 8 devices are drawn)",
    )
    card.add_device_argument(ap)
    args = ap.parse_args(argv)
    if 1 < args.devices < 8:
        ap.error(f"--devices {args.devices}: mesh trials draw meshes of up to 8 "
                 "devices, so a mesh campaign needs --devices 8 or more")
    device = card.resolve_device(args.device)
    if args.devices > 1:
        repeat_devices(args.devices)
    rec = run_campaign(args.trials, args.seed, args.device,
                       log=lambda msg: print(msg, flush=True), use_mesh=args.devices > 1)
    dev = card.device_record(device)
    print(f"all {args.trials} trials passed")
    print(json.dumps({"platform": dev["platform"], "device_kind": dev["device_kind"],
                      "card": dev["card"], **rec, "ok": True}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
