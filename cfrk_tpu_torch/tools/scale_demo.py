"""Bounded-scale demonstration on the card (BASELINE.json config 5).

The port's counterpart of ``tools/scale_demo.py``: one end-to-end run of
>= 10M synthetic reads (bgzf, through ``make_synthetic``), driven through
the real CLI (``python -m cfrk_tpu_torch ... --device D`` children),
written to ``GPU_SCALE.json``:

* ``perread_k8_nonzero``: time to an exact ``.cfrk`` of per-read pairs,
  with the streamed run's stages and the output's sha256;
* ``spectrum_k8``: the dense spectrum into one device table;
* ``sparse_k31_resume``: the canonical k=31 sparse spectrum under a
  memory budget three ways: uninterrupted, killed mid-run, and
  ``--resume``d; the resumed output must hash byte-identical to the
  uninterrupted one.  The kill lands once the child's ``<out>.ckpt.json``
  exists and ``--kill-frac`` of the uninterrupted wall has passed;
* ``sparse_k31_scale_check_<N>m`` (``--scale-check-reads``; 0 leaves
  it out): the sparse leg again at more reads, its peak resident set
  beside the base leg's (the budget keeps it flat) and its count mass
  beside the input's N-rate model.

Every child's resident set is sampled from ``/proc/<pid>/statm`` every
50 ms.  A failed leg raises: it is not retried.  The record names the
card and its power limit (``nvidia-smi``), the host's cores and the
work directory's free disk.

Reads are sampled from synthetic genomes so that the k=31 key space is
genome-sized, not windows-sized: random reads would make every 31-mer
distinct, which no real dataset does.

Run:  python -m cfrk_tpu_torch.tools.scale_demo --reads 10000000 --json-out GPU_SCALE.json
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from ..io.bgzf import open_maybe_bgzf
from . import card, make_synthetic

ROOT = Path(__file__).resolve().parents[2]
_POLL_S = 0.05


def sha256_file(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def _rss_pages(pid: int) -> int:
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1])
    except (OSError, ValueError, IndexError):
        return 0  # the child has just gone


def run_cli(argv: list, workdir: str, kill_when=None) -> dict:
    """``python -m cfrk_tpu_torch <argv>`` to its end, its resident set
    sampled every 50 ms.  ``kill_when(elapsed_s)``: SIGKILL the child
    (its own PID) once it returns True.  Returns rc, wall_s, the
    ``--stats`` metrics line (``stages_s``), peak_rss_mb and killed;
    raises when the child fails and was not killed."""
    page_mb = os.sysconf("SC_PAGE_SIZE") / 2**20
    err_path = os.path.join(workdir, "child.stderr")
    peak, killed = 0, False
    t0 = time.perf_counter()
    with open(err_path, "wb") as err:
        proc = subprocess.Popen([sys.executable, "-m", "cfrk_tpu_torch", *argv],
                                cwd=ROOT, stdout=subprocess.DEVNULL, stderr=err)
        while proc.poll() is None:
            peak = max(peak, _rss_pages(proc.pid))
            if kill_when is not None and kill_when(time.perf_counter() - t0):
                proc.kill()
                killed = True
                proc.wait()
                break
            time.sleep(_POLL_S)
    wall = time.perf_counter() - t0
    stderr = Path(err_path).read_text(errors="replace")
    os.remove(err_path)
    if proc.returncode != 0 and not killed:
        tail = "\n".join(stderr.splitlines()[-12:])
        raise RuntimeError(f"cfrk_tpu_torch {' '.join(argv)} -> rc {proc.returncode}\n{tail}")
    stats = None
    for line in stderr.splitlines():
        line = line.strip()
        if line.startswith("{") and '"stages_s"' in line:
            stats = json.loads(line)
    return {"rc": proc.returncode, "wall_s": wall, "stats": stats,
            "peak_rss_mb": peak * page_mb, "killed": killed}


def valid_windows_per_read(path: str, k: int, sample_lines: int = 200_000) -> float:
    """Mean valid k-windows a read over the first ``sample_lines`` lines
    of a one-line-a-record FASTA: the N-rate model of the count mass."""
    n = valid = 0
    with open_maybe_bgzf(path) as f:
        for i, line in enumerate(f):
            if i >= sample_lines:
                break
            if line.startswith(b">"):
                continue
            bad = np.zeros(len(line.strip()) + 1, np.int64)
            seq = np.frombuffer(line.strip(), np.uint8)
            np.cumsum(~np.isin(seq, np.frombuffer(b"ACGT", np.uint8)), out=bad[1:])
            valid += int((bad[k:] == bad[:-k]).sum())
            n += 1
    return valid / n


def count_mass(path: str, chunk: int = 1 << 26) -> int:
    """Sum of the count column of a ``KMER<TAB>count`` file, read in
    chunks of whole lines: each line's decimal digits sit between its one
    tab and its newline."""
    total, tail = 0, b""
    with open(path, "rb") as f:
        while block := f.read(chunk):
            buf = tail + block
            cut = buf.rfind(b"\n") + 1
            tail = buf[cut:]
            arr = np.frombuffer(buf, np.uint8, count=cut)
            nl = np.flatnonzero(arr == 10)
            digits = nl - np.flatnonzero(arr == 9) - 1
            for place in range(int(digits.max(initial=0))):
                has = digits > place
                total += int(((arr[nl[has] - 1 - place].astype(np.int64) - 48)
                              * 10**place).sum())
    if tail:
        raise ValueError(f"{path}: the last line has no newline")
    return total


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=10_000_000)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--genomes", type=int, default=8)
    ap.add_argument("--genome-len", type=int, default=2_500_000)
    ap.add_argument("--workdir", default=None,
                    help="scratch dir (default: ./scale_scratch; the 10M-read "
                         "legs need ~20 GB)")
    ap.add_argument("--json-out", default="GPU_SCALE.json",
                    help="artifact path (relative: to the repo root)")
    ap.add_argument("--skip", default="",
                    help="comma list of legs to skip: perread,spectrum,sparse "
                         "(sparse also skips the scale check)")
    ap.add_argument("--sparse-mem-mb", type=int, default=4096,
                    help="--mem-budget-mb of the sparse k=31 legs (0 = none)")
    ap.add_argument("--scale-check-reads", type=int, default=20_000_000,
                    help="the sparse leg again at this read count (>= 2x "
                         "--reads): peak RSS must stay flat while wall "
                         "scales; 0 = skip")
    ap.add_argument("--kill-frac", type=float, default=0.4,
                    help="kill the sparse leg once its checkpoint exists and "
                         "this share of its uninterrupted wall has passed")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="reads per device batch of every leg (default: the CLI's)")
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    help="batches between checkpoints of the sparse legs "
                         "(default: the CLI's)")
    card.add_device_argument(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = card.resolve_device(args.device)
    skip = set(filter(None, args.skip.split(",")))
    wd = os.path.abspath(args.workdir or ROOT / "scale_scratch")
    out_path = Path(args.json_out)
    if not out_path.is_absolute():
        out_path = ROOT / out_path
    os.makedirs(wd, exist_ok=True)
    bases = args.reads * args.read_len
    common = ["--device", args.device]
    if args.batch_size:
        common += ["--batch-size", str(args.batch_size)]
    sparse_extra = list(common)
    if args.checkpoint_every:
        sparse_extra += ["--checkpoint-every", str(args.checkpoint_every)]

    def log(msg):
        print(f"# {msg}", flush=True)

    def synthesize(n: int) -> tuple[str, float | None]:
        path = os.path.join(wd, f"reads_{n}.fasta.bgz")
        if os.path.exists(path):
            return path, None
        log(f"synthesizing {n} reads -> {path}")
        t0 = time.perf_counter()
        make_synthetic.main([path, "--reads", str(n), "--read-len", str(args.read_len),
                             "--genomes", str(args.genomes),
                             "--genome-len", str(args.genome_len), "--bgzf"])
        return path, time.perf_counter() - t0

    dev = card.device_record(device)
    doc: dict = {
        "reads": args.reads, "read_len": args.read_len, "genomes": args.genomes,
        "genome_len": args.genome_len,
        "platform": dev["platform"], "device_kind": dev["device_kind"],
        "card": dev["card"], "torch": dev["torch"], "cuda": dev["cuda"],
        "nproc": os.cpu_count(),
        "disk_free_gb_at_start": shutil.disk_usage(wd).free / 1e9,
        "notes": [
            "each leg is one `python -m cfrk_tpu_torch` child on the device "
            "above; peak_rss_mb is that child's resident set, sampled from "
            "/proc/<pid>/statm every 50 ms",
            "bases_per_s is the leg's input bases over the child's wall, "
            "process start and the card's first use included",
        ],
        "legs": {},
    }
    def save():
        """The record as it stands: rewritten after every leg, so that a
        run cut short keeps the legs it finished."""
        doc["timestamp"] = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%SZ")
        doc["disk_free_gb"] = shutil.disk_usage(wd).free / 1e9
        out_path.write_text(json.dumps(doc, indent=1) + "\n")

    fasta, synth_s = synthesize(args.reads)
    doc["synth_s"] = synth_s
    doc["input_bytes_bgzf"] = os.path.getsize(fasta)

    def simple_leg(name: str, flags: list) -> None:
        out = os.path.join(wd, f"{name}.out")
        log(name)
        run = run_cli([fasta, "-k", "8", "-o", out, *flags, "--stream", "--stats",
                       *common], wd)
        doc["legs"][name] = {
            "wall_s": run["wall_s"], "bases_per_s": bases / run["wall_s"],
            "out_bytes": os.path.getsize(out), "sha256": sha256_file(out),
            "stats": run["stats"], "peak_rss_mb": run["peak_rss_mb"],
        }
        os.remove(out)
        save()
        log(f"{name} done in {run['wall_s']:.1f} s")

    if "perread" not in skip:
        simple_leg("perread_k8_nonzero", ["--nonzero"])
    if "spectrum" not in skip:
        simple_leg("spectrum_k8", ["--mode", "spectrum"])

    budget = ["--mem-budget-mb", str(args.sparse_mem_mb)] if args.sparse_mem_mb else []

    def sparse_argv(path: str, out: str) -> list:
        return [path, "-k", "31", "--canonical", "-o", out, "--mode", "sparse",
                "--stream", "--stats", *budget, *sparse_extra]

    if "sparse" not in skip:
        out_full = os.path.join(wd, "sparse_full.tsv")
        log(f"sparse k=31 canonical (uninterrupted, {budget or 'no budget'})")
        full = run_cli(sparse_argv(fasta, out_full), wd)
        sha_full = sha256_file(out_full)
        leg = {
            "mem_budget_mb": args.sparse_mem_mb or None,
            "full": {"wall_s": full["wall_s"], "bases_per_s": bases / full["wall_s"],
                     "out_bytes": os.path.getsize(out_full), "sha256": sha_full,
                     "stats": full["stats"], "peak_rss_mb": full["peak_rss_mb"]},
        }
        os.remove(out_full)

        out_res = os.path.join(wd, "sparse_resumed.tsv")
        ckpt = out_res + ".ckpt.json"
        kill_at = full["wall_s"] * args.kill_frac
        log(f"sparse: kill once {ckpt} exists and {kill_at:.1f} s have passed")
        killed = run_cli(sparse_argv(fasta, out_res), wd,
                         kill_when=lambda el: el >= kill_at and os.path.exists(ckpt))
        if not killed["killed"]:
            log("WARNING: the run finished before the kill point; the resume "
                "was not exercised")
        leg["killed_at_s"] = killed["wall_s"]
        leg["was_killed_midrun"] = killed["killed"]
        leg["killed_peak_rss_mb"] = killed["peak_rss_mb"]
        if killed["killed"]:
            state = json.loads(Path(ckpt).read_text())
            leg["checkpoint_at_kill"] = {
                "reads_done": state["reads_done"], "input_offset": state["input_offset"],
                "spilled_runs": len(state.get("sparse_runs") or [])}
        res = run_cli(sparse_argv(fasta, out_res) + ["--resume"], wd)
        sha_res = sha256_file(out_res)
        leg["resumed"] = {"wall_s": res["wall_s"], "sha256": sha_res, "stats": res["stats"],
                          "peak_rss_mb": res["peak_rss_mb"]}
        leg["byte_equal"] = sha_res == sha_full
        doc["legs"]["sparse_k31_resume"] = leg
        os.remove(out_res)
        save()
        log(f"sparse byte_equal={leg['byte_equal']}")
        if not leg["byte_equal"]:
            raise SystemExit("RESUME SPLICE MISMATCH: the outputs differ")

    if "sparse" not in skip and args.scale_check_reads and args.sparse_mem_mb:
        n2 = args.scale_check_reads
        fasta2, synth2_s = synthesize(n2)
        out2 = os.path.join(wd, "sparse_scalecheck.tsv")
        log(f"sparse k=31 scale check at {n2} reads")
        run = run_cli(sparse_argv(fasta2, out2), wd)
        mass = count_mass(out2)
        model = round(valid_windows_per_read(fasta2, 31) * n2)
        label = f"{n2 // 1_000_000}m" if n2 % 1_000_000 == 0 else str(n2)
        doc["legs"][f"sparse_k31_scale_check_{label}"] = {
            "reads": n2, "mem_budget_mb": args.sparse_mem_mb, "synth_s": synth2_s,
            "wall_s": run["wall_s"], "stats": run["stats"],
            "peak_rss_mb": run["peak_rss_mb"], "out_bytes": os.path.getsize(out2),
            "count_mass": mass, "count_mass_model": model,
            "notes": ["peak_rss_mb beside the base sparse leg's: the budget "
                      "keeps it flat while the wall scales with reads",
                      "count_mass against the input's N-rate model (the first "
                      "100k reads) checks the output independently"],
        }
        os.remove(out2)
        log(f"scale check done in {run['wall_s']:.1f} s, peak "
            f"{run['peak_rss_mb']:.0f} MB, mass {mass} vs model {model}")

    save()
    log(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
