"""The committed on-card artifacts of cfrk_tpu_torch's tools parse and
say what the port claims for them: ``GPU_VALID.json`` (from
``tools/onchip_validate``) with every check ok on an NVIDIA card, and
``GPU_SCALE.json`` (from ``tools/scale_demo``) with its three legs, the
sparse leg killed mid-run and resumed to the same bytes, each output
hashing to the JAX package's run of the same legs on a TPU
(``SCALE_r05.json``)."""

import json
from pathlib import Path

import pytest

from cfrk_tpu_torch.tools.onchip_validate import CHECKS

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def gpu_valid():
    return json.loads((ROOT / "GPU_VALID.json").read_text())


@pytest.fixture(scope="module")
def gpu_scale():
    return json.loads((ROOT / "GPU_SCALE.json").read_text())


@pytest.fixture(scope="module")
def tpu_scale():
    return json.loads((ROOT / "SCALE_r05.json").read_text())


def test_gpu_valid_is_from_an_nvidia_card(gpu_valid):
    assert gpu_valid["platform"] == "gpu"
    assert gpu_valid["device_kind"].startswith("NVIDIA")
    # nvidia-smi's "name, power limit" line of the card it ran on
    name, limit = (part.strip() for part in gpu_valid["card"].split(","))
    assert name == gpu_valid["device_kind"] and limit.endswith("W")
    assert gpu_valid["torch"] and gpu_valid["cuda"] and gpu_valid["timestamp"]


@pytest.mark.parametrize("check", list(CHECKS))
def test_gpu_valid_check_ok(gpu_valid, check):
    assert gpu_valid["ok"] is True
    assert gpu_valid["checks"][check]["ok"] is True
    assert gpu_valid["checks"][check]["wall_s"] >= 0


def test_gpu_valid_launched_every_kernel(gpu_valid):
    assert set(gpu_valid["checks"]) == set(CHECKS)
    assert set(gpu_valid["launches"]) == {
        "rowsort_rle", "rowsort_rle_large", "spectrum_hist", "perread_hist", "rowsort_probe"}
    assert all(n > 0 for n in gpu_valid["launches"].values())


def test_gpu_scale_legs(gpu_scale):
    assert gpu_scale["platform"] == "gpu" and gpu_scale["device_kind"].startswith("NVIDIA")
    assert gpu_scale["card"].split(",")[0].strip() == gpu_scale["device_kind"]
    assert gpu_scale["reads"] >= 10_000_000
    legs = gpu_scale["legs"]
    assert {"perread_k8_nonzero", "spectrum_k8", "sparse_k31_resume"} <= set(legs)
    for name in ("perread_k8_nonzero", "spectrum_k8"):
        assert len(legs[name]["sha256"]) == 64 and legs[name]["bases_per_s"] > 0
        assert legs[name]["stats"]["reads"] == gpu_scale["reads"]


def test_gpu_scale_sparse_killed_midrun_and_resumed(gpu_scale):
    leg = gpu_scale["legs"]["sparse_k31_resume"]
    assert leg["was_killed_midrun"] is True and leg["byte_equal"] is True
    assert leg["resumed"]["sha256"] == leg["full"]["sha256"]
    assert 0 < leg["checkpoint_at_kill"]["reads_done"] < gpu_scale["reads"]
    assert leg["full"]["stats"]["reads"] == gpu_scale["reads"]


@pytest.mark.parametrize("leg, part", [
    ("perread_k8_nonzero", None), ("spectrum_k8", None),
    ("sparse_k31_resume", "full"), ("sparse_k31_resume", "resumed"),
])
def test_gpu_scale_bytes_equal_tpu_run(gpu_scale, tpu_scale, leg, part):
    """The same input (``make_synthetic``'s draws at the same reads and
    genomes) gives the JAX package's output bytes on the TPU."""
    for key in ("reads", "read_len", "genomes", "genome_len", "input_bytes_bgzf"):
        assert gpu_scale[key] == tpu_scale[key]
    gpu, tpu = gpu_scale["legs"][leg], tpu_scale["legs"][leg]
    if part:
        gpu, tpu = gpu[part], tpu[part]
    assert gpu["sha256"] == tpu["sha256"]
    if "out_bytes" in tpu:
        assert gpu["out_bytes"] == tpu["out_bytes"]


def test_gpu_scale_check_equals_tpu_run(gpu_scale, tpu_scale):
    """The 20M-read scale check: the output's size and count mass equal
    the TPU run's, and its peak resident set stays within 5 % of the 10M
    sparse leg's (the budget keeps it flat)."""
    gpu = gpu_scale["legs"]["sparse_k31_scale_check_20m"]
    tpu = tpu_scale["legs"]["sparse_k31_scale_check_20m"]
    assert gpu["reads"] == 20_000_000
    assert gpu["out_bytes"] == tpu["out_bytes"]
    assert gpu["count_mass"] == tpu["count_mass"]
    assert gpu["count_mass_model"] == tpu["count_mass_model"]
    base = gpu_scale["legs"]["sparse_k31_resume"]["full"]["peak_rss_mb"]
    assert gpu["peak_rss_mb"] <= 1.05 * base
