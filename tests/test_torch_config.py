"""cfrk_tpu_torch's config files (``--config``, ``cfrk.json``) against
cfrk_tpu's: the same argument values after the config is applied, on the
JAX package's argv/config pairs, the same refusals, and the same output
bytes.  Every test runs in an empty working directory of its own, so
that only the config it writes is discovered."""

import json
from pathlib import Path

import numpy as np
import pytest

from cfrk_tpu.cli import _split_reference_positionals as jax_split
from cfrk_tpu.cli import build_parser as jax_parser
from cfrk_tpu.cli import main as jax_main
from cfrk_tpu.runtime import config as jconfig
from cfrk_tpu_torch.cli import _split_reference_positionals
from cfrk_tpu_torch.cli import build_parser as torch_parser
from cfrk_tpu_torch.cli import main
from cfrk_tpu_torch.io.fasta import decode_codes
from cfrk_tpu_torch.runtime import config as tconfig


@pytest.fixture(autouse=True)
def _empty_cwd(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


def _fasta_bytes(n=5, length=30, seed=0) -> bytes:
    rng = np.random.default_rng(seed)
    return b"".join(
        b">r%d\n" % i + decode_codes(rng.integers(0, 4, length).astype(np.int8)) + b"\n"
        for i in range(n))


def _fasta(tmp_path, n=5, length=30, seed=0) -> str:
    path = tmp_path / "r.fasta"
    path.write_bytes(_fasta_bytes(n, length, seed))
    return str(path)


def _applied(parser, split, config_mod, argv, cfg: dict) -> dict:
    """The parsed arguments after ``cfg`` is applied, as each CLI's main
    applies it (positionals split first, argv wins)."""
    args, _ = parser.parse_known_args(argv)
    split(args)
    config_mod.apply_config(args, {k.replace("-", "_"): v for k, v in cfg.items()},
                            parser, explicit=config_mod.explicit_dests(argv, parser))
    return vars(args)


# The argv/config pairs of tests/test_cli.py's config tests.
_PAIRS = [
    (["r.fasta", "-o", "o.cfrk"], {"k": 3, "batch-size": 2}),
    (["r.fasta", "-o", "o.cfrk", "-k", "2"], {"k": 3, "batch-size": 2}),
    (["r.fasta", "-k", "2", "-o", "o.cfrk"], {"k": 4}),
    (["r.fasta", "-k", "3", "-o", "x.cfrk", "--batch=16"], {"batch-size": 4}),
    (["r.fasta", "-k", "3"], {"max-parallel-tasks": 3, "retries": 2,
                              "provenance": "p.jsonl", "no-lazy-errors": True,
                              "out-dir": "parts", "mode": "spectrum"}),
    (["r.fasta", "o.cfrk", "5", "--retries", "1"], {"retries": "4", "min-count": "2",
                                                    "output": "ignored.cfrk"}),
]


@pytest.mark.parametrize("argv,cfg", _PAIRS, ids=[
    "config_k", "argv_k_wins", "explicit_argv", "abbreviated_flag", "workflow_keys",
    "coercion_and_positionals"])
def test_apply_config_matches_jax(argv, cfg):
    """Every destination the two parsers share holds the same value."""
    got = _applied(torch_parser(), _split_reference_positionals, tconfig, argv, cfg)
    want = _applied(jax_parser(), jax_split, jconfig, argv, cfg)
    shared = set(got) & set(want)
    assert {"k", "batch_size", "output", "max_parallel_tasks", "retries",
            "provenance", "no_lazy_errors", "out_dir", "config"} <= shared
    assert {d: got[d] for d in shared} == {d: want[d] for d in shared}


def test_config_defaults_and_argv_override_bytes(tmp_path):
    """``--config`` supplies k and the batch size, argv's k wins; the
    bytes equal cfrk_tpu's in both cases."""
    fa = _fasta(tmp_path)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"k": 3, "batch-size": 2}))
    for extra, cells in (([], 64), (["-k", "2"], 16)):
        a, b = tmp_path / "a.cfrk", tmp_path / "b.cfrk"
        assert main([fa, "-o", str(a), *extra, "--config", str(cfg),
                     "--device", "cpu"]) == 0
        assert jax_main([fa, "-o", str(b), *extra, "--config", str(cfg)]) == 0
        assert a.read_bytes() == b.read_bytes()
        assert len(a.read_bytes().split(b"\n")[0].split()) == cells


def test_cfrk_json_is_discovered_in_the_cwd(tmp_path):
    """A ``cfrk.json`` in the working directory applies without
    ``--config``, here also a multi-file run's workflow settings."""
    fa = _fasta(tmp_path)
    Path("cfrk.json").write_text(json.dumps({
        "k": 4, "nonzero": True, "provenance": "prov.jsonl", "max-parallel-tasks": 1}))
    assert main([fa, "one.cfrk", "--device", "cpu"]) == 0
    assert jax_main([fa, "two.cfrk"]) == 0
    assert Path("one.cfrk").read_bytes() == Path("two.cfrk").read_bytes()
    second = tmp_path / "s.fasta"
    second.write_bytes(Path(fa).read_bytes())
    assert main([fa, str(second), "--out-dir", "parts", "--device", "cpu"]) == 0
    records = [json.loads(line) for line in Path("prov.jsonl").read_text().splitlines()]
    assert len(records) == 2 and all(r["ok"] for r in records)
    assert Path("parts/r.cfrk").read_bytes() == Path("one.cfrk").read_bytes()


@pytest.mark.parametrize(
    "cfg,message",
    [({"no-such-flag": 1}, "unknown config key: 'no_such_flag'"),
     ({"batch-size": "not-an-int"}, "cannot convert")],
    ids=["unknown_key", "bad_value"],
)
def test_config_refusals_match_jax(tmp_path, cfg, message):
    fa = _fasta(tmp_path)
    Path("c.json").write_text(json.dumps(cfg))
    for cli_main in (main, jax_main):
        with pytest.raises(SystemExit, match=message):
            cli_main([fa, "-k", "2", "--config", "c.json"])


@pytest.mark.parametrize(
    "key,cfg",
    [("devices", {"devices": 2}),
     ("tp", {"devices": 4, "tp": 2, "mode": "spectrum"}),
     ("seqpar", {"seqpar": True, "impl": "scatter"}),
     ("slack", {"slack": 0.5, "devices": 8, "mode": "sparse"}),
     ("distributed", {"distributed": True})],
    ids=["devices", "tp", "seqpar", "slack", "distributed"],
)
def test_config_scale_out_keys_are_not_ported(tmp_path, monkeypatch, key, cfg):
    """A ``cfrk.json`` written for cfrk_tpu may carry its scale-out keys:
    the port runs them to cfrk_tpu's bytes, on 8 devices (the port's
    ``local_devices`` patched to 8 CPU devices, as the JAX package has 8
    virtual host devices); ``distributed`` with several inputs in a
    group of one process runs every input (the JAX CLI, which cannot
    start ``jax.distributed`` in this process, runs them without it)."""
    import torch

    from cfrk_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setattr(pmesh, "local_devices", lambda device: [torch.device("cpu")] * 8)
    fa = _fasta(tmp_path, n=24, length=40)
    if key == "distributed":
        import socket

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", f"127.0.0.1:{port}")
        monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
        monkeypatch.setenv("JAX_PROCESS_ID", "0")
        second = tmp_path / "s.fasta"
        second.write_bytes(_fasta_bytes(n=9, length=50, seed=5))
        Path("cfrk.json").write_text(json.dumps({**cfg, "k": 3}))
        assert main([fa, str(second), "--out-dir", "parts", "--device", "cpu"]) == 0
        monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")
        Path("cfrk.json").write_text(json.dumps({"k": 3}))
        assert jax_main([fa, str(second), "--out-dir", "jparts"]) == 0
        for name in ("r.cfrk", "s.cfrk"):
            got = Path("parts", name).read_bytes()
            assert got == Path("jparts", name).read_bytes() and got
        return
    Path("cfrk.json").write_text(json.dumps({**cfg, "k": 4}))
    assert main([fa, "-o", "t.out", "--device", "cpu"]) == 0
    assert jax_main([fa, "-o", "j.out"]) == 0
    got = Path("t.out").read_bytes()
    assert got == Path("j.out").read_bytes() and got
