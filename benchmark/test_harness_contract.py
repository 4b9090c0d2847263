"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re
import subprocess
import sys

import pytest

from benchmark import roofline, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

BENCH = spec.load_benchmark()


def _line(text, most=200):
    return isinstance(text, str) and 1 <= len(text) <= most and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and (spec.ROOT / p).is_dir()
    for word in cmd:
        assert not word.startswith("/") and ".." not in word.split("/")
        if (spec.ROOT / word).is_file():
            assert any(word.startswith(p.rstrip("/") + "/") for p in paths), word


def test_every_file_under_paths_is_named_from_name_characters():
    for p in BENCH["paths"]:
        for f in (spec.ROOT / p).rglob("*"):
            if f.is_file() and "__pycache__" not in f.parts:
                assert PATH.match(str(f.relative_to(spec.ROOT))), f


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_allowed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


def test_metric_names_are_unique_across_kinds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    files = set()
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        body = json.loads((spec.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert all(k in body for k in c["reduced"])


def test_workloads():
    ws = BENCH["workloads"]
    assert 1 <= len(ws) <= 24
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in ws]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in ws) <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and _line(w["why"])


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e and _line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_cell_reports_what_it_must():
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"], BENCH)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e


def test_every_cell_finds_its_files_by_name():
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"], BENCH)
        entry = spec.load_module("entries", cell.traffic["entry"])
        assert hasattr(entry, "Workload") and hasattr(entry, "controls")
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.load_module("metrics", m["name"]).read)


def test_a_missing_name_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no_such.cell", BENCH)
    with pytest.raises(FileNotFoundError):
        spec.load_module("metrics", "no_such_metric")


@pytest.mark.parametrize("batch,read_len,k,words", [(100_000, 150, 8, 2), (100_000, 152, 31, 3),
                                                    (7, 20, 15, 2), (7, 20, 16, 3)])
def test_roofline_bytes_follow_the_documented_layout(batch, read_len, k, words):
    w = read_len - k + 1
    assert roofline.rows_bytes(batch, read_len, k) == batch * read_len + words * batch * w * 4
    ms, by = roofline.rowsort_bound(batch, read_len, k, canonical=k > 15)
    assert by == "bytes" and ms == pytest.approx(roofline.rows_bytes(batch, read_len, k)
                                                 / roofline.HBM_BW * 1e3)


def test_roofline_bytes_equal_the_reference_arrays():
    import torch

    from benchmark.references import perread_rows

    codes = torch.zeros((5, 40), dtype=torch.int8)
    for k in (8, 31):
        out = perread_rows.rows(codes, k, k > 15)
        assert roofline.rows_bytes(5, 40, k) == codes.numel() + sum(
            a.numel() * a.element_size() for a in out)


_IMPORTS = """
import sys
sys.path.insert(0, {root!r})
{body}
top = {{m.split('.')[0] for m in sys.modules}}
print(sorted(top & {{'jax', 'jaxlib', 'flax', 'cfrk_tpu', 'cfrk_tpu_torch'}}))
"""


def _top_level_after(body):
    code = _IMPORTS.format(root=str(spec.ROOT), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=spec.ROOT)
    return out.stdout.strip().splitlines()[-1]


def test_the_reference_imports_neither_jax_nor_either_package():
    assert _top_level_after("import benchmark.references.perread_rows") == "[]"


def test_the_harness_imports_no_jax():
    body = "\n".join([
        "from benchmark import harness, spec, control, card, reads, roofline, trace, run",
        "import torch",
        "bench = spec.load_benchmark()",
        "for w in bench['workloads']:",
        "    c = spec.cell(w['name'], bench)",
        "    e = spec.load_module('entries', c.traffic['entry'])",
        "    wl = e.Workload(c.config, dict(c.traffic, reads_per_call=4), 1, torch.device('cpu'))",
        "    wl.call(wl.inputs[0])",
        "    [spec.load_module('metrics', m['name']) for m in c.end_to_end + c.per_layer]",
    ])
    assert _top_level_after(body) == "['cfrk_tpu_torch']"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchmark import run

    monkeypatch.setattr(sys, "modules", {"cfrk_tpu_torch": 1, "cfrk_tpu_torch.ops": 1,
                                         "jax_like": 1, "os": 1})
    assert run.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {"cfrk_tpu.ops.sparse": 1, "jaxlib.xla": 1, "flax": 1})
    assert run.forbidden_modules() == ["cfrk_tpu", "flax", "jaxlib"]


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", BENCH["workloads"][0]["name"],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=spec.ROOT, check=False)
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert proc.returncode != 0 and proc.stdout == ""
