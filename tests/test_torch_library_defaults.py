"""The library's entry points run on the card unless the caller asks for
the CPU, as ``cfrk_tpu``'s run on its default device.

With no device (and no mesh), every file driver and every public array
function of ``cfrk_tpu_torch`` on a numpy array goes to the card; where
no card is visible (``torch.cuda.is_available()`` patched to False, so
that the test means the same on a host with one) each raises the one
``RuntimeError`` naming the missing card, never a ``TypeError`` and
never a quiet run on the CPU.  With ``device="cpu"`` or a CPU tensor,
each equals the JAX package's function on the same file or array.
Tolerance: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfrk_tpu
import cfrk_tpu_torch
from cfrk_tpu.pipeline import stream as jstream
from cfrk_tpu_torch.pipeline import count as tcount
from cfrk_tpu_torch.pipeline import stream as tstream
from cfrk_tpu_torch.runtime.workflow import count_one_factory

NO_CARD = "no CUDA device is visible"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def fasta(tmp_path):
    rng = np.random.default_rng(3)
    path = tmp_path / "r.fa"
    path.write_text("".join(
        f">r{i}\n" + "".join(rng.choice(list("ACGTN"), size=int(rng.integers(5, 60))))
        + "\n" for i in range(40)))
    return str(path)


@pytest.fixture
def fastq(tmp_path):
    rng = np.random.default_rng(4)
    recs = []
    for i in range(30):
        n = int(rng.integers(8, 50))
        seq = "".join(rng.choice(list("ACGT"), size=n))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(0, 42, size=n))
        recs.append(f"@q{i}\n{seq}\n+\n{qual}\n")
    path = tmp_path / "r.fq"
    path.write_text("".join(recs))
    return str(path)


def _codes(seed=5, b=6, length=40):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(b, length)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.05] = -1
    return codes


_DRIVERS = {
    "count_file": lambda p, o: cfrk_tpu_torch.count_file(p, 4),
    "count_reads": lambda p, o: tcount.count_reads([np.zeros(9, np.int8)], 4),
    "count_file_dense_rows": lambda p, o: tcount.count_file_dense_rows(p, o, 4),
    "count_file_sparse_rows": lambda p, o: cfrk_tpu_torch.count_file_sparse_rows(p, o, 9),
    "spectrum_file": lambda p, o: cfrk_tpu_torch.spectrum_file(p, 4),
    "sparse_spectrum_file": lambda p, o: cfrk_tpu_torch.sparse_spectrum_file(p, 21),
    "stream_count_file": lambda p, o: cfrk_tpu_torch.stream_count_file(p, o, 4),
    "stream_spectrum_file": lambda p, o: cfrk_tpu_torch.stream_spectrum_file(p, 4),
    "stream_sparse_spectrum_file":
        lambda p, o: cfrk_tpu_torch.stream_sparse_spectrum_file(p, 21),
    "count_one_factory": lambda p, o: count_one_factory(4)(p, o),
}

_ARRAY_FUNCTIONS = {
    "window_components": lambda a: cfrk_tpu_torch.window_components(a, 3),
    "window_indices": lambda a: cfrk_tpu_torch.window_indices(a, 3),
    "count_perread": lambda a: cfrk_tpu_torch.count_perread(a, 3),
    "count_perread_sparse": lambda a: cfrk_tpu_torch.count_perread_sparse(a, 3),
    "spectrum": lambda a: cfrk_tpu_torch.spectrum(a, 3),
}


@pytest.mark.parametrize("name", sorted(_DRIVERS))
def test_driver_without_a_device_needs_the_card(no_card, fasta, tmp_path, name):
    with pytest.raises(RuntimeError, match=NO_CARD) as err:
        _DRIVERS[name](fasta, str(tmp_path / "o.out"))
    assert 'device="cpu"' in str(err.value)
    assert not (tmp_path / "o.out").exists()


@pytest.mark.parametrize("name", sorted(_ARRAY_FUNCTIONS))
def test_array_function_on_numpy_needs_the_card(no_card, name):
    with pytest.raises(RuntimeError, match=NO_CARD):
        _ARRAY_FUNCTIONS[name](_codes())


@pytest.mark.parametrize("name", sorted(_ARRAY_FUNCTIONS))
def test_array_function_keeps_a_cpu_tensor_on_the_cpu(no_card, name):
    out = _ARRAY_FUNCTIONS[name](torch.from_numpy(_codes()))
    leaves = [getattr(out, f) for f in ("hi", "lo", "rc_hi", "rc_lo", "valid")] if (
        name == "window_components") else (list(out) if isinstance(out, tuple) else [out])
    assert all(t.device.type == "cpu" for t in leaves)


def test_mesh_still_replaces_the_device(no_card, fasta):
    """A mesh's devices replace the default: no card is asked for."""
    from cfrk_tpu_torch.parallel import make_mesh

    mesh = make_mesh([torch.device("cpu")] * 2)
    got = cfrk_tpu_torch.spectrum_file(fasta, 4, mesh=mesh)
    np.testing.assert_array_equal(got, cfrk_tpu.spectrum_file(fasta, 4))


def test_arrays_equal_jax_on_a_cpu_tensor():
    codes = _codes(6, 7, 45)
    t, j = torch.from_numpy(codes), jnp.asarray(codes)
    for k in (1, 5, 8):
        np.testing.assert_array_equal(cfrk_tpu_torch.window_indices(t, k).numpy(),
                                      np.asarray(cfrk_tpu.window_indices(j, k)))
        got, want = cfrk_tpu_torch.window_components(t, k), cfrk_tpu.window_components(j, k)
        for field in ("hi", "lo", "rc_hi", "rc_lo", "valid"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)))
        np.testing.assert_array_equal(cfrk_tpu_torch.count_perread(t, k).numpy(),
                                      np.asarray(cfrk_tpu.count_perread(j, k)))
        np.testing.assert_array_equal(cfrk_tpu_torch.spectrum(t, k).numpy(),
                                      np.asarray(cfrk_tpu.spectrum(j, k)))
        for g, w in zip(cfrk_tpu_torch.count_perread_sparse(t, k),
                        cfrk_tpu.count_perread_sparse(j, k)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_file_drivers_on_the_cpu_equal_jax(fasta, tmp_path):
    cpu = {"device": "cpu"}
    np.testing.assert_array_equal(cfrk_tpu_torch.count_file(fasta, 4, **cpu),
                                  cfrk_tpu.count_file(fasta, 4))
    np.testing.assert_array_equal(cfrk_tpu_torch.spectrum_file(fasta, 6, **cpu),
                                  cfrk_tpu.spectrum_file(fasta, 6))
    assert (cfrk_tpu_torch.sparse_spectrum_file(fasta, 21, canonical=True, **cpu)
            == cfrk_tpu.sparse_spectrum_file(fasta, 21, canonical=True))
    for name in ("t", "j"):
        (tmp_path / name).mkdir()
    cfrk_tpu_torch.count_file_sparse_rows(fasta, tmp_path / "t" / "o", 9, **cpu)
    cfrk_tpu.count_file_sparse_rows(fasta, tmp_path / "j" / "o", 9)
    assert (tmp_path / "t" / "o").read_bytes() == (tmp_path / "j" / "o").read_bytes()
    got, _ = tstream.stream_spectrum_file(fasta, 5, **cpu)
    want, _ = jstream.stream_spectrum_file(fasta, 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("min_qual", [0, 20, 35])
def test_count_file_takes_min_qual_third(fastq, min_qual):
    """``count_file(path, k, min_qual)``: the JAX signature, positional."""
    got = cfrk_tpu_torch.count_file(fastq, 3, min_qual, device="cpu")
    want = cfrk_tpu.count_file(fastq, 3, min_qual)
    np.testing.assert_array_equal(got, want)
    if min_qual:
        assert not np.array_equal(got, cfrk_tpu.count_file(fastq, 3))
