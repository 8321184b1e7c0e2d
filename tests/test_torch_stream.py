"""The port's ``Stream`` builder against the JAX package's, on the CPU.

The same stream file built by each package must give byte-identical
compiled groups (rowwise, colwise, vali, idmap, sppmi: every array's dtype,
shape and bytes) and the same header: on the fixtures of
``tests/data/test_stream.py`` (both internal data types, ``newest`` and
``sample`` validation, unicode tokens, an SPPMI group) and on a seeded
random corpus with Zipf item popularity.  The SPPMI builder is also held
to itself three ways on that corpus: the port's native (sort-based)
counting, its numpy path and the JAX package's builder.
"""
import json
import os

import numpy as np
import pytest

from buffalo_tpu.data import Stream as RefStream
from buffalo_tpu.data import StreamOptions as RefStreamOptions
from buffalo_tpu.data import fileio as ref_fileio
from buffalo_tpu_torch.data import Stream, StreamOptions, fileio, load, native
from tests.test_torch_native_ref import jax_native_lib  # noqa: F401

# the JAX package's native library, built and loaded under a lock
# (see test_torch_native_ref.py)
pytestmark = pytest.mark.usefixtures("jax_native_lib")

STREAM_LINES = "alpha beta gamma beta\nbeta delta\ngamma gamma alpha\n"
GROUPS = ("rowwise", "colwise", "vali", "idmap", "sppmi")


def _build(cls, options, main, root, internal="stream", validation=None,
           sppmi=None, seed=0):
    opt = options().get_default_option()
    opt.input.main = str(main)
    opt.data.path = str(root / f"{cls.__module__.split('.')[0]}.bfo")
    opt.data.tmp_dir = str(root / "tmp")
    opt.data.internal_data_type = internal
    opt.data.validation = validation if validation is not None else {}
    opt.data.sppmi = sppmi if sppmi is not None else {}
    opt.data.random_seed = seed
    s = cls(opt)
    s.create()
    return s


def _same_database(a, b):
    """Every group array byte-identical, the headers equal."""
    with open(os.path.join(a.path, "header.json")) as fh:
        ha = json.load(fh)
    with open(os.path.join(b.path, "header.json")) as fh:
        hb = json.load(fh)
    assert ha == hb
    names = sorted(f for f in os.listdir(a.path) if f.endswith(".npy"))
    assert names == sorted(f for f in os.listdir(b.path)
                           if f.endswith(".npy"))
    assert {n.split(".")[0] for n in names} <= set(GROUPS)
    for n in names:
        x = np.load(os.path.join(a.path, n))
        y = np.load(os.path.join(b.path, n))
        assert x.dtype == y.dtype and x.shape == y.shape, n
        assert x.tobytes() == y.tobytes(), n
    return names


def _both(tmp_path, text, **kw):
    main = tmp_path / "main.txt"
    main.write_text(text)
    ref = _build(RefStream, RefStreamOptions, main, tmp_path, **kw)
    got = _build(Stream, StreamOptions, main, tmp_path, **kw)
    return ref, got


FIXTURES = {
    "stream": dict(text=STREAM_LINES),
    "matrix": dict(text=STREAM_LINES, internal="matrix"),
    "newest": dict(text=STREAM_LINES,
                   validation={"name": "newest", "n": 1, "max_samples": 10}),
    "newest_dedupe_matrix": dict(text="x y z a a b\nq r\n", internal="matrix",
                                 validation={"name": "newest", "n": 3}),
    "sample_clamped": dict(text=STREAM_LINES,
                           validation={"name": "sample", "p": 1.0,
                                       "max_samples": 10 ** 9}),
    "sppmi": dict(text="\n".join("a b c d e" for _ in range(10)) + "\n",
                  sppmi={"windows": 2, "k": 1}),
    "unicode": dict(text="사과 배\n배 포도\n"),
}


@pytest.mark.parametrize("case", list(FIXTURES))
def test_fixture_groups_byte_identical(tmp_path, case):
    ref, got = _both(tmp_path, **FIXTURES[case])
    names = _same_database(ref, got)
    if case == "sppmi":
        assert "sppmi.key.npy" in names and got.has_group("sppmi")


def _corpus(seed, lines=400, vocab=300, mean_len=12):
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, vocab + 1) ** 0.8
    pop /= pop.sum()
    out = []
    for _ in range(lines):
        n = max(1, int(rng.poisson(mean_len)))
        out.append(" ".join(f"t{int(x)}" for x in rng.choice(vocab, n, p=pop)))
    return "\n".join(out) + "\n"


@pytest.mark.parametrize("internal", ["stream", "matrix"])
@pytest.mark.parametrize("validation", [
    {}, {"name": "newest", "n": 2, "max_samples": 50},
    {"name": "sample", "p": 0.05, "max_samples": 100}])
def test_random_corpus_byte_identical(tmp_path, internal, validation):
    ref, got = _both(tmp_path, _corpus(7), internal=internal,
                     validation=validation, sppmi={"windows": 5, "k": 2},
                     seed=3)
    names = _same_database(ref, got)
    assert "sppmi.val.npy" in names
    assert got.get_header() == ref.get_header()


def test_load_and_cfr_scale_info(tmp_path):
    main = tmp_path / "main.txt"
    main.write_text(_corpus(2, lines=50))
    opt = StreamOptions().get_default_option()
    opt.input.main = str(main)
    opt.data.path = str(tmp_path / "l.bfo")
    opt.data.tmp_dir = str(tmp_path / "tmp")
    opt.data.internal_data_type = "matrix"
    opt.data.validation = {}
    opt.data.sppmi = {"windows": 3, "k": 1}
    data = load(opt)
    assert isinstance(data, Stream)
    data.create()
    info = data.get_scale_info(with_sppmi=True)
    assert info["sppmi_nnz"] == len(data.get_group("sppmi")["key"]) > 0


@pytest.mark.parametrize("window,k", [(1, 1), (5, 2), (5, 10)])
def test_sppmi_native_numpy_and_jax_byte_equal(monkeypatch, window, k):
    """The native sort-based counting, the numpy path and the JAX package's
    builder give the same CSR, byte for byte, on a Zipf corpus (several
    head partitions through ``max_pairs_in_memory``)."""
    if native.get_lib() is None:
        pytest.skip("no C++ compiler for the native library")
    rng = np.random.default_rng(window * 10 + k)
    lens = rng.integers(1, 40, 500)
    indptr = np.zeros(501, np.int64)
    indptr[1:] = np.cumsum(lens)
    pop = 1.0 / np.arange(1, 701) ** 0.8
    keys = rng.choice(700, int(indptr[-1]), p=pop / pop.sum()).astype(np.int32)
    kw = dict(window=window, k=k, max_pairs_in_memory=1 << 14)
    got = fileio.build_sppmi(indptr, keys, 700, **kw)
    ref = ref_fileio.build_sppmi(indptr, keys, 700, **kw)
    monkeypatch.setattr(native, "build_sppmi_native", lambda *a, **kw: None)
    plain = fileio.build_sppmi(indptr, keys, 700, **kw)
    for a, b, c in zip(got, ref, plain):
        assert a.dtype == b.dtype == c.dtype
        assert a.tobytes() == b.tobytes() == c.tobytes()
    assert len(got[1]) > 0
