"""The JAX package's native library, loaded safely for the port's tests.

The port's tests that hold a native-library result against the JAX
package's (``test_torch_topk.py``, ``test_torch_w2v.py``,
``test_torch_stream.py``) need that package's ``fileio.cc`` loaded.  Its
own loader (``buffalo_tpu/data/native/__init__.py``) runs ``g++ -o
_fileio.so`` straight into its source tree, with no temp file and no lock
between processes: under ``pytest -n`` a worker can load a half-written
file, get ``OSError`` and fall back to numpy for the rest of its life
while the port keeps its own library, and the byte-for-byte comparisons
then compare two different code paths.

``jax_native_lib`` (module scope) points that loader's module state
``_LIB_PATH`` at ``build/buffalo_tpu_ref/native/_fileio_<sha of
fileio.cc>.so`` (the git-ignored ``build/``), clears ``_lib`` /
``_build_failed`` and calls the JAX package's own ``get_lib()`` while
holding an exclusive ``fcntl.flock`` on a lock file beside that path.
Only holders of that lock ever write the path, so nobody loads a
half-written library.  When the library does not load, the fixture fails
the test; it never skips.  The module's state is restored afterwards.
"""
import contextlib
import fcntl
import hashlib
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import buffalo_tpu.data.native as jax_native

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_lib_path(root: str = _ROOT) -> str:
    """Where the JAX package's library is built for the port's tests:
    keyed by the source's hash, so an edited ``fileio.cc`` is rebuilt."""
    with open(jax_native._SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    return os.path.join(root, "build", "buffalo_tpu_ref", "native",
                        f"_fileio_{digest}.so")


@contextlib.contextmanager
def jax_native_loaded(path: str = None):
    """The JAX package's native library built at ``path`` under a file
    lock and loaded; yields it and restores the module's state after."""
    path = path or reference_lib_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    saved = (jax_native._LIB_PATH, jax_native._lib, jax_native._build_failed)
    try:
        jax_native._LIB_PATH = path
        jax_native._lib, jax_native._build_failed = None, False
        with open(path + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                lib = jax_native.get_lib()
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
        if lib is None:
            pytest.fail(f"the JAX package's native library did not build "
                        f"or load at {path}")
        yield lib
    finally:
        (jax_native._LIB_PATH, jax_native._lib,
         jax_native._build_failed) = saved


@pytest.fixture(scope="module")
def jax_native_lib():
    with jax_native_loaded() as lib:
        yield lib


def test_fixture_loads_the_reference_library(jax_native_lib):
    """The fixture's library is the one the JAX functions then call, built
    under ``build/``, and it computes (a checksum over a float buffer)."""
    assert jax_native.get_lib() is jax_native_lib
    assert jax_native._LIB_PATH == reference_lib_path()
    assert os.path.isfile(reference_lib_path())
    a = np.arange(4096, dtype=np.float32)
    sums = jax_native.checksum_native(a)
    assert sums is not None and sums.shape == (64,)


_WORKER = textwrap.dedent("""
    import sys, time
    sys.path.insert(0, sys.argv[1])
    time.sleep(float(sys.argv[3]))
    from tests.test_torch_native_ref import jax_native_loaded
    with jax_native_loaded(sys.argv[2]) as lib:
        import buffalo_tpu.data.native as jn
        import numpy as np
        s = jn.checksum_native(np.arange(1024, dtype=np.float32))
        print("LOADED", s is not None, flush=True)
""")


def test_concurrent_first_builds_all_load(tmp_path):
    """Four processes that reach a missing library at staggered times all
    load it: the one that takes the lock first builds it, the others wait
    and load the finished file."""
    path = str(tmp_path / "native" / "_fileio_test.so")
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = [subprocess.Popen(
        [sys.executable, str(script), _ROOT, path, str(0.3 * i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"}) for i in range(4)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all("LOADED True" in o for o in outs), outs
