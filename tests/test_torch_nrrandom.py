"""The port's ran0/rang stream (tlab_tpu_torch/utils/nrrandom.py) against
tlab_tpu's: the streams are integer arithmetic and IEEE operations in one
order, so every comparison here is exact (tolerance 0)."""
import shutil

import numpy as np
import pytest

from tlab_tpu.utils.nrrandom import NRStream as JStream
from tlab_tpu_torch.ops import _build
from tlab_tpu_torch.utils.nrrandom import NRStream

needs_cc = pytest.mark.skipif(
    not any(shutil.which(c) for c in ("cc", "gcc")),
    reason="no host C compiler: native/nrrand.c cannot be built")


@needs_cc
@pytest.mark.parametrize("seed", [-7, -12345, 1, 0])
def test_uniform_equals_jax_package(seed):
    assert np.array_equal(NRStream(seed).uniform(1000),
                          JStream(seed).uniform(1000))


@needs_cc
@pytest.mark.parametrize("seed", [-7, -12345])
def test_gaussian_equals_jax_package(seed):
    a = NRStream(seed).gaussian(1000, 0.5, 2.0)
    assert np.array_equal(a, JStream(seed).gaussian(1000, 0.5, 2.0))


@needs_cc
@pytest.mark.parametrize("kind", ["uniform", "gaussian"])
def test_library_equals_pure_python(kind):
    """The built C library against the plain Python arithmetic."""
    lib, py = NRStream(-31), NRStream(-31)
    got = getattr(lib, kind)(500)
    ref = getattr(py, kind + "_py")(500)
    assert np.array_equal(got, ref)
    assert np.array_equal(lib._state, py._state)


@needs_cc
def test_stream_is_continuous_across_calls():
    """Two batches of one stream equal one batch of their joint length,
    also when uniform and gaussian draws alternate."""
    one = NRStream(-5).uniform(300)
    st = NRStream(-5)
    assert np.array_equal(np.concatenate([st.uniform(100), st.uniform(200)]),
                          one)
    a, b = NRStream(-9), JStream(-9)
    for n, kind in ((10, "uniform"), (7, "gaussian"), (3, "uniform")):
        assert np.array_equal(getattr(a, kind)(n), getattr(b, kind)(n))


def test_pure_python_equals_jax_package_pure_python():
    """Without any library: the two Python loops agree."""
    a, b = NRStream(-3), JStream(-3)
    assert [a._ran0_py() for _ in range(50)] == \
        [b._ran0_py() for _ in range(50)]
    assert [a._rang_py(0.0, 1.0) for _ in range(20)] == \
        [b._rang_py(0.0, 1.0) for _ in range(20)]


def test_failed_build_raises(monkeypatch, tmp_path):
    """No quiet switch to the Python loop: where the library cannot be
    built the batch calls raise."""
    monkeypatch.setattr(_build, "NATIVE", tmp_path)       # no nrrand.c there
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="cannot be built"):
        NRStream(-1).uniform(4)
    (tmp_path / "nrrand.c").write_text("this is not C\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    if any(shutil.which(c) for c in ("cc", "gcc")):
        with pytest.raises(RuntimeError, match="failed to build"):
            NRStream(-1).gaussian(4)
