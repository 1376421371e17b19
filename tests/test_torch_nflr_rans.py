"""The port's rANS codec (brief_pytorch_tpu_torch/nflr/rans.py) against
the JAX package's (brief_pytorch_tpu/nflr/rans.py), on the CPU.

Bytes are compared exactly: the port's backend (native/rans.cpp built into
build/librans.so by ops/build.host_library, or the pure-Python codec when
no compiler is found) against the JAX package's, on shared and
per-channel CDFs; the port's two backends against each other; quantize_pmf
exactly; streams decode across the packages.
"""
import numpy as np
import pytest

from brief_pytorch_tpu.nflr import rans as jrans
from brief_pytorch_tpu_torch.nflr import rans


def _case(seed, n_cdfs_max=6, n_max=3000):
    rng = np.random.default_rng(seed)
    cdfs = [jrans.quantize_pmf(rng.dirichlet(np.ones(int(rng.integers(2, 40)))))
            for _ in range(int(rng.integers(1, n_cdfs_max)))]
    n = int(rng.integers(1, n_max))
    ch = rng.integers(0, len(cdfs), n)
    syms = np.array([rng.integers(0, len(cdfs[c]) - 1) for c in ch])
    return rng, cdfs, ch, syms


def test_backend_is_built_from_the_checkout():
    """With a host compiler (g++, c++, clang++ or nvcc) the native codec is
    build/librans.so compiled from native/rans.cpp, never native/bin/."""
    from brief_pytorch_tpu_torch.ops import build
    assert rans.backend() in ("native", "python")
    if build._host_compiler() is not None:
        assert rans.backend() == "native"
        lib = rans.native()
        assert lib._name == str(build.BUILD / "librans.so")
        assert "native/bin" not in lib._name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_per_channel_bytes_equal_jax(seed):
    _, cdfs, ch, syms = _case(seed)
    blob = rans.encode_per_channel(syms, cdfs, ch)
    assert blob == jrans.encode_per_channel(syms, cdfs, ch)
    assert blob == jrans._encode_per_channel_py(syms, cdfs, ch)
    assert blob == rans._encode_per_channel_py(syms, cdfs, ch)
    np.testing.assert_array_equal(rans.decode_per_channel(blob, cdfs, ch),
                                  syms)
    np.testing.assert_array_equal(
        jrans.decode_per_channel(blob, cdfs, ch), syms)
    np.testing.assert_array_equal(
        rans._decode_per_channel_py(blob, cdfs, ch), syms)


@pytest.mark.parametrize("seed", [0, 1])
def test_shared_cdf_bytes_equal_jax(seed):
    rng = np.random.default_rng(10 + seed)
    pmf = rng.dirichlet(np.ones(33))
    cdf = rans.quantize_pmf(pmf)
    syms = rng.choice(33, 4000, p=pmf)
    blob = rans.encode(syms, cdf)
    assert blob == jrans.encode(syms, cdf) == rans._encode_py(syms, cdf)
    np.testing.assert_array_equal(rans.decode(blob, len(syms), cdf), syms)
    np.testing.assert_array_equal(rans._decode_py(blob, len(syms), cdf),
                                  syms)
    # near entropy-optimal, as the JAX package's test asks
    bound = -np.sum(np.log2(pmf[syms])) / 8
    assert len(blob) < bound * 1.05 + 16


@pytest.mark.parametrize("pmf", [
    [0.9, 0.0999, 1e-4, 1e-9], [0.25] * 4, [0.0, 0.0, 0.0],
    list(np.random.default_rng(5).dirichlet(np.ones(300)))])
def test_quantize_pmf_equal_jax(pmf):
    cdf = rans.quantize_pmf(np.asarray(pmf))
    np.testing.assert_array_equal(cdf, jrans.quantize_pmf(np.asarray(pmf)))
    assert cdf[0] == 0 and cdf[-1] == 1 << rans.PRECISION
    assert (np.diff(cdf.astype(np.int64)) >= 1).all()


def test_constants_equal_jax():
    assert (rans.PRECISION, rans.RANS_L) == (jrans.PRECISION, jrans.RANS_L)


def test_truncated_stream_raises():
    _, cdfs, ch, syms = _case(3)
    blob = rans.encode_per_channel(syms, cdfs, ch)
    if rans.backend() == "native":
        with pytest.raises(ValueError):
            rans.decode_per_channel(blob[:3], cdfs, ch)
