"""Port of core/coords.py (brief_pytorch_tpu_torch) against the JAX package.

index_to_coords is bit-equal: both round step to float32 and compute
lo + i * step in float32.  axis_linspace is held to four units in the last
place of max(|min|, |max|): jnp.linspace's float32 values come out of
XLA's fused, FMA-contracted code, the port rounds a float64 linspace once.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from brief_pytorch_tpu.core import coords as jc
from brief_pytorch_tpu_torch.core import coords as tc

MODES = ["n11", "0p1", "-1,1", "-2.5,3"]


@pytest.mark.parametrize("mode", MODES)
def test_parse_coords_mode(mode):
    assert tc.parse_coords_mode(mode) == jc.parse_coords_mode(mode)


@pytest.mark.parametrize("shape", [(5, 6, 7), (4, 9), (16, 16, 16),
                                   (3, 1, 17), (1, 8)])
@pytest.mark.parametrize("mode", ["n11", "-1,1", "0p1"])
def test_index_to_coords_exact(shape, mode):
    rng = np.random.default_rng(0)
    pop = int(np.prod(shape))
    idx = np.concatenate([np.arange(pop), rng.integers(0, pop, 50)])
    ref = np.asarray(jc.index_to_coords(jnp.asarray(idx), shape, mode))
    out = tc.index_to_coords(torch.from_numpy(idx), shape, mode).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("mode", MODES)
def test_axis_linspace_within_four_ulp(mode):
    lo, hi = jc.parse_coords_mode(mode)
    tol = 4 * np.spacing(np.float32(max(abs(lo), abs(hi))))
    for n in [1, 2, 3, 7, 16, 64, 100, 256, 333]:
        ref = np.asarray(jc.axis_linspace(n, mode))
        out = tc.axis_linspace(n, mode).numpy()
        assert out.dtype == np.float32 and out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=0, atol=tol)
        assert out[0] == np.float32(lo)
        if n > 1:
            assert out[-1] == np.float32(hi)
