"""MS-SSIM of the port (eval/metrics.cal_ms_ssim, torch) against the JAX
package's (tests/test_ms_ssim.py is the oracle), on the CPU: 2-D images
and 3-D volumes within 2e-4, the same guard on small sides, and the
helpers (separable filters over 2 and 3 axes, the 2x pooling of odd
extents) against JAX's to float32 rounding (1e-6)."""
import numpy as np
import pytest
from scipy.ndimage import uniform_filter

import jax.numpy as jnp
import torch

from brief_pytorch_tpu.eval import metrics as jm
from brief_pytorch_tpu_torch.eval import metrics as tm


def _img(shape, seed=0):
    base = np.random.default_rng(seed).random(shape).astype(np.float32)
    return uniform_filter(base, size=5)


def _noisy(img, sigma, seed):
    return img + sigma * np.random.default_rng(seed).standard_normal(
        img.shape).astype(np.float32)


@pytest.mark.parametrize("shape,sigma", [
    ((200, 220, 1), 0.1), ((200, 200, 1), 0.02), ((177, 205, 3), 0.2),
    ((8, 180, 180, 1), 0.05), ((13, 171, 190, 1), 0.1)])
def test_ms_ssim_matches_jax(shape, sigma):
    img = _img(shape)
    noisy = _noisy(img, sigma, 1)
    got = tm.cal_ms_ssim(img, noisy, 1.0, device="cpu")
    want = jm.cal_ms_ssim(img, noisy, 1.0)
    assert got == pytest.approx(want, abs=2e-4)
    assert 0.0 <= got < 1.0
    assert tm.cal_ms_ssim(img, img, 1.0, device="cpu") == \
        pytest.approx(1.0, abs=1e-5)


def test_ms_ssim_uint16_range_and_guard():
    """Integer data scaled by its type's range, as eval_performance scales
    it; sides of 160 or less raise, as in JAX."""
    img = (_img((192, 200, 1)) * 60000).astype(np.uint16)
    dec = np.clip(_noisy(img.astype(np.float32), 900.0, 2), 0,
                  65535).astype(np.uint16)
    assert tm.cal_ms_ssim(img, dec, 65535.0, device="cpu") == \
        pytest.approx(jm.cal_ms_ssim(img, dec, 65535.0), abs=2e-4)
    with pytest.raises(ValueError):
        tm.cal_ms_ssim(img[:160], img[:160], 65535.0, device="cpu")


@pytest.mark.parametrize("dims,shape", [(2, (2, 1, 37, 41)),
                                        (3, (1, 2, 13, 25, 30))])
def test_filters_and_pooling_match_jax(dims, shape):
    x = np.random.default_rng(3).random(shape).astype(np.float32)
    win_t = tm._gauss_kernel1d(11, 1.5)
    win_j = jm._gauss_kernel1d(11, 1.5)
    np.testing.assert_allclose(
        tm._filter_sep_nd(torch.from_numpy(x), win_t, dims).numpy(),
        np.asarray(jm._filter_sep_nd(jnp.asarray(x), win_j, dims)),
        atol=1e-6)
    np.testing.assert_allclose(
        tm._avg_pool2(torch.from_numpy(x), dims).numpy(),
        np.asarray(jm._avg_pool2(jnp.asarray(x), dims)), atol=1e-6)
    y = x + 0.1
    for a, b in zip(tm._ssim_cs_maps(torch.from_numpy(x), torch.from_numpy(y),
                                     1.0, 11, dims),
                    jm._ssim_cs_maps(jnp.asarray(x), jnp.asarray(y), 1.0, 11,
                                     dims)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
