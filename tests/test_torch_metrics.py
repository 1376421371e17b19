"""The port's metrics (brief_pytorch_tpu_torch/eval/metrics.py) against
the JAX package's (eval/metrics.py) on the same numpy volumes.

PSNR and MSE run the same NumPy float32 code in both: equal to 1e-6.
SSIM: within 2e-4, the tolerance the JAX package holds against the
vendored torch SSIM (PARITY.md:73); the convolutions sum in different
orders.
"""
import numpy as np
import pytest

from brief_pytorch_tpu.eval import metrics as jm
from brief_pytorch_tpu_torch.eval import metrics as tm


def _pair(shape, seed, dtype=np.uint16, noise=2000.0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 40000, shape).astype(np.float64)
    # smooth structure so SSIM is far from 0 and 1
    for ax in range(len(shape) - 1):
        a = (a + np.roll(a, 1, axis=ax)) / 2
    b = np.clip(a + rng.normal(0, noise, shape), 0, 65535)
    return a.astype(dtype), b.astype(dtype)


@pytest.mark.parametrize("shape", [(12, 40, 36, 1), (64, 64, 1),
                                   (9, 8, 30, 1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_psnr_ssim_match_jax(shape, seed):
    a, b = _pair(shape, seed)
    assert tm.cal_mse(a, b) == pytest.approx(jm.cal_mse(a, b), rel=1e-6)
    assert tm.cal_psnr(a, b, 65535) == pytest.approx(
        jm.cal_psnr(a, b, 65535), rel=1e-6)
    ts = tm.cal_ssim(a, b, 65535, device="cpu")
    js = jm.cal_ssim(a, b, 65535)
    assert 0.0 < js < 1.0
    assert abs(ts - js) <= 2e-4


def test_ssim_slice_batches_are_equivalent():
    a, b = _pair((20, 24, 24, 1), 3)
    one = tm.cal_ssim(a, b, 65535, slice_batch=64, device="cpu")
    many = tm.cal_ssim(a, b, 65535, slice_batch=3, device="cpu")
    assert abs(one - many) <= 1e-6


def test_identical_volumes_score_one():
    a, _ = _pair((6, 20, 20, 1), 4)
    assert tm.cal_ssim(a, a, 65535, device="cpu") == pytest.approx(1.0,
                                                                   abs=1e-6)


def test_eval_performance_matches_jax():
    a, b = _pair((10, 32, 32, 1), 5)
    tp = tm.eval_performance(7, a, b, device="cpu")
    jp = jm.eval_performance(7, a, b)
    assert set(tp) == set(jp) == {"steps", "mse", "psnr", "ssim"}
    assert tp["steps"] == 7
    assert tp["psnr"] == pytest.approx(jp["psnr"], rel=1e-6)
    assert abs(tp["ssim"] - jp["ssim"]) <= 2e-4


def test_mip_ops_match_jax(tmp_path):
    a, _ = _pair((5, 6, 7, 1), 6)
    for x, y in zip(tm.mip_ops(a), jm.mip_ops(a)):
        np.testing.assert_array_equal(x, y)
    tm.mip_ops(a, str(tmp_path), "v", ".png")
    tm.mip_ops(a, str(tmp_path), "v", ".tif")
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"v_mip_{n}{e}" for n in "dhw" for e in (".png", ".tif"))
