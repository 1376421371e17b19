"""The port's samplers (brief_pytorch_tpu_torch/train/samplers.py).

The torch and JAX generators cannot give the same draws, so parity is
shown two ways: the same indices or corners injected into both packages
give equal batches (index_to_coords is bit-equal, test_torch_coords.py),
and the draws have the right distribution.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from brief_pytorch_tpu.core.coords import index_to_coords as jidx
from brief_pytorch_tpu.train import samplers as js
from brief_pytorch_tpu_torch.train import samplers as ts


def _vol(shape, c=1, seed=0):
    return np.random.default_rng(seed).random(shape + (c,)).astype(np.float32)


def test_point_sampler_injected_indices_match_jax():
    shape = (6, 7, 8)
    vol = _vol(shape, c=2)
    flat = vol.reshape(-1, 2)
    idx = np.random.default_rng(1).integers(0, flat.shape[0], 500)
    s = ts.RandomPointSampler(shape, "-1,1", 500)
    coords, vals, wts = s.sample_at(torch.from_numpy(idx),
                                    torch.from_numpy(flat), None)
    np.testing.assert_array_equal(
        coords.numpy(), np.asarray(jidx(jnp.asarray(idx), shape, "-1,1")))
    np.testing.assert_array_equal(vals.numpy(), flat[idx])
    np.testing.assert_array_equal(wts.numpy(), np.ones_like(flat[idx]))
    w = flat * 3
    _, _, wts = s.sample_at(torch.from_numpy(idx), torch.from_numpy(flat),
                            torch.from_numpy(w))
    np.testing.assert_array_equal(wts.numpy(), w[idx])


def test_point_sampler_distribution():
    shape = (4, 4, 4)
    flat = torch.arange(64, dtype=torch.float32)[:, None]
    s = ts.RandomPointSampler(shape, "n11", 64 * 500)
    gen = torch.Generator().manual_seed(0)
    _, vals, _ = s.sample(gen, flat, None)
    counts = np.bincount(vals[:, 0].numpy().astype(int), minlength=64)
    # chi-square with 63 degrees of freedom; p = 1e-4 critical value ~ 114
    chi2 = ((counts - 500) ** 2 / 500).sum()
    assert chi2 < 114
    # the generator fixes the draw
    gen2 = torch.Generator().manual_seed(0)
    _, again, _ = s.sample(gen2, flat, None)
    assert torch.equal(vals, again)


@pytest.mark.parametrize("shape,cube,corners", [
    ((6, 7, 8), (3, 4, 5), [[0, 0, 0], [3, 3, 3], [1, 2, 0]]),
    ((9, 10), (4, 10), [[5, 0]]),
    ((8, 8, 8), (8, 8, 8), [[0, 0, 0]]),
])
def test_cube_sampler_injected_corners_match_jax(shape, cube, corners):
    vol = _vol(shape, c=2, seed=2)
    s = ts.RandomCubeSampler(shape, "-1,1", len(corners), cube)
    coords, vals, wts = s.sample_at(corners, torch.from_numpy(vol), None)
    ref_c, ref_v = [], []
    for corner in corners:
        sl = tuple(slice(a, a + n) for a, n in zip(corner, cube))
        ref_v.append(vol[sl].reshape(-1, 2))
        grids = np.meshgrid(*[np.arange(a, a + n) for a, n in
                              zip(corner, cube)], indexing="ij")
        flat = np.ravel_multi_index([g.ravel() for g in grids], shape)
        ref_c.append(np.asarray(jidx(jnp.asarray(flat), shape, "-1,1")))
    np.testing.assert_array_equal(coords.numpy(), np.concatenate(ref_c))
    np.testing.assert_array_equal(vals.numpy(), np.concatenate(ref_v))
    assert torch.equal(wts, torch.ones_like(vals))


def test_full_volume_cube_equals_jax_batch():
    """A cube covering the volume has one position: both packages give the
    same batch, whatever their generators draw."""
    shape = (5, 6, 7)
    vol = _vol(shape, seed=3)
    j = js.RandomCubeSampler(shape, "-1,1", 1, (100, 100, 100))
    jc, jv, jw = j.sample(jax.random.PRNGKey(0), jnp.asarray(vol), None)
    t = ts.RandomCubeSampler(shape, "-1,1", 1, (100, 100, 100))
    tc, tv, tw = t.sample(torch.Generator().manual_seed(5),
                          torch.from_numpy(vol), None)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_cube_corners_cover_every_position_uniformly():
    shape, cube = (6, 5), (3, 4)      # 4 x 2 positions
    s = ts.RandomCubeSampler(shape, "n11", 4000, cube)
    vol = torch.arange(30, dtype=torch.float32).reshape(6, 5, 1)
    _, vals, _ = s.sample(torch.Generator().manual_seed(1), vol, None)
    firsts = vals.reshape(4000, 12)[:, 0].numpy().astype(int)
    counts = np.bincount(firsts, minlength=30)
    starts = [r * 5 + c for r in range(4) for c in range(2)]
    assert set(np.nonzero(counts)[0]) == set(starts)
    assert counts[starts].min() > 400      # 500 expected per position


def test_cube_size_guard_matches_jax():
    for args in [("randomcube", 100 ** 3, 90 ** 3), ("randomcube", 64 ** 3,
                 64 ** 3), ("randompoint", 10 ** 9, 10 ** 9),
                 ("randomcube", 81 ** 3, 10 ** 9)]:
        assert ts.cube_size_guard(*args) == js.cube_size_guard(*args)
