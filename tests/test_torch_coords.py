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


# --- the fleet's per-block helpers (JAX core/coords.py:71-173) -------------
FLEET_SHAPES = [(5, 6, 7), (37, 41), (1, 9, 4), (256, 256, 256), (4096, 4096)]


def _indices(shape):
    """Every index of a small grid, or edges, random draws and the indices
    just below 2**24 (where floordiv24 stops being proven exact)."""
    pop = int(np.prod(shape))
    rng = np.random.default_rng(1)
    idx = [np.arange(min(pop, 2000)), rng.integers(0, pop, 3000), [pop - 1]]
    if pop >= 1 << 24:
        idx.append(np.arange((1 << 24) - 64, 1 << 24))
    return np.unique(np.concatenate(idx)).astype(np.int32)


@pytest.mark.parametrize("shape", FLEET_SHAPES)
def test_row_major_strides_exact(shape):
    sv = np.asarray(shape, np.int32)
    ref = np.asarray(jc.row_major_strides(jnp.asarray(sv)))
    out = tc.row_major_strides(torch.from_numpy(sv).long()).numpy()
    np.testing.assert_array_equal(out, ref)
    batched = tc.row_major_strides(torch.from_numpy(np.stack([sv, sv])).long())
    np.testing.assert_array_equal(batched.numpy(), np.stack([ref, ref]))


@pytest.mark.parametrize("shape", FLEET_SHAPES)
@pytest.mark.parametrize("mode", ["n11", "-1,1", "0p1"])
def test_flat_to_axes24_and_axes_to_coords_exact(shape, mode):
    sv = np.asarray(shape, np.int32)
    idx = _indices(shape)
    ref_axes = np.asarray(jc.flat_to_axes24(jnp.asarray(idx), jnp.asarray(sv)))
    axes = tc.flat_to_axes24(torch.from_numpy(idx).long(),
                             torch.from_numpy(sv).long())
    np.testing.assert_array_equal(axes.numpy(), ref_axes)
    ref = np.asarray(jc.axes_to_coords(jnp.asarray(ref_axes), jnp.asarray(sv),
                                       mode))
    out = tc.axes_to_coords(axes, torch.from_numpy(sv).long(), mode).numpy()
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("shape", FLEET_SHAPES)
@pytest.mark.parametrize("mode", ["n11", "-2.5,3"])
def test_index_to_coords_dynamic_exact(shape, mode):
    sv = np.asarray(shape, np.int32)
    idx = _indices(shape)
    ref = np.asarray(jc.index_to_coords_dynamic(jnp.asarray(idx),
                                                jnp.asarray(sv), mode))
    out = tc.index_to_coords_dynamic(torch.from_numpy(idx).long(),
                                     torch.from_numpy(sv).long(), mode)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_axes_to_coords_batched_per_block_shapes():
    """(B, 1, ndim) shapes broadcast against (B, S, ndim) indices: each
    block's coordinates are its own grid's."""
    shapes = np.array([[4, 5, 6], [7, 1, 3]], np.int32)
    rng = np.random.default_rng(2)
    axes = np.stack([rng.integers(0, s, (10, 3)) for s in shapes])
    out = tc.axes_to_coords(torch.from_numpy(axes),
                            torch.from_numpy(shapes).long()[:, None, :],
                            "-1,1").numpy()
    for b in range(2):
        ref = np.asarray(jc.axes_to_coords(jnp.asarray(axes[b]),
                                           jnp.asarray(shapes[b]), "-1,1"))
        np.testing.assert_array_equal(out[b], ref)
