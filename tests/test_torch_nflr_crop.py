"""The port's NFLR crop pipeline and transforms
(brief_pytorch_tpu_torch/nflr/{crop,transform}.py) against the JAX
package's, on the CPU.

crop_data, the patch starts and the overlap weights exactly; the
CroppedSampler's draws exactly (the same np.random.default_rng
permutation, so the same indices and values), its coordinates within 2
units in the last place (jnp.linspace's float32 values come out of XLA's
division code; the port's are within half a unit of the exact linspace,
as core/coords.py's); CropDataset's batches and sideinfos the same way;
reconstruct_cropped's merge within 1e-6 of the JAX package's on the same
decoded patches; the transforms exactly under the same
`random` seed.
"""
import random

import numpy as np
import pytest
import torch

from brief_pytorch_tpu.nflr import crop as jc
from brief_pytorch_tpu.nflr import transform as jt
from brief_pytorch_tpu_torch.nflr import crop as pc
from brief_pytorch_tpu_torch.nflr import transform as pt
from torch_nflr_common import write_volumes

CROP = dict(ps_d=4, ps_h=8, ps_w=8, ol_d=2, ol_h=4, ol_w=3)


def _data(seed=0, shape=(2, 1, 8, 12, 13)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _coords_close(port, jax_coords):
    np.testing.assert_allclose(port.numpy(), np.asarray(jax_coords),
                               rtol=0, atol=2 * 2.0 ** -23)


def test_patch_coords_are_the_rounded_linspace():
    for n in (4, 8, 13):
        c = pc.flattened_coords((n, 2, 3))
        np.testing.assert_allclose(c[::6, 0].numpy(), np.linspace(-1, 1, n),
                                   rtol=0, atol=2.0 ** -24)


def test_crop_data_and_starts_equal_jax():
    data = _data()
    a, pca = pc.crop_data(data, **CROP)
    b, pcb = jc.crop_data(data, **CROP)
    assert pca == pcb
    np.testing.assert_array_equal(a, b)
    for n, ps, ol in ((64, 8, 2), (512, 8, 2), (13, 8, 3), (8, 8, 2)):
        sa, na = pc._patch_starts(n, ps, ol)
        sb, nb = jc._patch_starts(n, ps, ol)
        assert na == nb
        np.testing.assert_array_equal(sa, sb)
    np.testing.assert_array_equal(pc.overlap_weights((4, 8, 8)),
                                  jc.overlap_weights((4, 8, 8)))


@pytest.mark.parametrize("sample_size,shuffle", [(48, True), (256, True),
                                                 (100, False)])
def test_sampler_draws_equal_jax(sample_size, shuffle):
    """Two epochs of batches: the same permutation, the same values and
    coordinates, on torch tensors."""
    cropped, _ = pc.crop_data(_data(1), **CROP)
    js = jc.CroppedSampler(cropped, sample_size, shuffle, seed=5)
    ps = pc.CroppedSampler(torch.from_numpy(cropped), sample_size, shuffle,
                           seed=5, device="cpu")
    assert len(js) == len(ps)
    for _ in range(2):
        for k, ((jcoord, jval), (pcoord, pval)) in enumerate(zip(js, ps)):
            if k == 0:
                np.testing.assert_array_equal(ps.idxs, js.idxs)
            assert isinstance(pval, torch.Tensor)
            np.testing.assert_array_equal(pval.numpy(), np.asarray(jval))
            _coords_close(pcoord, jcoord)


def test_crop_dataset_equal_jax(tmp_path):
    paths = write_volumes(tmp_path, 2)
    norm = {"name": "minmaxany_0_100"}
    crop = {"ps_d": 8, "ps_h": 8, "ps_w": 8, "ol_d": 2, "ol_h": 2,
            "ol_w": 2}
    jd = jc.CropDataset(2, 200, norm, None, crop, False, True,
                        data_path_list=paths, seed=3)
    pd = pc.CropDataset(2, 200, norm, None, crop, False, True,
                        data_path_list=paths, seed=3, device="cpu")
    for _ in range(2):      # a fresh sampler seed per draw
        (jcr, jsm, jpc, jside), = list(jd)
        (pcr, psm, ppc, pside), = list(pd)
        assert jpc == ppc and jside == pside
        np.testing.assert_array_equal(pcr.numpy(), np.asarray(jcr))
        for (a, b), (c, d) in zip(jsm, psm):
            np.testing.assert_array_equal(d.numpy(), np.asarray(b))
            _coords_close(c, a)


def test_reconstruct_cropped_equal_jax():
    """The same per-coordinate field decoded in chunks and merged with the
    centre-distance weights: within 1e-6 of the JAX package's; a constant
    field merges to itself."""
    shape = (2, 1, 8, 12, 13)

    def field(coords):
        c = coords[..., 0] * 3.0 + coords[..., 1] ** 2 - coords[..., 2]
        return c[..., None] * 10.0 + 50.0

    n, _, d, h, w = shape
    jpc = [jc._patch_starts(x, p, o)[1] for x, p, o in
           ((d, 4, 2), (h, 8, 4), (w, 8, 3))]
    bias = np.random.default_rng(2).normal(size=(n, *jpc, 1, 1))
    jout = jc.reconstruct_cropped(
        shape, 60, None, lambda c, m: field(c) + bias, **CROP)
    pout = pc.reconstruct_cropped(
        shape, 60, None, lambda c, m: field(c) + torch.from_numpy(bias),
        device="cpu", **CROP)
    np.testing.assert_allclose(pout, jout, rtol=1e-6, atol=1e-6)
    const = pc.reconstruct_cropped((1, 1, 8, 8, 8), 64, None,
                                   lambda c, m: torch.full(
                                       c.shape[:-1] + (1,), 7.0),
                                   ps_h=4, ps_w=4, ol_h=2, ol_w=2, ps_d=4,
                                   ol_d=2)
    np.testing.assert_allclose(const, 7.0, rtol=1e-6)


TRANSFORM = {
    "Resize3d": {"resize_d": 0, "resize_h": 0, "resize_w": 0},
    "RandomResize3d": {"resize_d_ratio": [0.8, 1.2],
                       "resize_h_ratio": [1, 1], "resize_w_ratio": [0.9, 1]},
    "Crop3d": {"crop_d": 6, "crop_h": 10, "crop_w": 11, "crop_d_start": 1},
    "RandomCrop3d": {"randomcrop_d": 5, "randomcrop_h": 8,
                     "randomcrop_w": 8},
    "FlipRoat3d": {"flip": True, "drot90": True, "hrot90": True,
                   "wrot90": True},
}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transforms_equal_jax(seed):
    data = _data(seed)
    random.seed(seed)
    a = pt.Transform.from_opt(TRANSFORM)(data)
    random.seed(seed)
    b = jt.Transform.from_opt(TRANSFORM)(data)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pt._trilinear_resize(data, (5, 9, 20)),
                                  jt._trilinear_resize(data, (5, 9, 20)))
    np.testing.assert_array_equal(
        pt.fliproat3d(data, True, False, True, True, False, True),
        jt.fliproat3d(data, True, False, True, True, False, True))
