"""The port's preprocessing, I/O, config, normalisation, model and
train-state files against the JAX package and scipy.

The port replaces scipy.ndimage.binary_opening by a NumPy box opening and
cv2's TIFF path by a minimal codec; both must give identical results.
Raw weight binaries must be byte-identical to the JAX package's.
"""
import os

import numpy as np
import pytest
from scipy import ndimage

import torch

from brief_pytorch_tpu.core import config as jcfg
from brief_pytorch_tpu.core import normalize as jnorm
from brief_pytorch_tpu.io import image as jimg
from brief_pytorch_tpu.io import modelsave as jms
from brief_pytorch_tpu.post import preprocess as jpre
from brief_pytorch_tpu_torch.core import config as tcfg
from brief_pytorch_tpu_torch.core import normalize as tnorm
from brief_pytorch_tpu_torch.io import image as timg
from brief_pytorch_tpu_torch.io import modelsave as tms
from brief_pytorch_tpu_torch.post import preprocess as tpre


@pytest.mark.parametrize("size", [(2, 2, 2, 1), (3, 3, 3, 1), (2, 3, 1, 1),
                                  (1, 1, 1, 1), (4, 2, 3, 1)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binary_opening_matches_scipy(size, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((7, 8, 9, 1)) < 0.7
    ref = ndimage.binary_opening(mask, structure=np.ones(size), iterations=1)
    np.testing.assert_array_equal(tpre.binary_opening_box(mask, size), ref)


@pytest.mark.parametrize("level,close,shape", [
    (0, [2, 2, 2], (10, 11, 12, 1)),
    (300, [2, 2, 2], (10, 11, 12, 1)),
    (300, False, (10, 11, 12, 1)),
    (500, [3, 3], (20, 21, 1)),
])
def test_preprocess_matches_jax(level, close, shape):
    rng = np.random.default_rng(3)
    data = rng.integers(0, 1000, shape).astype(np.uint16)
    ref = jpre.preprocess(data.copy(), level, close, [0, 900])
    out = tpre.preprocess(data.copy(), level, close, [0, 900])
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("rules", [
    ["value_65535_65535_1"], ["value_100_400_3"], ["quantile_10_0.2_0.8_2"],
    ["exp_1000_0.5"], ["none"], ["value_100_400_3", "value_300_600_5"],
])
def test_parse_weight_matches_jax(rules):
    data = np.random.default_rng(4).integers(0, 1000, (6, 7, 8, 1)).astype(
        np.uint16)
    np.testing.assert_array_equal(tpre.parse_weight(data, rules),
                                  jpre.parse_weight(data, rules))


@pytest.mark.parametrize("spec", ["none", "every_2000", "every_7", 500,
                                  30000, "100,250,999999"])
def test_parse_checkpoints_matches_jax(spec):
    assert tpre.parse_checkpoints(spec, 20000) == \
        jpre.parse_checkpoints(spec, 20000)


@pytest.mark.parametrize("name", ["minmaxany_0_100", "minmax01_0mean",
                                  "minmax01_0mean1std", "none"])
def test_normalize_round_trip_matches_jax(name):
    data = np.random.default_rng(5).integers(10, 60000, (4, 5, 6, 1)).astype(
        np.uint16)
    tn, ts = tnorm.normalize_data(data, name)
    jn, js = jnorm.normalize_data(data, name)
    np.testing.assert_array_equal(tn, jn)
    assert ts == js
    if name in ("minmaxany_0_100", "none"):
        np.testing.assert_array_equal(tnorm.invnormalize_data(tn, ts, name),
                                      jnorm.invnormalize_data(jn, js, name))


def test_fixture_reads_like_jax():
    path = "dataset/brain/64x64x64/brain-64_128-64_128-192_256.tif"
    out = timg.read_img(path)
    assert out.shape == (64, 64, 64, 1) and out.dtype == np.uint16
    np.testing.assert_array_equal(out, jimg.read_img(path))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_tiff_round_trip_and_jax_reads_it(tmp_path, dtype):
    vol = (np.random.default_rng(6).random((5, 16, 12, 1)) * 250).astype(dtype)
    p = str(tmp_path / "v.tif")
    timg.save_img(p, vol)
    np.testing.assert_array_equal(timg.read_img(p), vol)
    np.testing.assert_array_equal(jimg.read_img(p), vol)


def test_reads_jax_written_tiff(tmp_path):
    vol = np.random.default_rng(7).integers(0, 65535, (4, 9, 10, 1),
                                            dtype=np.uint16)
    p = str(tmp_path / "j.tif")
    jimg._write_tiff_minimal(p, vol[..., 0])
    np.testing.assert_array_equal(timg.read_img(p), vol)


def test_png_reads_back_with_cv2(tmp_path):
    cv2 = pytest.importorskip("cv2")
    for dtype in (np.uint8, np.uint16):
        img = np.random.default_rng(8).integers(0, 200, (13, 17, 1)).astype(
            dtype)
        p = str(tmp_path / f"i{np.dtype(dtype).itemsize}.png")
        timg.save_img(p, img)
        np.testing.assert_array_equal(cv2.imread(p, -1), img[..., 0])


def test_model_binaries_byte_identical_to_jax(tmp_path):
    rng = np.random.default_rng(9)
    layers = [{"w": rng.normal(size=(3, 22)).astype(np.float32),
               "b": rng.normal(size=(22,)).astype(np.float32)},
              {"w": rng.normal(size=(22, 1)).astype(np.float32),
               "b": rng.normal(size=(1,)).astype(np.float32)}]
    tms.save_model(layers, str(tmp_path / "t"))
    jms.save_model(layers, str(tmp_path / "j"))
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes()
    for a, b in zip(tms.load_model(str(tmp_path / "j")), layers):
        for k in ("w", "b"):
            np.testing.assert_array_equal(a[k], b[k])


def test_config_load_and_save_round_trip(tmp_path):
    path = "opt/SingleTask/default.yaml"
    t, j = tcfg.load(path), jcfg.load(path)
    assert t.to_plain() == j.to_plain()
    assert t.CompressFramework.Module.phi.layers == 5
    t.CompressFramework.Compress.max_steps = 7
    tcfg.save(t, str(tmp_path / "c.yaml"))
    back = jcfg.load(str(tmp_path / "c.yaml"))
    assert back.CompressFramework.Compress.max_steps == 7
    assert back.to_plain() == t.to_plain()


def test_trainstate_npz(tmp_path):
    from brief_pytorch_tpu_torch.train.checkpoint import save_trainstate
    params = {"layers": [{"w": torch.ones(3, 2), "b": torch.zeros(2)}]}
    opt_state = {"count": 5, "mu": [torch.full((3, 2), 0.5), torch.ones(2)],
                 "nu": [torch.full((3, 2), 2.0), torch.ones(2)]}
    gen = torch.Generator().manual_seed(3)
    path = str(tmp_path / "trainstate.npz")
    save_trainstate(path, params, opt_state, gen, 5, {"kind": "single"})
    assert not os.path.exists(path + ".tmp")
    with np.load(path) as z:
        assert int(z["step"]) == 5
        # p{i} in jax.tree_util order (the JAX package's pack_tree): b, w
        np.testing.assert_array_equal(z["p0"], np.zeros(2))
        np.testing.assert_array_equal(z["p1"], np.ones((3, 2)))
        assert int(z["o0"]) == 5
        np.testing.assert_array_equal(z["o1"], np.full((3, 2), 0.5))
        np.testing.assert_array_equal(z["key"], gen.get_state().numpy())
        assert bytes(z["fingerprint"].tobytes()) == b'{"kind": "single"}'
