"""The repository's demo volumes (dataset/example/*-0_64-0_512-0_512.tif,
LZW with a horizontal predictor) in the port: read to the same array as
the JAX package reads them, sized as the JAX package sizes
opt/SingleTask/default.yaml on them, and a SingleTask CLI run on an
LZW crop whose archive the JAX package decodes to the port's values.

The decodes differ by float32 rounding of the coordinates and the sums,
as in the `family` cases of tests/test_torch_fit.py: decoded uint16
voxels within 2 steps and PSNR within 0.02 dB.
"""
import copy
import os
import struct

import numpy as np
import pytest

from brief_pytorch_tpu.io.image import read_tiff as jread_tiff
from brief_pytorch_tpu.models import sizing as jsizing
from brief_pytorch_tpu.train.fit import NFGR as JNFGR
from brief_pytorch_tpu_torch.core import config as tcfg
from brief_pytorch_tpu_torch.eval.metrics import cal_psnr
from brief_pytorch_tpu_torch.io.image import read_img, read_tiff
from brief_pytorch_tpu_torch.models import sizing as tsizing
from brief_pytorch_tpu_torch.train.fit import NFGR as TNFGR

DEMO = {name: os.path.join("dataset", "example",
                           f"{name}-0_64-0_512-0_512.tif")
        for name in ("hipct", "vessel")}


def _compression(path: str) -> int:
    """Tag 259 of the first page of a little-endian classic TIFF."""
    with open(path, "rb") as f:
        head = f.read(8)
        assert head[:4] == b"II*\x00"
        (off,) = struct.unpack("<I", head[4:8])
        f.seek(off)
        data = bytes(off) + f.read(2 + 12 * 64)
    (n,) = struct.unpack("<H", data[off:off + 2])
    for i in range(n):
        tag, _, _, val = struct.unpack("<HHIH", data[off + 2 + 12 * i:
                                                     off + 12 + 12 * i])
        if tag == 259:
            return val
    return 1


@pytest.mark.parametrize("name", sorted(DEMO))
def test_demo_volume_reads_as_in_jax(name):
    path = DEMO[name]
    assert _compression(path) == 5            # LZW
    got = read_img(path)
    want = jread_tiff(path)
    assert got.shape == (64, 512, 512, 1) and got.dtype == np.uint16
    assert np.array_equal(got[..., 0], want)


@pytest.mark.parametrize("ratio,features", [(80, 191), (50, 242)])
@pytest.mark.parametrize("name", sorted(DEMO))
def test_demo_volume_sizes_as_in_jax(name, ratio, features):
    """opt/SingleTask/default.yaml's SIREN on a demo volume at `ratio`:
    the port's NFGR budget and sizing give the JAX package's width."""
    opt = tcfg.load("opt/SingleTask/default.yaml").CompressFramework
    opt.Compress.param.filesize_ratio = ratio
    ideal = TNFGR(opt, device="cpu").parse_param_size(DEMO[name])
    assert ideal == os.path.getsize(DEMO[name]) / ratio
    phi = dict(opt.Module.phi)
    t = tsizing.estimate_module_size(ideal, dict(phi), False)
    j = jsizing.estimate_module_size(ideal, dict(phi), False)
    assert t[0] == j[0] == features
    assert t[1] == j[1] == 3 * features + features + \
        3 * (features * features + features) + features + 1


def test_uncompressed_tiff_still_reads_without_cv2(tmp_path, monkeypatch):
    """The port's own reader takes uncompressed TIFF (cv2 is not asked);
    a compressed file on a host without cv2 raises, naming cv2."""
    import builtins
    from brief_pytorch_tpu_torch.io.image import save_img
    vol = np.arange(2 * 3 * 5, dtype=np.uint16).reshape(2, 3, 5, 1)
    path = str(tmp_path / "v.tif")
    save_img(path, vol)
    real_import = builtins.__import__

    def no_cv2(name, *a, **kw):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    assert np.array_equal(read_img(path), vol)
    with pytest.raises(ValueError, match="cv2"):
        read_tiff(DEMO["hipct"])


def test_cli_on_an_lzw_crop_decodes_in_both_packages(tmp_path):
    """A 16x64x64 crop of the HiP-CT demo volume written as LZW by cv2,
    given_size set so that the default yaml sizes to 5 x 191 (the width the
    whole volume gives at 80x), randompoint 2,048, 5 steps on the CPU; the
    archive decodes through the JAX package to the port's values."""
    import cv2
    from brief_pytorch_tpu_torch.cli import main as cli
    crop = read_img(DEMO["hipct"])[:16, :64, :64, 0]
    data_path = str(tmp_path / "hipct-crop.tif")
    assert cv2.imwritemulti(data_path, list(crop),
                            [cv2.IMWRITE_TIFF_COMPRESSION, 5])
    assert _compression(data_path) == 5
    opt = tcfg.load("opt/SingleTask/default.yaml")
    opt.Dataset.data_path = data_path
    opt.Log.outputs_dir = str(tmp_path)
    opt.Log.tensorboard = False
    opt.Log.time = False
    c = opt.CompressFramework
    c.Compress.max_steps = 5
    c.Compress.checkpoints = "none"
    c.Compress.sampler.name = "randompoint"
    c.Compress.sampler.sample_size = 2048
    c.Compress.param.filesize_ratio = 0
    c.Compress.param.given_size = 4 * 110_972
    c.Decompress.mip = False
    yaml_path = str(tmp_path / "crop.yaml")
    tcfg.save(opt, yaml_path)
    summary = cli.main(["-p", yaml_path, "-g", "cpu"])
    assert summary["steps"] == 5 and np.isfinite(summary["psnr"])
    comp = os.path.join(str(tmp_path), opt.Log.project_name, "steps5",
                        "compressed")
    import yaml
    side = yaml.safe_load(open(os.path.join(comp, "sideinfos.yaml")))
    assert side["phi_features"] == 191
    module, sides = os.path.join(comp, "module"), \
        os.path.join(comp, "sideinfos.yaml")
    by_torch = TNFGR.decompress(copy.deepcopy(c), module, sides,
                                device="cpu")
    by_jax = JNFGR.decompress(copy.deepcopy(c), module, sides)
    vol = crop[..., None]
    assert by_torch.shape == by_jax.shape == vol.shape
    assert by_torch.dtype == by_jax.dtype == np.uint16
    diff = np.abs(by_torch.astype(np.int64) - by_jax.astype(np.int64))
    assert diff.max() <= 2, int(diff.max())
    assert abs(cal_psnr(vol, by_torch, 65535)
               - cal_psnr(vol, by_jax, 65535)) < 0.02
