"""2-D images and video in the port (brief_pytorch_tpu_torch) against the
JAX package, on the CPU.

I/O: the same arrays written and read by both packages' io/image.py
(PNG 8- and 16-bit, JPG, MP4) and io/yuv.py (planar I420, 8- and 10-bit)
come back equal, exactly.  End to end: the SingleTask command (`-g cpu`)
on a generated 96 x 96 PNG (coords_channel 2) and on a small MP4
(data_channel 3), and a 2-D total_1_2_2 DivideTask, against the JAX
package's NFGR.compress / compress_divide on the same files and configs
(the oracle is tests/test_media_e2e.py).  The two packages draw batches
from different generators, so the runs are held to PSNR within 1 dB; the
chunk names, shapes and dtypes must be equal.  The SingleTask runs both
start from the JAX package's initial weights (Compress.param.init_net_path,
raw binaries): on this 2-D image the initial draw alone moves PSNR by
several dB from seed to seed (24.4-33.2 dB after 200 steps over six port
seeds), which a 1 dB band between two single runs cannot absorb.
"""
import csv
import os

import numpy as np
import pytest
import torch

from brief_pytorch_tpu.core import config as jcfg
from brief_pytorch_tpu.io import image as jimage
from brief_pytorch_tpu.io import yuv as jyuv
from brief_pytorch_tpu.utils.logger import MyLogger as JLogger
from brief_pytorch_tpu_torch.cli import main as tcli
from brief_pytorch_tpu_torch.core import config as tcfg
from brief_pytorch_tpu_torch.io import image as timage
from brief_pytorch_tpu_torch.io import yuv as tyuv

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small CPU training steps: one intra-op thread, so that they do
    not contend with the other test processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OPT = """
Reproduc: {{seed: 42, benchmark: false, deterministic: true}}
Dataset: {{data_path: "{data_path}"}}
Log: {{outputs_dir: "{outputs_dir}", project_name: {project}, stdlog: false,
      tensorboard: false, time: false}}
CompressFramework:
  Name: NFGR
  Compress:
    divide: {{divide_type: {divide}, param_alloc: by_size,
             param_size_thres: 26, exception: none}}
    half: false
    sampler: {{name: randompoint, cube_count: 1, cube_len: {cube_len},
              sample_size: 4096, gpu_force: true}}
    coords_mode: "-1,1"
    preprocess:
      denoise: {{level: 0, close: {close}}}
      clip: [0, 255]
    param: {{init_net_path: "{init}", filesize_ratio: 0,
            given_size: {given}}}
    loss: {{name: datal2, beta: 0.01, weight: [none], weight_thres: 255}}
    gpu: true
    max_steps: {steps}
    checkpoints: none
    loss_log_freq: 200
    lr_phi: 0.001
    optimizer_name_phi: Adamax
    lr_scheduler_phi: {{name: none}}
    decompress: true
  Decompress:
    sample_size: 8192
    gpu: true
    postprocess:
      denoise: {{level: 0, close: {close}}}
      clip: [0, 255]
    keep_decompressed: true
    mip: false
    mse: true
    psnr: true
    ssim: false
  Module:
    phi: {{name: SIREN, coords_channel: {cc}, data_channel: {dc}, layers: 5,
          w0: 20, output_act: false, res: false}}
  Normalize: {{name: minmaxany_0_1}}
"""


def _yaml(tmp_path, data_path, project, cc, dc, steps, given,
          divide="none", init="none"):
    """The tests/test_media_e2e.py config as yaml text, for both
    packages' loaders (init: Compress.param.init_net_path)."""
    nd = cc
    text = OPT.format(data_path=data_path, outputs_dir=str(tmp_path),
                      project=project, divide=divide,
                      cube_len=[10000000] * nd, close=[2] * nd, given=given,
                      steps=steps, cc=cc, dc=dc, init=init)
    path = str(tmp_path / f"{project}.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


def _psnr(run_dir):
    with open(os.path.join(run_dir, "performance.csv")) as f:
        return float(list(csv.DictReader(f))[-1]["psnr"])


def _pattern(n=96):
    x = np.linspace(0, 2 * np.pi, n)
    return ((np.sin(x[:, None]) * np.cos(x[None, :]) * 0.5 + 0.5)
            * 255).astype(np.uint8)[..., None]


def _frames():
    rng = np.random.default_rng(0)
    base = rng.integers(40, 200, (1, 6, 8, 3), dtype=np.uint8)
    return np.repeat(np.repeat(np.repeat(base, 4, axis=0), 8, axis=1),
                     8, axis=2)


# --- I/O ---------------------------------------------------------------------
def _arrays():
    rng = np.random.default_rng(1)
    return {
        "png8": (".png", rng.integers(0, 256, (40, 56, 1)).astype(np.uint8)),
        "png16": (".png",
                  rng.integers(0, 65536, (40, 56, 1)).astype(np.uint16)),
        "png_bgr": (".png",
                    rng.integers(0, 256, (40, 56, 3)).astype(np.uint8)),
        "jpg": (".jpg", _pattern(64).repeat(3, axis=-1)),
        "mp4": (".mp4", _frames()),
    }


@pytest.mark.parametrize("kind", list(_arrays()))
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_read_save_img_equal_jax(tmp_path, kind, writer):
    """Each package reads what either wrote to the same array; the
    lossless formats give back the written array, the lossy ones (JPG,
    MP4) the same decoded array in both, of the reference's layout."""
    ext, arr = _arrays()[kind]
    path = str(tmp_path / f"a{ext}")
    (timage if writer == "torch" else jimage).save_img(path, arr)
    ours, theirs = timage.read_img(path), jimage.read_img(path)
    assert ours.dtype == theirs.dtype == arr.dtype
    assert ours.shape == theirs.shape == arr.shape
    assert np.array_equal(ours, theirs)
    if kind.startswith("png"):
        assert np.array_equal(ours, arr)
    assert timage.get_dimension(path) == jimage.get_dimension(path) == \
        (3 if ext == ".mp4" else 2)


def test_read_img_raises_on_unknown_and_missing(tmp_path):
    with pytest.raises(NotImplementedError):
        timage.read_img(str(tmp_path / "a.bmp"))
    with pytest.raises(ValueError):
        timage.read_img(str(tmp_path / "missing.png"))


@pytest.mark.parametrize("bits", ["8bit", "10bit"])
def test_yuv_equal_jax(tmp_path, bits):
    """Planar I420 frames: the planes and the BGR frames equal the JAX
    package's, byte for byte."""
    h, w, n = 16, 24, 3
    per = h * w * 3 // 2 * (2 if bits == "10bit" else 1)
    raw = np.random.default_rng(2).integers(0, 256, per * (n + 1),
                                            dtype=np.uint8)
    path = str(tmp_path / "v.yuv")
    raw.tofile(path)
    ours = tyuv.yuv_import(path, (h, w), n, 1, bits)
    theirs = jyuv.yuv_import(path, (h, w), n, 1, bits)
    for a, b in zip(ours, theirs):
        assert len(a) == len(b) == n
        assert all(np.array_equal(x, y) and x.dtype == np.uint8
                   for x, y in zip(a, b))
    for a, b in zip(tyuv.yuv2bgr(path, h, w, n, 0, bits, crop=None),
                    jyuv.yuv2bgr(path, h, w, n, 0, bits, crop=None)):
        assert np.array_equal(a, b)


# --- the SingleTask command on a PNG and an MP4 ------------------------------
@pytest.mark.parametrize("kind", ["png", "mp4"])
def test_singletask_media_psnr_within_1db_of_jax(tmp_path, kind):
    """`cli.main -g cpu` on a 96 x 96 PNG (coords_channel 2, 800 steps) or
    a 4 x 48 x 64 x 3 MP4 (data_channel 3, 500 steps), against JAX
    NFGR.compress on the same file, yaml and initial weights: PSNR within
    1 dB; the
    decompressed file keeps the input's extension, shape and dtype; the
    standalone decompress equals the checkpoint's decode (PNG)."""
    from brief_pytorch_tpu.train.fit import NFGR as JNFGR
    from brief_pytorch_tpu_torch.train.fit import NFGR
    if kind == "png":
        arr, cc, dc, steps, given = _pattern(), 2, 1, 800, 4000
    else:
        arr, cc, dc, steps, given = _frames(), 3, 3, 500, 6000
    import jax
    from brief_pytorch_tpu.io.modelsave import save_model
    from brief_pytorch_tpu.models import sizing as js
    from brief_pytorch_tpu.models.phi import init_phi as jinit
    data = str(tmp_path / f"m.{kind}")
    timage.save_img(data, arr)
    arr = timage.read_img(data)
    phi = {"name": "SIREN", "coords_channel": cc, "data_channel": dc,
           "layers": 5, "w0": 20, "output_act": False, "res": False}
    phi["features"] = js.estimate_module_size(given, dict(phi), False)[0]
    init = str(tmp_path / "init")
    save_model(jax.tree_util.tree_map(np.asarray, jinit(phi).init(
        jax.random.PRNGKey(42)))["layers"], init)
    path = _yaml(tmp_path, data, "torch", cc, dc, steps, given, init=init)
    summary = tcli.main(["-p", path, "-g", "cpu"])
    jpath = _yaml(tmp_path, data, "jax", cc, dc, steps, given, init=init)
    jopt = jcfg.load(jpath)
    jlog = JLogger(**jopt.Log.to_plain())
    jres = JNFGR(jopt.CompressFramework, logger=jlog, seed=42).compress(data)
    tp, jp = _psnr(str(tmp_path / "torch")), float(jres["psnr"])
    assert summary["psnr"] == tp and np.isfinite(tp)
    assert abs(tp - jp) <= 1.0, (tp, jp)
    step = tmp_path / "torch" / f"steps{steps}"
    dec = timage.read_img(str(step / "decompressed" /
                              f"m_decompressed.{kind}"))
    assert dec.shape == arr.shape and dec.dtype == arr.dtype
    assert not (step / "mip").exists()
    if kind == "png":
        comp = step / "compressed"
        standalone = NFGR.decompress(path, str(comp / "module"),
                                     str(comp / "sideinfos.yaml"),
                                     device="cpu")
        assert np.array_equal(standalone, dec)


def test_2d_divide_module_names_equal_jax(tmp_path):
    """The 2-D total_1_2_2 DivideTask (test_media_e2e.py:112): the port's
    four h_*-w_* module names and side information equal the JAX
    package's, and the port's standalone decompress_divide is within 1 LSB
    of its merged checkpoint.  (Each package initialises its blocks from
    its own generator, so their PSNRs after 200 steps are not compared.)"""
    import yaml
    from brief_pytorch_tpu.parallel.divide_runner import compress_divide
    from brief_pytorch_tpu_torch.train.fit import NFGR
    data = str(tmp_path / "img.png")
    timage.save_img(data, _pattern())
    steps = 200
    path = _yaml(tmp_path, data, "torch", 2, 1, steps, 8000, "total_1_2_2")
    summary = tcli.main(["-p", path, "-g", "cpu"])
    jpath = _yaml(tmp_path, data, "jax", 2, 1, steps, 8000, "total_1_2_2")
    jopt = jcfg.load(jpath)
    jres = compress_divide(jopt, JLogger(**jopt.Log.to_plain()))
    comp = {p: tmp_path / p / f"steps{steps}" / "compressed"
            for p in ("torch", "jax")}
    names = sorted(os.listdir(comp["torch"] / "module"))
    assert names == sorted(os.listdir(comp["jax"] / "module")) == [
        "h_0_47-w_0_47", "h_0_47-w_48_95", "h_48_95-w_0_47",
        "h_48_95-w_48_95"]
    for n in names:
        sides = [yaml.safe_load(open(comp[p] / "sideinfos" / n /
                                     "sideinfos.yaml")) for p in comp]
        assert sides[0] == sides[1], n
    assert summary["fleet"][0]["blocks"] == 4
    assert np.isfinite(summary["psnr"]) and np.isfinite(jres["psnr"])
    c = comp["torch"]
    dec = NFGR.decompress_divide(path, str(c / "sideinfos.yaml"),
                                 str(c / "module"), str(c / "sideinfos"),
                                 device="cpu")
    ck = timage.read_img(str(tmp_path / "torch" / f"steps{steps}" /
                             "decompressed" / "img_decompressed.png"))
    assert dec.shape == ck.shape == (96, 96, 1) and dec.dtype == np.uint8
    assert np.abs(dec.astype(int) - ck.astype(int)).max() <= 1
