"""The SingleTask slice end to end: the port's NFGR.compress (-g cpu)
against the JAX package's (CPU, XLA path) on the same volume and the same
initial weights, and each package decoding the other's artifacts.

Setup: a 16^3 uint16 volume written as TIFF; SIREN 3 x 16; randomcube
covering the whole volume (one position, so the batch has no
randomness); both packages warm-start from the same raw weight binaries
(Compress.param.init_net_path).  Both train through autograd with the
fast sine and Adamax; they differ only in float32 summation order, so the
per-step losses agree to rtol 1e-3 over 40 steps and the PSNRs to 0.05 dB.
The decodes differ by the plane-coordinate formula (axis_linspace in the
port's kernel path vs the JAX slab path's affine coordinates, ~1e-5), so
decoded voxels agree to 2 uint16 steps.
"""
import copy
import os

import numpy as np
import pytest

import torch

from brief_pytorch_tpu.core import config as jcfg
from brief_pytorch_tpu.io.modelsave import save_model as jsave_model
from brief_pytorch_tpu.models.phi import init_phi as jinit
from brief_pytorch_tpu.train.fit import NFGR as JNFGR
from brief_pytorch_tpu.utils.logger import MyLogger as JLogger
from brief_pytorch_tpu_torch.eval.metrics import cal_psnr
from brief_pytorch_tpu_torch.io.image import read_img, save_img
from brief_pytorch_tpu_torch.train.fit import NFGR as TNFGR
from brief_pytorch_tpu_torch.utils.logger import MyLogger as TLogger

STEPS = 40
F = 16


def _recording(cls):
    class Recording(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.losses = {}

        def log_metrics(self, metrics, step):
            if "loss" in metrics:
                self.losses[step] = float(metrics["loss"])
            super().log_metrics(metrics, step)
    return Recording


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    root = tmp_path_factory.mktemp("fit")
    rng = np.random.default_rng(0)
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, 16)] * 3, indexing="ij")
    vol = 20000 + 15000 * np.sin(3 * x) * np.cos(2 * y) + 8000 * z \
        + rng.normal(0, 500, x.shape)
    vol = np.clip(vol, 0, 65535).astype(np.uint16)[..., None]
    data_path = str(root / "vol16.tif")
    save_img(data_path, vol)

    cfg = {"name": "SIREN", "coords_channel": 3, "data_channel": 1,
           "features": F, "layers": 3, "w0": 20}
    params = jinit(cfg).init(jax.random.PRNGKey(3))
    init_dir = str(root / "init")
    jsave_model([{k: np.asarray(v) for k, v in l.items()}
                 for l in params["layers"]], init_dir)

    opt = jcfg.load("opt/SingleTask/default.yaml")
    c = opt.CompressFramework
    c.Compress.max_steps = STEPS
    c.Compress.checkpoints = f"every_{STEPS // 2}"
    c.Compress.loss_log_freq = 1
    c.Compress.param.filesize_ratio = 0
    c.Compress.param.given_size = 4 * (3 * F + F + F * F + F + F + 1)
    c.Compress.param.init_net_path = init_dir
    c.Module.phi.layers = 3
    c.Decompress.mip = False

    out = {"data_path": data_path, "vol": vol, "opt": opt}
    for name, nfgr, logger in [("jax", JNFGR, JLogger),
                               ("torch", TNFGR, TLogger)]:
        log = _recording(logger)(project_name=name,
                                 outputs_dir=str(root / "out"),
                                 stdlog=False, tensorboard=False)
        o = copy.deepcopy(opt.CompressFramework)
        kw = {"device": "cpu"} if name == "torch" else {}
        summary = nfgr(o, logger=log, seed=42, **kw).compress(data_path)
        comp = os.path.join(log.logdir, f"steps{STEPS}", "compressed")
        out[name] = {"summary": summary, "losses": log.losses,
                     "module": os.path.join(comp, "module"),
                     "sideinfos": os.path.join(comp, "sideinfos.yaml"),
                     "logdir": log.logdir}
    return out


def test_per_step_losses_agree(runs):
    j, t = runs["jax"]["losses"], runs["torch"]["losses"]
    assert sorted(j) == sorted(t) == list(range(1, STEPS + 1))
    jl = np.array([j[s] for s in sorted(j)])
    tl = np.array([t[s] for s in sorted(t)])
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]        # it trains


def test_checkpoints_psnr_and_artifacts_agree(runs):
    js, ts = runs["jax"]["summary"], runs["torch"]["summary"]
    assert ts["steps"] == js["steps"] == STEPS
    assert abs(ts["psnr"] - js["psnr"]) < 0.05
    assert abs(ts["ssim"] - js["ssim"]) < 2e-3
    assert ts["compress_ratio/theory"] == pytest.approx(
        js["compress_ratio/theory"], rel=1e-3)
    for d in (runs["jax"]["logdir"], runs["torch"]["logdir"]):
        rows = open(os.path.join(d, "performance.csv")).read().splitlines()
        assert rows[0] == "steps,mse,psnr,ssim,loss" and len(rows) == 3
    assert sorted(os.listdir(runs["jax"]["module"])) == \
        sorted(os.listdir(runs["torch"]["module"]))
    import yaml
    jside = yaml.safe_load(open(runs["jax"]["sideinfos"]))
    tside = yaml.safe_load(open(runs["torch"]["sideinfos"]))
    assert jside == tside
    assert os.path.exists(os.path.join(runs["torch"]["logdir"],
                                       "trainstate.npz"))


def test_each_package_decodes_the_others_artifacts(runs):
    vol = runs["vol"]
    c = runs["opt"].CompressFramework
    for src in ("jax", "torch"):
        r = runs[src]
        by_jax = JNFGR.decompress(copy.deepcopy(c), r["module"],
                                  r["sideinfos"])
        by_torch = TNFGR.decompress(copy.deepcopy(c), r["module"],
                                    r["sideinfos"], device="cpu")
        assert by_torch.shape == by_jax.shape == vol.shape
        assert by_torch.dtype == by_jax.dtype == np.uint16
        diff = np.abs(by_torch.astype(np.int64) - by_jax.astype(np.int64))
        assert diff.max() <= 2, src
        assert abs(cal_psnr(vol, by_torch, 65535)
                   - cal_psnr(vol, by_jax, 65535)) < 0.01


def test_cli_runs_on_cpu(tmp_path, runs):
    from brief_pytorch_tpu_torch.cli import main as cli
    from brief_pytorch_tpu_torch.core import config as tcfg
    opt = tcfg.loads(open("opt/SingleTask/default.yaml").read())
    opt.Dataset.data_path = runs["data_path"]
    opt.Log.outputs_dir = str(tmp_path)
    opt.Log.tensorboard = False
    opt.Log.time = False
    c = opt.CompressFramework
    c.Compress.max_steps = 5
    c.Compress.checkpoints = "none"
    c.Compress.param = runs["opt"].CompressFramework.Compress.param.to_plain()
    c.Module.phi.layers = 3
    c.Decompress.mip = True
    p = str(tmp_path / "t.yaml")
    tcfg.save(opt, p)
    summary = cli.main(["-p", p, "-g", "cpu"])
    assert summary["steps"] == 5 and np.isfinite(summary["psnr"])
    mips = os.listdir(tmp_path / "single" / "steps5" / "mip")
    assert len(mips) == 12
    # a divide_type other than none runs DivideTask on the same CLI
    opt.CompressFramework.Compress.divide.divide_type = "total_2_2_2"
    opt.CompressFramework.Compress.param.init_net_path = "none"
    opt.Log.project_name = "divide"
    tcfg.save(opt, p)
    summary = cli.main(["-p", p, "-g", "cpu"])
    assert summary["steps"] == 5 and np.isfinite(summary["psnr"])
    assert len(os.listdir(tmp_path / "divide" / "steps5" / "compressed" /
                          "module")) == 8


def test_unported_options_raise(runs, monkeypatch):
    """`half` raised here until it was ported and now constructs;
    Compress.data_shards > 1 raised until data parallelism was ported and
    now needs a process group of that many ranks: without one it raises
    ValueError naming the CLI and its flags.  With one (its size faked
    here), compress refuses randomcube and vector_len > 1, as the JAX
    package does (fit.py:226-232, 294-299)."""
    c = copy.deepcopy(runs["opt"].CompressFramework)
    c.Compress.half = True
    assert TNFGR(c, device="cpu").half
    c.Compress.half = False
    c.Compress.data_shards = 2
    with pytest.raises(ValueError, match="-coordinator"):
        TNFGR(c, device="cpu")
    from brief_pytorch_tpu_torch.parallel import mesh
    monkeypatch.setattr(mesh, "world", lambda: 2)
    for sampler, match in (({"name": "randomcube"}, "randompoint"),
                           ({"name": "randompoint", "vector_len": 4},
                            "vector_len")):
        cs = copy.deepcopy(c)
        cs.Compress.sampler.update(sampler)
        with pytest.raises(ValueError, match=match):
            TNFGR(cs, device="cpu").compress(runs["data_path"])


# --- the whole φ zoo through NFGR.compress / NFGR.decompress ---------------
# Each family trains a few steps in both packages (their own inits and
# draws: only finiteness and the artifacts' kind and names are compared
# between the runs), then each package decodes BOTH archives.  The same
# weights through the two decoders differ by float32 rounding of the
# coordinates and the sums: decoded uint16 voxels within 2 steps and PSNR
# within 0.02 dB.
ZOO = {
    "SIREN": {"res": True}, "SIRENFT": {"ratio": 2.2},
    "SIREN_Pyramid": {"features_dis": 2}, "SIRENPS": {"ratio": 1.3},
    "SIREN_RELU": {}, "SIREN_SIGMOID": {}, "SIRENPos": {"T": [2.0, 3.0, 2.0]},
    "NeRF": {"frequencies": 3}, "FFN": {"embsize": 8, "scale": 4},
    "MFNFourier": {}, "MFNGabor": {},
}
ZOO_STEPS = 6


@pytest.fixture(scope="module")
def zoo_volume(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo")
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, 12)] * 3, indexing="ij")
    vol = 30000 + 12000 * np.sin(2 * x + y) * np.cos(2 * z)
    path = str(root / "vol12.tif")
    save_img(path, vol.astype(np.uint16)[..., None])
    return path, vol.astype(np.uint16)[..., None]


@pytest.mark.parametrize("name", sorted(ZOO))
def test_family_archives_cross_the_packages(name, zoo_volume, tmp_path):
    data_path, vol = zoo_volume
    opt = jcfg.load("opt/SingleTask/default.yaml")
    c = opt.CompressFramework
    c.Compress.max_steps = ZOO_STEPS
    c.Compress.checkpoints = "none"
    c.Compress.param.filesize_ratio = 0
    c.Compress.param.given_size = 3200
    c.Module.phi.name = name
    c.Module.phi.layers = 4
    for k, v in ZOO[name].items():
        c.Module.phi[k] = v
    c.Decompress.mip = False
    c.Decompress.sample_size = 500      # several slabs per decode
    archives = {}
    for pkg, nfgr, logger in [("jax", JNFGR, JLogger),
                              ("torch", TNFGR, TLogger)]:
        log = logger(project_name=pkg, outputs_dir=str(tmp_path),
                     stdlog=False, tensorboard=False)
        o = copy.deepcopy(c)
        kw = {"device": "cpu"} if pkg == "torch" else {}
        summary = nfgr(o, logger=log, seed=42, **kw).compress(data_path)
        assert summary["steps"] == ZOO_STEPS and np.isfinite(summary["psnr"])
        assert np.isfinite(summary["loss"])
        comp = os.path.join(log.logdir, f"steps{ZOO_STEPS}", "compressed")
        archives[pkg] = (os.path.join(comp, "module"),
                         os.path.join(comp, "sideinfos.yaml"), o)
    jfiles, tfiles = (sorted(os.listdir(archives[p][0]))
                      for p in ("jax", "torch"))
    assert jfiles == tfiles      # same sizing, same shapes, same kind
    if name.startswith("MFN"):
        assert tfiles == ["params.npz"]
    else:
        assert any(f.startswith("weight-0-") for f in tfiles)
        assert ("encoder.npz" in tfiles) == (name == "FFN")
    import yaml
    sides = [yaml.safe_load(open(archives[p][1])) for p in ("jax", "torch")]
    assert sides[0] == sides[1]
    for src in ("jax", "torch"):
        module, side, o = archives[src]
        by_jax = JNFGR.decompress(copy.deepcopy(o), module, side)
        by_torch = TNFGR.decompress(copy.deepcopy(o), module, side,
                                    device="cpu")
        assert by_torch.shape == by_jax.shape == vol.shape
        assert by_torch.dtype == by_jax.dtype == np.uint16
        diff = np.abs(by_torch.astype(np.int64) - by_jax.astype(np.int64))
        assert diff.max() <= 2, (src, int(diff.max()))
        assert abs(cal_psnr(vol, by_torch, 65535)
                   - cal_psnr(vol, by_jax, 65535)) < 0.02, src


def test_autograd_step_walks_any_tree():
    """_autograd_step returns a gradient for every leaf of the tree, by the
    tree's keys; FFN's frozen bvals get zeros and stay bit-equal under the
    optimizer, as under optax in the JAX package."""
    from brief_pytorch_tpu_torch.models.phi import init_phi
    from brief_pytorch_tpu_torch.train.optim import make_optimizer
    from brief_pytorch_tpu_torch.train.samplers import RandomPointSampler
    model = init_phi({"name": "FFN", "coords_channel": 3, "data_channel": 1,
                      "features": 8, "layers": 3, "embsize": 4})
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    bvals = params["encoder"]["bvals"].clone()
    w0 = params["layers"][0]["w"].clone()
    sampler = RandomPointSampler((6, 6, 6), "n11", 64)
    data = torch.rand(216, 1)
    gen = torch.Generator().manual_seed(1)
    opt = make_optimizer("Adamax", 1e-2, {"name": "none"})
    state = opt.init(params)
    assert len(state["mu"]) == 2 * 3 + 1
    for _ in range(3):
        loss, grads = TNFGR._autograd_step(
            params, gen, model=model, sampler=sampler, data=data, weight=None,
            loss_name="datal2", beta=0.01, weight_thres=0.0)
        assert list(grads) == list(params)
        assert not grads["encoder"]["bvals"].any()
        opt.step(params, grads, state)
    assert torch.equal(params["encoder"]["bvals"], bvals)
    assert not torch.equal(params["layers"][0]["w"], w0)
    assert not any(t.requires_grad for t in
                   [params["encoder"]["bvals"], params["layers"][0]["w"]])
