"""Compress.half in the port (brief_pytorch_tpu_torch) against the JAX
package, on the CPU: every product from bfloat16 inputs and weights with
float32 sums, parameters in float32.

Forward: each family's apply(compute_dtype=bfloat16) on the same weights
and coordinates as the JAX package's.  Both sum exact products of the
same bfloat16 numbers in float32, in other orders; a float32 sum that
lands on the other side of a bfloat16 rounding boundary rounds one input
of the next product one bfloat16 ulp (2^-8 relative) away.  So the bound
is relative to max|out|: mean |diff| <= 1e-4 and the 99.9th percentile
<= 2e-3 (a rare flip passes, a wrong rounding mode or a float32 product
does not: those move every output by ~1e-3).  Sizing: 2 bytes a
parameter, equal to the JAX package's.  A 200-step half SingleTask above
the JAX test's floor of 20 dB (tests/test_divide_runner.py:268-280).  The
fleet's half step against the JAX run_block_segment's on the same draws
(test_torch_gather.fleet_step_pair), with the forward's bound on losses
and gradients.
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from brief_pytorch_tpu.models import phi as jphi
from brief_pytorch_tpu.models import sizing as js
from brief_pytorch_tpu_torch.models import phi as tphi
from brief_pytorch_tpu_torch.models import sizing as ts

from test_torch_gather import fleet_blocks, fleet_step_pair


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small CPU training steps: one intra-op thread, so that they do
    not contend with the other test processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FAMILY_KEYS = {
    "SIREN": {}, "SIRENFT": {"ratio": 2.2},
    "SIREN_Pyramid": {"features_dis": 3}, "SIRENPS": {"ratio": 1.4},
    "SIREN_RELU": {}, "SIREN_SIGMOID": {},
    "SIRENPos": {"T": [2.0, 3.0, 2.0]}, "NeRF": {"frequencies": 4},
    "FFN": {"embsize": 12, "scale": 5},
    "MFNFourier": {"input_scale": 8.0}, "MFNGabor": {"input_scale": 8.0},
}


def _close(got, want, what):
    """The bfloat16 bound of the module docstring, relative to max|want|."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    scale = float(np.abs(want).max()) + 1e-12
    assert d.mean() <= 1e-4 * scale, (what, d.mean(), scale)
    assert np.percentile(d, 99.9) <= 2e-3 * scale, (what, d.max(), scale)


@pytest.mark.parametrize("name", list(FAMILY_KEYS))
def test_apply_bf16_matches_jax(name):
    cfg = {"name": name, "coords_channel": 3, "data_channel": 1,
           "layers": 4, "features": 24, "w0": 20, **FAMILY_KEYS[name]}
    jmodel = jphi.init_phi(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = tphi.init_phi(cfg)
    tparams = tphi.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams))
    x = np.random.default_rng(1).uniform(-1, 1, (2048, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(x),
                                   compute_dtype=jnp.bfloat16))
    got = tmodel.apply(tparams, torch.from_numpy(x),
                       compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, name)
    # and it is bfloat16 arithmetic: float32 differs by more than the bound
    f32 = tmodel.apply(tparams, torch.from_numpy(x)).numpy()
    assert np.abs(f32 - want).mean() > 1e-4 * np.abs(want).max(), name


@pytest.mark.parametrize("name", ["SIREN", "SIREN_Pyramid", "FFN",
                                  "MFNGabor"])
@pytest.mark.parametrize("budget", [3276.8, 20000.0, 104857.6])
def test_half_sizing_equals_jax(name, budget):
    cfg = {"name": name, "coords_channel": 3, "data_channel": 1,
           "layers": 5, "w0": 20, **FAMILY_KEYS[name]}
    got = ts.estimate_module_size(budget, dict(cfg), True)
    want = js.estimate_module_size(budget, dict(cfg), True)
    assert got == want
    assert got[2] == 2 * got[1]


FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "dataset", "brain", "64x64x64",
    "brain-64_128-64_128-192_256.tif")
HALF_WIDTH = 32    # SIREN 5 x 32 on the fixture at 80x and 2 bytes a param


def test_half_default_width_at_80x():
    """opt/SingleTask/default.yaml's 64^3 fixture at 80x: 5 x 22 in
    float32, 5 x HALF_WIDTH at 2 bytes a parameter, as in JAX."""
    cfg = {"name": "SIREN", "coords_channel": 3, "data_channel": 1,
           "layers": 5, "w0": 20}
    budget = os.path.getsize(FIXTURE) / 80
    assert ts.estimate_module_size(budget, dict(cfg), False)[0] == 22
    got = ts.estimate_module_size(budget, dict(cfg), True)
    assert got == js.estimate_module_size(budget, dict(cfg), True)
    assert got[0] == HALF_WIDTH


def test_half_singletask_above_jax_floor(tmp_path):
    """200 half steps of the SingleTask default on the 64^3 fixture
    (randompoint 2,048, the JAX test's settings): PSNR above 20 dB, the
    theory ratio within 7% of 80x and the float32 files about twice the
    theory size, the bfloat16 slab decode (the grid kernel's plain
    version is not taken), and the standalone decompress equal to the
    checkpoint's decode."""
    from brief_pytorch_tpu_torch.core import config as tcfg
    from brief_pytorch_tpu_torch.io.image import read_img
    from brief_pytorch_tpu_torch.ops import fused_decode
    from brief_pytorch_tpu_torch.train.fit import NFGR
    from brief_pytorch_tpu_torch.utils.logger import MyLogger
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    opt = tcfg.load(os.path.join(root, "opt", "SingleTask", "default.yaml"))
    opt.Dataset.data_path = os.path.join(root, opt.Dataset.data_path)
    opt.Log.update(outputs_dir=str(tmp_path), stdlog=False,
                   tensorboard=False, time=False)
    c = opt.CompressFramework
    c.Compress.update(half=True, max_steps=200, checkpoints="none")
    c.Compress.sampler.update(name="randompoint", sample_size=2048)
    c.Decompress.mip = False
    log = MyLogger(**opt.Log.to_plain())
    before = fused_decode.launches
    res = NFGR(c, logger=log, seed=42, device="cpu").compress(
        opt.Dataset.data_path)
    assert res["psnr"] > 20
    assert abs(res["compress_ratio/theory"] - 80) / 80 < 0.07
    assert res["compress_ratio/actual"] < 0.7 * res["compress_ratio/theory"]
    comp = os.path.join(log.logdir, "steps200", "compressed")
    side = tcfg.load(os.path.join(comp, "sideinfos.yaml"))
    assert side["phi_features"] == HALF_WIDTH
    dec = NFGR.decompress(c, os.path.join(comp, "module"),
                          os.path.join(comp, "sideinfos.yaml"), device="cpu")
    ck = read_img(os.path.join(log.logdir, "steps200", "decompressed",
                               "brain-64_128-64_128-192_256_decompressed.tif"))
    assert np.array_equal(dec, ck)
    assert fused_decode.launches == before


def test_fleet_half_step_matches_jax():
    """One half step of a stacked bucket (bfloat16 products in
    stacked_apply, autograd) on the JAX run_block_segment's draws: losses
    and gradients within the forward's bfloat16 bound."""
    jl, tl, jg, tg, *_ = fleet_step_pair(fleet_blocks(), L=1, pad=1,
                                         half=True)
    _close(tl, jl, "loss")
    for l, (a, b) in enumerate(zip(tg, jg)):
        for k in ("w", "b"):
            _close(a[k].numpy(), b[k], f"grad {k}{l}")
    # the float32 step is another step
    fl, _, fg, *_ = fleet_step_pair(fleet_blocks(), L=1, pad=1)
    assert not np.allclose(fl, jl, rtol=1e-6)
