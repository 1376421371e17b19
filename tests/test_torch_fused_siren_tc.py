"""The batch-major forward kernel's tensor-core design on the CPU
(brief_pytorch_tpu_torch/ops/fused_siren.py `choose_plan`,
`supports`, `chain_tc_model`; csrc/fused_siren.cu on the shared chain of
csrc/chain_tc.cuh): its arithmetic emulated, the plan at the shapes the
card's check runs, its reach, and its gate against the JAX package's.
The kernel itself runs on the card only (tests/test_torch_cuda_kernels.py,
chip_smoke.py phase 9).

The emulation is fused_siren.chain_tc_model: the kernel's k-blocks of 8
inputs in 3xTF32 with its sums (both operands split to nearest, each
k-block's three terms summed from zero and added in float32), every
mma.sync through mma_tf32_model, the card's truncating sum
(scripts/mma_tf32_sums.py checks it bit for bit on the card).  The packed
B-fragment order it reads is kernel 2's (pack_kernel, packed_entry),
held by tests/test_torch_fused_decode_tc.py.  Inputs and weights come
from numpy seeds (the weights through the JAX package's init, shared by
both packages).

Tolerances: against the float32 plain version, the card's: 2e-6 +
2e-6 * max|plain| for the chains phase 9 checked before the tensor-core
design, 1e-5 * max|plain| + 1e-5 (kernel 2's) for 3-1024x4-1; against the
JAX kernel in interpret mode, atol 1e-5 (tests/test_torch_fused_decode_tc.py
holds kernel 2's emulation to the same); against a float64 evaluation,
at most F64_RATIO times the plain version's distance, max and mean.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from brief_pytorch_tpu.models.phi import init_phi as jinit
from brief_pytorch_tpu.ops import pallas_siren as ps
from brief_pytorch_tpu_torch.models import phi as tphi
from brief_pytorch_tpu_torch.ops import chain_stream as cs
from brief_pytorch_tpu_torch.ops import fused_decode as fd
from brief_pytorch_tpu_torch.ops import fused_siren as fs
from brief_pytorch_tpu_torch.ops.chain import (chain_layer_specs,
                                               make_pre_encode)

pytestmark = pytest.mark.skipif(not ps._HAS_PALLAS, reason="no pallas")

BASE = {"coords_channel": 3, "data_channel": 1, "layers": 5, "w0": 20}
TIGHT = (2e-6, 2e-6)         # (absolute, times max|plain|)
WIDE = (1e-5, 1e-5)
F64_RATIO = 2.0              # times the plain version's distance to float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulation is many float64 elementwise ops: one intra-op thread,
    so that it does not contend with the other test processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name="SIREN", **kw):
    return {**BASE, "name": name, "features": 22, **kw}


def _pair(cfg, seed=0):
    jmodel = jinit(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tparams = tphi.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams))
    return jmodel, jparams, tphi.init_phi(cfg), tparams


def _coords(n, c, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (n, c)).astype(
        np.float32)


def _float64(layers, coords, acts):
    """Each layer's products and sums in float64, its pre-activation
    rounded once to float32 and activated as the plain version does."""
    h = coords.double()
    for layer, (act, w0) in zip(layers, acts):
        z = (h @ layer["w"].double() + layer["b"].double()).float()
        h = fs._act(z, act, w0).double()
    return h


CASES = [
    # (label, family config, N, tolerance against the plain version)
    ("single-700", _cfg(), 700, TIGHT),
    ("single-130", _cfg(), 130, TIGHT),
    ("sirenpos", _cfg("SIRENPos", T=[2.0, 3.0, 2.0]), 300, TIGHT),
    ("relu", _cfg("SIREN_RELU"), 257, TIGHT),
    ("sigmoid", _cfg("SIREN_SIGMOID"), 257, TIGHT),
    ("pyramid", _cfg("SIREN_Pyramid", features=27, features_dis=3), 200,
     TIGHT),
    ("hipct-block", _cfg(features=64, layers=7, w0=10), 301, TIGHT),
    ("wide-186", _cfg(features=186), 131, TIGHT),
    ("wide-1024", _cfg(features=1024), 64, WIDE),
    ("c2", _cfg(coords_channel=2, data_channel=3, features=16, layers=3),
     77, TIGHT),
    ("c4", _cfg(coords_channel=4, features=40), 99, TIGHT),
]


@pytest.mark.parametrize("label,cfg,n,tol", CASES, ids=[c[0] for c in CASES])
def test_emulated_3xtf32_matches_plain_and_pallas(label, cfg, n, tol):
    jmodel, jparams, tmodel, tparams = _pair(cfg, seed=len(label))
    x = _coords(n, cfg["coords_channel"], seed=n)
    acts = chain_layer_specs(tmodel.spec)
    assert acts == ps.chain_layer_specs(jmodel.spec)
    pre = make_pre_encode(tmodel.spec)
    coords = pre(torch.from_numpy(x))
    emu = fs.chain_tc_model(tparams["layers"], coords, acts)
    plain = fs.fused_chain_apply_reference(tparams["layers"], coords, acts)
    assert emu.shape == plain.shape == (n, cfg["data_channel"])
    assert bool(torch.isfinite(emu).all())
    assert float((emu - plain).abs().max()) <= \
        tol[0] + tol[1] * float(plain.abs().max())
    ref = np.asarray(ps.make_fused_apply(jmodel, interpret=True, tile=256)(
        jparams, jnp.asarray(x)))
    np.testing.assert_allclose(emu.numpy(), ref, rtol=0, atol=1e-5)


F64_CASES = [
    # (label, family config)
    ("default", _cfg()),
    ("hipct-block", _cfg(features=64, layers=7, w0=10)),
    ("relu", _cfg("SIREN_RELU")),
    ("sigmoid", _cfg("SIREN_SIGMOID")),
]


@pytest.mark.parametrize("label,cfg", F64_CASES, ids=[c[0] for c in F64_CASES])
def test_sums_keep_float32_accuracy(label, cfg):
    """Against a float64 evaluation, kernel 3's sums stay within F64_RATIO
    of the plain version's distance, max and mean, where kernel 2's
    truncating sums (three mma.sync into one accumulator, the small parts
    truncated) lose that: the card's measured gap (chip_smoke.py phase 10
    on a trained chain), seen here through mma_tf32_model."""
    _, _, tmodel, tparams = _pair(cfg, seed=3)
    acts = chain_layer_specs(tmodel.spec)
    coords = torch.from_numpy(_coords(4096, cfg["coords_channel"], seed=5))
    layers = tparams["layers"]
    truth = _float64(layers, coords, acts)

    def dist(out):
        d = (out.double() - truth).abs()
        return float(d.max()), float(d.mean())

    plain = dist(fs.fused_chain_apply_reference(layers, coords, acts))
    near = dist(fs.chain_tc_model(layers, coords, acts))
    trunc = dist(fs.chain_tc_model(layers, coords, acts, nearest=False))
    assert near[0] <= F64_RATIO * plain[0]
    assert near[1] <= F64_RATIO * plain[1]
    assert trunc[1] > F64_RATIO * plain[1]


PLANS = [
    # (phase-9 case, family config, form, instance, streamed: the form
    # with activations in a device scratch, which has no instance)
    ("slab / default / relu / sigmoid / sirenpos", _cfg(), "narrow", 3,
     False),
    ("hipct-block", _cfg(features=64, layers=7, w0=10), "narrow", 9, False),
    ("wide", _cfg(features=186), "wide", 3, False),
    ("pyramid", _cfg("SIREN_Pyramid", features=27, features_dis=3),
     "narrow", 6, False),
    ("wide-1024", _cfg(features=1024), "wide", None, True),
    ("c2", _cfg(coords_channel=2, data_channel=3), "narrow", 3, False),
]


@pytest.mark.parametrize("label,cfg,layout,inst,stream", PLANS,
                         ids=[p[0].split(" ")[0] for p in PLANS])
def test_plan_at_phase_9_shapes(label, cfg, layout, inst, stream):
    """The form and instance of each phase-9 chain, and what the plan
    states beside them: the narrow form holds the pre-split weights in
    shared memory, the wide one a slab ring and every k-block of the
    widest layer input; 3-1024x4-1, past 256 features, takes the streamed
    form, whose activations live in a device scratch."""
    widths = fs.chain_widths(tphi.init_phi(cfg).spec)
    p = fs.choose_plan(widths)
    assert (p["layout"], p["inst"], bool(p.get("stream"))) == \
        (layout, inst, stream)
    assert p["smem_bytes"] <= fd.SMEM_LIMIT
    if stream:
        assert p == cs.stream_plan(widths)
    elif layout == "narrow":
        assert p["smem_bytes"] == 4 * p["packed_floats"]
        assert p["tile"] in (16, 32) and p["warps_per_sm"] in (8, 16)
    else:
        assert p["tile"] == 128 and p["warps_per_sm"] == 8
        assert p["smem_bytes"] >= 4 * 8 * max(p["kb"]) * fd.WIDE_STRIDE
        assert 2 <= p["stages"] <= fd.MAX_STAGES


@pytest.mark.parametrize("widths,ok", [
    ([3] + [8] * 15 + [1], True),          # 16 layers
    ([3, 3327, 1], True),                  # the widest layer of old
    ([3327, 8, 1], True),                  # the widest input of old
    ([3, 3327, 3327, 1], True),
    ([100, 22, 1], True),                  # 13 input k-blocks: wide
    ([3] + [8] * 16 + [1], True),          # 17 layers
    ([3, 3328, 1], True),
    ([3328, 8, 1], True),
    ([256, 8, 1], True),                   # the widest input in smem
    ([257, 8, 1], True),                   # past 256: streamed
    ([3] + [256] * 4 + [1], True),
    ([3] + [257] * 4 + [1], True),
])
def test_reach(widths, ok):
    """Every plain chain has a form, of any depth (17 layers: past the 16
    the kernel once held) and any width, the input included (3,328
    features: past the 3,327 it once held).  An input wider than 12
    k-blocks takes the wide form, one wider than 256 features (as any
    layer) the streamed form, the only one with its activations in a
    device scratch; the 17-layer chain is emulated tile by tile against
    the plain version."""
    assert ok
    p = fs.choose_plan(widths)
    assert p["smem_bytes"] <= fd.SMEM_LIMIT
    if widths[0] > 96:
        assert p["layout"] == "wide"
    assert bool(p.get("stream")) == (max(widths) > 256)
    if p.get("stream"):
        assert p == cs.stream_plan(widths)
    if len(widths) == 18:
        assert p["layout"] == "narrow"
        _, _, tmodel, tparams = _pair(_cfg(features=8, layers=17))
        assert fs.chain_widths(tmodel.spec) == widths
        coords = torch.from_numpy(_coords(64, 3, seed=17))
        acts = chain_layer_specs(tmodel.spec)
        emu = fs.chain_tc_model(tparams["layers"], coords, acts)
        plain = fs.fused_chain_apply_reference(tparams["layers"], coords,
                                               acts)
        assert float((emu - plain).abs().max()) <= \
            TIGHT[0] + TIGHT[1] * float(plain.abs().max())


FAMILIES = ["SIREN", "SIRENFT", "SIREN_Pyramid", "SIRENPS", "SIREN_RELU",
            "SIREN_SIGMOID", "SIRENPos"]
KEYS = {"SIRENFT": {"ratio": 2.2}, "SIREN_Pyramid": {"features_dis": 3},
        "SIRENPS": {"ratio": 1.4}, "SIRENPos": {"T": [2.0, 3.0, 2.0]}}


@pytest.mark.parametrize("name", FAMILIES + ["NeRF", "FFN", "MFNFourier"])
@pytest.mark.parametrize("features", [22, 907, 908, 1500, 3327])
def test_supports_is_the_jax_gate(name, features):
    """For every plain family, at any width (SIRENFT at 3,327 features
    passes the 3,327 the kernel once held), the port's gate is the JAX
    package's (True); the other families are refused by both."""
    cfg = _cfg(name, features=features, **KEYS.get(name, {}))
    if name == "FFN":
        cfg["embsize"] = 12
    jgate = ps.supports(jinit(cfg))
    tmodel = tphi.init_phi(cfg)
    if name not in FAMILIES:
        assert fs.supports(tmodel) is jgate is False
        return
    assert jgate is True
    assert fs.supports(tmodel) is True
