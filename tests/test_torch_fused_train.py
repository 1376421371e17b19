"""Plain version of the port's fused train-step kernel
(brief_pytorch_tpu_torch/ops/fused_train.py) against the JAX package's
Pallas kernel run in interpret mode (ops/pallas_train.fused_train_grads),
as tests/test_pallas_train.py runs it on the CPU.

The same numpy weights and batch go to both.  Tolerances: loss rtol 1e-5,
gradients atol 1e-5 / rtol 1e-4 — both sum the batch in float32, the JAX
kernel tile by tile, the port in one matmul, so they round differently.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from brief_pytorch_tpu.models.phi import init_phi as jinit
from brief_pytorch_tpu.ops import pallas_siren as ps
from brief_pytorch_tpu.ops import pallas_train as pt
from brief_pytorch_tpu_torch.models import phi as tphi
from brief_pytorch_tpu_torch.ops import fused_train as ft
from brief_pytorch_tpu_torch.ops.chain import chain_layer_specs


def _setup(features=24, layers=4, n=700, c_out=1, seed=0, **extra):
    cfg = {"name": "SIREN", "coords_channel": 3, "data_channel": c_out,
           "features": features, "layers": layers, "w0": 20, **extra}
    model = jinit(cfg)
    params = model.init(jax.random.PRNGKey(seed))
    layers_np = [{k: np.asarray(v) for k, v in l.items()}
                 for l in params["layers"]]
    rng = np.random.default_rng(seed + 1)
    coords = rng.uniform(-1, 1, (3, n)).astype(np.float32)
    values = rng.uniform(0, 1, (c_out, n)).astype(np.float32)
    weights = (1 + rng.uniform(0, 1, (c_out, n))).astype(np.float32)
    return cfg, model, layers_np, coords, values, weights


def _compare(layers_np, coords, values, weights, acts, tile=256, **kw):
    jl, jg = pt.fused_train_grads(
        [{k: jnp.asarray(v) for k, v in l.items()} for l in layers_np],
        jnp.asarray(coords), jnp.asarray(values), jnp.asarray(weights), acts,
        tile=tile, interpret=True, **kw)
    tparams = tphi.params_from_numpy(layers_np)
    tl, tg = ft.fused_train_grads(
        tparams["layers"], torch.from_numpy(coords),
        torch.from_numpy(values), torch.from_numpy(weights), acts, **kw)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for l, (a, b) in enumerate(zip(tg["layers"], jg["layers"])):
        for k in ("w", "b"):
            assert tuple(a[k].shape) == tuple(b[k].shape)
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       atol=1e-5, rtol=1e-4,
                                       err_msg=f"d{k} layer {l}")


@pytest.mark.parametrize("loss_name,thres", [
    ("datal2", None), ("datal2", 0.7),
    ("datasmoothl1", None), ("datasmoothl1", 0.7),
])
def test_matches_pallas_interpret(loss_name, thres):
    cfg, model, layers_np, coords, values, weights = _setup()
    _compare(layers_np, coords, values, weights,
             ps.chain_layer_specs(model.spec), loss_name=loss_name,
             beta=0.01, weight_thres=thres)


def test_padded_tail():
    """N=300 with the JAX kernel's 256-wide tile pads its last tile; the
    padding must not leak into the loss or gradients of either version."""
    cfg, model, layers_np, coords, values, weights = _setup(n=300)
    _compare(layers_np, coords, values, weights,
             ps.chain_layer_specs(model.spec), loss_name="datal2",
             weight_thres=0.5)


def test_three_layers_f16_tile256():
    cfg, model, layers_np, coords, values, weights = _setup(
        features=16, layers=3, n=1000)
    _compare(layers_np, coords, values, weights,
             ps.chain_layer_specs(model.spec), loss_name="datal2",
             weight_thres=0.6)


@pytest.mark.parametrize("acts", [
    (("sine", 20.0), ("relu", 1.0), ("none", 1.0)),
    (("sigmoid", 1.0), ("sine", 30.0), ("sigmoid", 1.0)),
    (("relu", 1.0), ("sigmoid", 1.0), ("sine", 30.0)),
])
def test_other_activations(acts):
    cfg, model, layers_np, coords, values, weights = _setup(
        features=12, layers=3, n=513, c_out=2)
    _compare(layers_np, coords, values, weights, acts,
             loss_name="datasmoothl1", beta=0.05)


def test_port_specs_match_jax_specs():
    cfg, model, *_ = _setup(output_act=True)
    assert chain_layer_specs(tphi.init_phi(cfg).spec) == \
        ps.chain_layer_specs(model.spec)


def test_supports_training_and_plan():
    cfg, *_ = _setup(features=22, layers=5)
    model = tphi.init_phi(cfg)
    assert ft.supports_training(model, "datal2")
    assert ft.supports_training(model, "datasmoothl1")
    assert not ft.supports_training(model, "nosuchloss")
    # the default chain: the narrow layout, one block of 16 warps per SM
    p = ft.choose_plan([3, 22, 22, 22, 22, 1])
    assert p["layout"] == "narrow" and p["smem_bytes"] <= ft.SMEM_LIMIT
    assert ft.SM_SMEM // (p["smem_bytes"] + 1024) == 1
    assert ft.resident_warps(p) == p["threads"] // 32 == 16
    # a 512-wide chain takes the wide layout (it raised before the
    # layout streamed its weights); a chain of 17 layers (past the 16 the
    # kernel once held) takes a layout too, as the JAX gate takes every
    # plain chain (pallas_train.py:360-373)
    wide = tphi.init_phi({**cfg, "features": 512})
    assert ft.choose_plan(ft.chain_widths(wide.spec))["layout"] == "wide"
    assert ft.supports_training(wide, "datal2")
    deep = tphi.init_phi({**cfg, "layers": 17})
    assert len(ft.chain_widths(deep.spec)) == 18
    assert ft.choose_plan(ft.chain_widths(deep.spec))["layout"] in (
        "narrow", "tiled", "wide")
    assert ft.supports_training(deep, "datal2")
    assert not ft.supports_training(deep, "nosuchloss")


def test_plan_layout_is_disjoint_and_aligned():
    widths = [3, 22, 22, 22, 22, 1]
    p = ft.plan(widths, 8, 2)
    L = len(widths) - 1
    regions = [(p["wf_off"][l], p["kb"][l] * p["nt"][l] * ft.FRAG)
               for l in range(L)]
    regions += [(p["wb_off"][l], p["kbb"][l] * p["ntb"][l] * ft.FRAG)
                for l in range(1, L)]
    regions += [(p["act_off"] + q * p["rows"] * p["stride"],
                 p["rows"] * p["stride"]) for q in range(p["groups"])]
    regions += [(p["mask_sm"], sum(widths[1:-1])), (p["red_off"], 32)]
    regions.sort()
    for (a, n), (b, _) in zip(regions, regions[1:]):
        assert a + n <= b
    assert all(off % 4 == 0 for off, _ in regions)   # float4 loads
    assert p["smem_bytes"] == 4 * (p["red_off"] + 32)
    # store rows: the coordinates and a ones row, then h_l (with a ones
    # row) and d_l / g_l of every layer, the values and weights
    spans = [(0, widths[0] + 1)] + [
        (p["h_row"][l], widths[l + 1] + 1) for l in range(L - 1)] + [
        (p["g_row"][l], widths[l + 1]) for l in range(L)] + [
        (p["yw_row"], 2 * widths[-1])]
    spans.sort()
    for (a, n), (b, _) in zip(spans, spans[1:]):
        assert a + n == b
    assert spans[-1][0] + spans[-1][1] == p["rows"]
    assert p["block"] == 128 and p["stride"] == 132
    assert p["n_params"] == sum(a * b + b for a, b in
                                zip(widths[:-1], widths[1:]))


def test_cpu_tensors_never_reach_the_kernel():
    cfg, model, layers_np, coords, values, weights = _setup(n=64)
    before = ft.launches
    tparams = tphi.params_from_numpy(layers_np)
    ft.fused_train_grads(tparams["layers"], torch.from_numpy(coords),
                         torch.from_numpy(values), torch.from_numpy(weights),
                         chain_layer_specs(tphi.init_phi(cfg).spec),
                         loss_name="datal2")
    assert ft.launches == before


# --- the fleet form: unit masks, per-block thresholds, a block axis --------
FLEET_TRUE = (8, 12, 10)        # true hidden widths, padded to 12
FLEET_THRES = np.array([0.4, -np.inf, 0.6], np.float32)


def _fleet_setup(acts, n=600, seed=0):
    """B = 3 chains 3 -> f -> f -> f -> 1 of true widths FLEET_TRUE padded
    to 12 (zeros beyond each block's width), their masks and a batch.
    Weights after a sine layer follow SIREN's init (U(+-sqrt(6/fan_in)/w0),
    so gradients stay well conditioned), others U(+-0.6)."""
    rng = np.random.default_rng(seed)
    B, F = len(FLEET_TRUE), max(FLEET_TRUE)
    dims = [(3, F), (F, F), (F, F), (F, 1)]
    masks = np.zeros((B, F), np.float32)
    for i, f in enumerate(FLEET_TRUE):
        masks[i, :f] = 1.0
    layers = []
    for l, (fi, fo) in enumerate(dims):
        bound = 0.6
        if l > 0 and acts[l - 1][0] == "sine":
            bound = np.sqrt(6.0 / fi) / acts[l - 1][1]
        w = rng.uniform(-bound, bound, (B, fi, fo)).astype(np.float32)
        b = rng.uniform(-0.3, 0.3, (B, fo)).astype(np.float32)
        if l > 0:
            w *= masks[:, :, None]
        if l < len(dims) - 1:
            w *= masks[:, None, :]
            b *= masks
        layers.append({"w": w, "b": b})
    coords = rng.uniform(-1, 1, (B, 3, n)).astype(np.float32)
    values = rng.uniform(0, 1, (B, 1, n)).astype(np.float32)
    weights = (1 + rng.uniform(0, 1, (B, 1, n))).astype(np.float32)
    return layers, masks, coords, values, weights


FLEET_ACTS = [
    (("sine", 20.0), ("sine", 30.0), ("sine", 30.0), ("none", 1.0)),
    (("relu", 1.0), ("relu", 1.0), ("sine", 30.0), ("none", 1.0)),
    (("sigmoid", 1.0), ("sigmoid", 1.0), ("relu", 1.0), ("sigmoid", 1.0)),
]


@pytest.mark.parametrize("acts", FLEET_ACTS, ids=["sine", "relu", "sigmoid"])
@pytest.mark.parametrize("loss_name", ["datal2", "datasmoothl1"])
def test_fleet_matches_pallas_interpret_per_block(acts, loss_name):
    """One fleet call of the port's plain version against the JAX kernel
    (interpret mode) block by block, with unit_masks and dynamic_thres as
    block_trainer.run_block_segment passes them.  rtol 1e-5 on the loss
    and on the gradients (atol 1e-6 for near-zero entries)."""
    layers, masks, coords, values, weights = _fleet_setup(acts)
    tl, tg = ft.fused_train_grads_fleet(
        [{k: torch.from_numpy(v) for k, v in l.items()} for l in layers],
        torch.from_numpy(coords), torch.from_numpy(values),
        torch.from_numpy(weights), acts, loss_name=loss_name, beta=0.05,
        unit_masks=[torch.from_numpy(masks)] * 3 + [None],
        thres=torch.from_numpy(FLEET_THRES))
    assert tuple(tl.shape) == (len(FLEET_TRUE),)
    for i in range(len(FLEET_TRUE)):
        jl, jg = pt.fused_train_grads(
            [{k: jnp.asarray(v[i]) for k, v in l.items()} for l in layers],
            jnp.asarray(coords[i]), jnp.asarray(values[i]),
            jnp.asarray(weights[i]), acts, loss_name=loss_name, beta=0.05,
            unit_masks=[jnp.asarray(masks[i])] * 3 + [None],
            dynamic_thres=jnp.asarray(FLEET_THRES[i]), interpret=True,
            tile=256)
        np.testing.assert_allclose(float(tl[i]), float(jl), rtol=1e-5)
        for l, (a, b) in enumerate(zip(tg["layers"], jg["layers"])):
            for k in ("w", "b"):
                np.testing.assert_allclose(a[k][i].numpy(), np.asarray(b[k]),
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"block {i} d{k}{l}")


@pytest.mark.parametrize("acts", FLEET_ACTS, ids=["sine", "relu", "sigmoid"])
def test_fleet_padding_invariance(acts):
    """Mirror of tests/test_pallas_train.py's padding test for the port:
    each padded, masked block gives exactly the loss of its unpadded chain
    and exactly zero gradient on padded units (sigmoid(0) = 0.5 is the case
    an unmasked kernel could not pad)."""
    layers, masks, coords, values, weights = _fleet_setup(acts)
    tl, tg = ft.fused_train_grads_reference(
        [{k: torch.from_numpy(v) for k, v in l.items()} for l in layers],
        torch.from_numpy(coords), torch.from_numpy(values),
        torch.from_numpy(weights), acts, loss_name="datal2",
        weight_thres=torch.from_numpy(FLEET_THRES),
        unit_masks=[torch.from_numpy(masks)] * 3 + [None])
    for i, f in enumerate(FLEET_TRUE):
        dims = [(3, f), (f, f), (f, f), (f, 1)]
        own = [{"w": torch.from_numpy(l["w"][i, :a, :b].copy()),
                "b": torch.from_numpy(l["b"][i, :b].copy())}
               for l, (a, b) in zip(layers, dims)]
        thres = float(FLEET_THRES[i])
        ul, ug = ft.fused_train_grads_reference(
            own, torch.from_numpy(coords[i]), torch.from_numpy(values[i]),
            torch.from_numpy(weights[i]), acts, loss_name="datal2",
            weight_thres=thres if np.isfinite(thres) else None)
        assert float(tl[i]) == float(ul)
        for l, ((a, b), gp, gu) in enumerate(zip(dims, tg["layers"],
                                                 ug["layers"])):
            w, bias = gp["w"][i].numpy(), gp["b"][i].numpy()
            np.testing.assert_allclose(w[:a, :b], gu["w"].numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=f"valid dW{l}")
            np.testing.assert_allclose(bias[:b], gu["b"].numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=f"valid db{l}")
            assert np.abs(w[a:, :]).max(initial=0.0) == 0.0, l
            assert np.abs(w[:, b:]).max(initial=0.0) == 0.0, l
            assert np.abs(bias[b:]).max(initial=0.0) == 0.0, l


def test_fleet_cpu_tensors_never_reach_the_kernel():
    acts = FLEET_ACTS[0]
    layers, masks, coords, values, weights = _fleet_setup(acts, n=64)
    before = ft.launches
    ft.fused_train_grads_fleet(
        [{k: torch.from_numpy(v) for k, v in l.items()} for l in layers],
        torch.from_numpy(coords), torch.from_numpy(values),
        torch.from_numpy(weights), acts, loss_name="datal2")
    assert ft.launches == before


@pytest.mark.parametrize("widths,layout,block", [
    ([3] + [66] * 6 + [1], "tiled", 32),   # the padded HiP-CT bucket, 3-66
    ([3] + [186] * 4 + [1], "wide", 128),  # SingleTask default at HiP-CT size
])
def test_wide_chains_get_the_wide_layout(widths, layout, block):
    """Chains whose weights, W^T and accumulator do not fit a block's shared
    memory still train on the kernel (no silent autograd fallback): in the
    tiled layout when their weights, stored once, fit beside a
    32-coordinate tile (3-66x6-1), else in the wide layout, which keeps two
    buffers of activation rows of a 128-coordinate tile and a ring of
    three weight slabs there (3-186x4-1)."""
    assert ft.narrow_plan(widths) is None
    p = ft.choose_plan(widths)
    assert p is not None and p["layout"] == layout
    assert p["block"] == block and p["smem_bytes"] <= ft.SMEM_LIMIT
    if layout == "wide":
        assert p["threads"] == 512 and p["kp"] == 16
        rows = max(widths) + 15 >> 4 << 4
        assert p["rows_max"] == rows
        assert p["smem_bytes"] == 4 * (2 * rows * block + 3 * 2 * 8 * 128)
    else:
        assert p["threads"] == ft.TILED_THREADS and p["jobs"] in ft.TILED_JOBS
    model = tphi.init_phi({"name": "SIREN", "features": widths[1],
                           "layers": len(widths) - 1, "w0": 10})
    assert ft.supports_training(model, "datal2")


def test_narrow_chain_keeps_its_layout():
    """5 x 22 keeps the narrow layout: two groups of 8 warps (128
    coordinates a tile each) in one 512-thread block per SM, one dW job a
    warp, products on the tensor cores (not the small-chain instance)."""
    p = ft.choose_plan([3, 22, 22, 22, 22, 1])
    assert p["layout"] == "narrow" and p["threads"] == 512
    assert (p["groups"], p["warps"], p["block"]) == (2, 8, 128)
    assert p["jobs"] == 1 and not p["small"]
    assert p["smem_bytes"] == 230208
