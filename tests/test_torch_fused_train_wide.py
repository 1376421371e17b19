"""The train kernel's wide layout (brief_pytorch_tpu_torch/ops/fused_train.py
`wide_plan`, `dw_split`; ops/wide.py; csrc/fused_train.cu
`wide_train_kernel`, `wide_dw_kernel`) and the decode kernel's wide form
(ops/fused_decode.py `wide_plan`, `supports`) on the CPU: which chains get
them, their shared-memory and scratch layouts, the dW tile and split map,
and the plain versions at the demo volumes' SingleTask widths against the
JAX package's Pallas kernels run in interpret mode.  The kernels run on
the card only (tests/test_torch_cuda_kernels.py).

Tolerances of the JAX comparisons: loss rtol 1e-5, gradients rtol 1e-5 /
atol 1e-6 (both sum the batch in float32, in another order); decoded
values atol 1e-5 (the port's axis_linspace differs from jnp.linspace by a
few float32 ulps, tests/test_torch_fused_decode.py).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from brief_pytorch_tpu.models.phi import init_phi as jinit
from brief_pytorch_tpu.ops import pallas_decode as pd
from brief_pytorch_tpu.ops import pallas_siren as ps
from brief_pytorch_tpu.ops import pallas_train as pt
from brief_pytorch_tpu_torch.models import phi as tphi
from brief_pytorch_tpu_torch.ops import fused_decode as fd
from brief_pytorch_tpu_torch.ops import fused_train as ft
from brief_pytorch_tpu_torch.ops import wide

FLEET128 = [3] + [128] * 6 + [1]      # a fleet bucket past the tiled layout
WIDE_SHAPES = [
    ([3] + [191] * 4 + [1], 1, 100_000),   # default.yaml on a demo volume, 80x
    ([3] + [242] * 4 + [1], 1, 100_000),   # the same at 50x
    ([3, 512, 512, 512, 512, 1], 1, 4099),
    (FLEET128, 4, 100_003),
]
IDS = ["3-191x4-1", "3-242x4-1", "3-512x4-1", "4x3-128x6-1"]


@pytest.mark.parametrize("widths,fleet,n", WIDE_SHAPES, ids=IDS)
def test_wide_plan_fits_and_sizes_its_scratch(widths, fleet, n):
    """The wide layout is chosen; its block fits SMEM_LIMIT; the scratch
    rows are the coordinates, h_l of every hidden layer and d_l / g_l of
    every layer, disjoint, np = round64(N) floats each; the packed weights
    are (round64(fin + 1), round64(fout)) per layer."""
    p = ft.choose_plan(widths)
    assert p["layout"] == "wide" and p["smem_bytes"] <= ft.SMEM_LIMIT
    T = p["block"]
    assert T in wide.TILES and p["threads"] == 4 * T
    rows = max(-(-(w + 1) // 32) * 32 for w in widths)
    assert p["rows_max"] == rows
    assert p["smem_bytes"] == 4 * (2 * rows * T + 2 * 64 * 36 + 4 * T)
    L = len(widths) - 1
    spans = [(0, widths[0])]
    for l in range(L):
        if l < L - 1:
            spans.append((p["h_row"][l], widths[l + 1]))
            assert p["x_row"][l + 1] == p["h_row"][l]
        else:
            assert p["h_row"][l] == -1
        spans.append((p["g_row"][l], widths[l + 1]))
    spans.sort()
    for (a, k), (b, _) in zip(spans, spans[1:]):
        assert a + k == b
    assert p["x_row"][0] == 0
    assert p["rows_total"] == widths[0] + 2 * sum(widths[1:-1]) + widths[-1]
    np_, splits, chunk = ft.dw_split(n, fleet, p["n_dw_tiles"])
    assert np_ == -(-n // 64) * 64 and np_ % T == 0
    scratch_bytes = 4 * fleet * p["rows_total"] * np_
    if widths == [3] + [242] * 4 + [1]:
        assert scratch_bytes == 4 * 1940 * 100_032     # ~0.78 GB
    assert p["wp_off"][-1] == p["wp_total"] == sum(
        -(-(a + 1) // 64) * 64 * -(-b // 64) * 64
        for a, b in zip(widths[:-1], widths[1:]))
    assert p["colpad"] == [-(-b // 64) * 64 for b in widths[1:]]
    assert all(o % 4 == 0 for o in p["wp_off"])         # 16-byte copies


@pytest.mark.parametrize("widths,fleet,n", WIDE_SHAPES, ids=IDS)
def test_dw_tiles_and_splits_cover_every_entry_once(widths, fleet, n):
    """wide_dw_kernel's block (tile, split) sums entries (i0 + r, o0 + c)
    of its layer's (fin + 1) x fout gradient (row fin: the bias) over
    coordinates [split * chunk, min(np, (split + 1) * chunk)): every
    parameter is summed by exactly one tile, every coordinate by exactly
    one split of each tile."""
    p = ft.choose_plan(widths)
    hits = np.zeros(p["n_params"], np.int64)
    tile0 = p["tile0"] + [p["n_dw_tiles"]]
    for tile in range(p["n_dw_tiles"]):
        l = max(k for k in range(len(widths) - 1) if tile0[k] <= tile)
        fin, fout = widths[l], widths[l + 1]
        n_ob = -(-fout // 64)
        i0 = (tile - tile0[l]) // n_ob * 64
        o0 = (tile - tile0[l]) % n_ob * 64
        assert i0 <= fin and o0 < fout
        i = np.arange(i0, min(i0 + 64, fin + 1))
        o = np.arange(o0, min(o0 + 64, fout))
        np.add.at(hits, (p["p_off"][l] + i[:, None] * fout + o).ravel(), 1)
    assert (hits == 1).all()
    np_, splits, chunk = ft.dw_split(n, fleet, p["n_dw_tiles"])
    assert chunk % ft.DW_CHUNK == 0 and 1 <= splits <= 65535
    cover = np.zeros(np_, np.int64)
    for s in range(splits):
        cover[s * chunk:min(np_, (s + 1) * chunk)] += 1
    assert (cover == 1).all()
    assert (splits - 1) * chunk < np_


def _chain_np(widths, w0, seed=0, fleet=None, true=None):
    """SIREN-initialised layers (numpy), optionally a fleet padded to
    `widths` with true hidden widths `true` (zeros beyond) and its masks."""
    rng = np.random.default_rng(seed)
    B = 1 if fleet is None else fleet
    F = widths[1]
    masks = np.ones((B, F), np.float32)
    if true is not None:
        masks[:] = 0.0
        for i, f in enumerate(true):
            masks[i, :f] = 1.0
    layers = []
    L = len(widths) - 1
    for l, (fi, fo) in enumerate(zip(widths[:-1], widths[1:])):
        bound = 1.0 / fi if l == 0 else np.sqrt(6.0 / fi) / w0
        w = rng.uniform(-bound, bound, (B, fi, fo)).astype(np.float32)
        b = rng.uniform(-0.3, 0.3, (B, fo)).astype(np.float32)
        if l > 0:
            w *= masks[:, :, None]
        if l < L - 1:
            w *= masks[:, None, :]
            b *= masks
        layers.append({"w": w, "b": b})
    return layers, masks


@pytest.mark.parametrize("loss_name,thres", [("datal2", 0.7),
                                             ("datasmoothl1", None)])
def test_plain_3_242x4_1_matches_pallas_interpret(loss_name, thres):
    """The plain version the wide kernel is held to, at default.yaml's
    width on a demo volume at 50x (N = 300), against the JAX kernel."""
    widths = [3] + [242] * 4 + [1]
    acts = (("sine", 20.0),) * 4 + (("none", 1.0),)
    layers, _ = _chain_np(widths, 20.0)
    rng = np.random.default_rng(5)
    coords = rng.uniform(-1, 1, (3, 300)).astype(np.float32)
    values = rng.uniform(0, 1, (1, 300)).astype(np.float32)
    weights = (1 + rng.uniform(0, 1, (1, 300))).astype(np.float32)
    jl, jg = pt.fused_train_grads(
        [{k: jnp.asarray(v[0]) for k, v in l.items()} for l in layers],
        jnp.asarray(coords), jnp.asarray(values), jnp.asarray(weights), acts,
        loss_name=loss_name, beta=0.01, weight_thres=thres, interpret=True,
        tile=256)
    tl, tg = ft.fused_train_grads(
        [{k: torch.from_numpy(v[0]) for k, v in l.items()} for l in layers],
        torch.from_numpy(coords), torch.from_numpy(values),
        torch.from_numpy(weights), acts, loss_name=loss_name, beta=0.01,
        weight_thres=thres)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for l, (a, b) in enumerate(zip(tg["layers"], jg["layers"])):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"d{k}{l}")


def test_masked_fleet_128_matches_pallas_interpret():
    """4 blocks of 3-128x6-1 (true widths 98/106/117/128, w0 = 10), unit
    masks and per-block thresholds (finite and -inf) as the fleet passes
    them, N = 301, block by block against the JAX kernel; padded units'
    gradients exactly 0."""
    true = (98, 106, 117, 128)
    acts = (("sine", 10.0),) * 6 + (("none", 1.0),)
    layers, masks = _chain_np(FLEET128, 10.0, seed=2, fleet=4, true=true)
    rng = np.random.default_rng(6)
    coords = rng.uniform(-1, 1, (4, 3, 301)).astype(np.float32)
    values = rng.uniform(0, 1, (4, 1, 301)).astype(np.float32)
    weights = (1 + rng.uniform(0, 1, (4, 1, 301))).astype(np.float32)
    thres = np.array([0.4, -np.inf, 0.6, -np.inf], np.float32)
    tl, tg = ft.fused_train_grads_fleet(
        [{k: torch.from_numpy(v) for k, v in l.items()} for l in layers],
        torch.from_numpy(coords), torch.from_numpy(values),
        torch.from_numpy(weights), acts, loss_name="datal2",
        unit_masks=[torch.from_numpy(masks)] * 6 + [None],
        thres=torch.from_numpy(thres))
    for i in range(4):
        jl, jg = pt.fused_train_grads(
            [{k: jnp.asarray(v[i]) for k, v in l.items()} for l in layers],
            jnp.asarray(coords[i]), jnp.asarray(values[i]),
            jnp.asarray(weights[i]), acts, loss_name="datal2",
            unit_masks=[jnp.asarray(masks[i])] * 6 + [None],
            dynamic_thres=jnp.asarray(thres[i]), interpret=True, tile=256)
        np.testing.assert_allclose(float(tl[i]), float(jl), rtol=1e-5)
        f = true[i]
        for l, (a, b) in enumerate(zip(tg["layers"], jg["layers"])):
            for k in ("w", "b"):
                np.testing.assert_allclose(a[k][i].numpy(), np.asarray(b[k]),
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"block {i} d{k}{l}")
            if l < 6:
                assert not a["w"][i, :, f:].any() and not a["b"][i, f:].any()
            if l > 0:
                assert not a["w"][i, f:, :].any()


SUPPORT_MODELS = [
    ({"features": 22}, (64, 64, 64)),
    ({"features": 191}, (64, 512, 512)),
    ({"features": 242}, (64, 512, 512)),
    ({"features": 512}, (16, 16, 16)),
    ({"features": 1600}, (8, 8, 8)),          # 30.7 MB of weights
    ({"features": 1700}, (8, 8, 8)),          # 34.7 MB: beyond 32 MB
    ({"features": 64, "layers": 7}, (64, 256, 256)),
    ({"features": 22, "res": True}, (64, 64, 64)),
    ({"features": 16, "coords_channel": 2}, (37, 41)),
    ({"features": 16}, None),
]


@pytest.mark.parametrize("extra,spatial", SUPPORT_MODELS)
def test_decode_supports_agrees_with_jax(extra, spatial):
    cfg = {"name": "SIREN", "coords_channel": 3, "data_channel": 1,
           "features": 22, "layers": 5, "w0": 20, **extra}
    assert fd.supports(tphi.init_phi(cfg), spatial) == \
        pd.supports(jinit(cfg), spatial)


def test_plain_decode_5x242_matches_pallas_interpret():
    """The plain version the wide decode form is held to, 5 x 242 on an
    8x16x16 grid, against the JAX decode kernel in interpret mode."""
    cfg = {"name": "SIREN", "coords_channel": 3, "data_channel": 1,
           "features": 242, "layers": 5, "w0": 20}
    model = jinit(cfg)
    params = model.init(jax.random.PRNGKey(0))
    layers_np = [{k: np.asarray(v) for k, v in l.items()}
                 for l in params["layers"]]
    acts = ps.chain_layer_specs(model.spec)
    spatial = (8, 16, 16)
    ref = np.asarray(pd.fused_decode_grid(params["layers"], spatial, acts,
                                          "-1,1", tile=128, interpret=True))
    assert fd.choose_plan([3] + [242] * 4 + [1])["layout"] == "wide"
    out = fd.fused_decode_grid(tphi.params_from_numpy(layers_np)["layers"],
                               spatial, acts, "-1,1")
    assert out.shape == ref.shape == (8 * 16 * 16, 1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
