"""The train kernel's wide layout (brief_pytorch_tpu_torch/ops/fused_train.py
`wide_plan`, `dw_split`, `wide_emulation`; ops/wide.py; csrc/fused_train.cu
`wide_tile_kernel`, `wide_dw_kernel`) and the decode kernel's wide form
(ops/fused_decode.py `wide_plan`, `supports`) on the CPU: which chains get
them, their shared-memory and scratch layouts, the split weight packs, the
dW tile and split map, the wide layout's tensor-core arithmetic emulated
on the CPU, and the plain versions at the demo volumes' SingleTask widths
against the JAX package's Pallas kernels run in interpret mode.  The
kernels run on the card only (tests/test_torch_cuda_kernels.py).

Tolerances of the JAX comparisons: loss rtol 1e-5, gradients rtol 1e-5 /
atol 1e-6 (both sum the batch in float32, in another order); decoded
values atol 1e-5 (the port's axis_linspace differs from jnp.linspace by a
few float32 ulps, tests/test_torch_fused_decode.py).  The emulation of
the kernel's 3xTF32 products: against the float32 plain version
chip_smoke.compare_grads' tolerances (loss rel 1e-5; gradients 1e-4 *
max|plain| + 1e-6), against the Pallas kernel rtol 1e-4 / atol 1e-5 (as
tests/test_torch_fused_train_tiled.py holds the tiled layout's).
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
from brief_pytorch_tpu_torch.ops.tc_model import tf32_split_nearest

FLEET128 = [3] + [128] * 6 + [1]      # a fleet bucket past the tiled layout
WIDE_SHAPES = [
    ([3] + [191] * 4 + [1], 1, 100_000),   # default.yaml on a demo volume, 80x
    ([3] + [242] * 4 + [1], 1, 100_000),   # the same at 50x
    ([3] + [352] * 4 + [1], 1, 4099),      # the layout's widest layers
    (FLEET128, 4, 100_003),
    ([3] + [64] * 23 + [1], 1, 100_000),   # phase 20d's reach-24x64
    ([3] + [227] * 4 + [3], 1, 100_000),   # the video at 80x, c_out = 3
]
IDS = ["3-191x4-1", "3-242x4-1", "3-352x4-1", "4x3-128x6-1", "24x64",
       "3-227x4-3"]


@pytest.mark.parametrize("widths,fleet,n", WIDE_SHAPES, ids=IDS)
def test_wide_plan_fits_and_sizes_its_scratch(widths, fleet, n):
    """The wide layout is chosen, at the largest tile whose block fits
    SMEM_LIMIT (two buffers of rows_max rows and the slab ring); the
    scratch rows are the coordinates, one z row set a hidden
    layer and two G buffers of the widest layer, disjoint, np =
    round128(N) floats each (765 + 2 x 191 rows at 3-191x4-1, where the
    old layout kept 1,532: h and d of every layer); the packs hold W and
    W^T of every layer, padded to the tile's slab depth and to 64
    columns."""
    p = ft.choose_plan(widths)
    assert p["layout"] == "wide" and not p["stream"]
    assert p["smem_bytes"] <= ft.SMEM_LIMIT
    wider = widths[:1] + [w + 1 if 0 < i < len(widths) - 1 else w
                          for i, w in enumerate(widths)][1:]
    if max(widths) == ft.WIDE_MAX_FEATURES:   # one feature more: streamed
        assert ft.choose_plan(wider)["stream"]
    T = p["block"]
    assert T in wide.TILES and p["threads"] == wide.THREADS
    assert all(wide.smem_bytes(widths, t) > ft.SMEM_LIMIT
               for t in wide.TILES if t > T)
    kp = 16 if T == 128 else 32
    assert p["kp"] == kp
    rows = max(-(-w // kp) * kp for w in widths)
    assert p["rows_max"] == rows
    assert p["smem_bytes"] == 4 * (2 * rows * T + 3 * (kp // 8) * 8 * 128)
    L = len(widths) - 1
    gw = max(widths[1:])
    spans = [(0, widths[0])]
    for l in range(L):
        assert p["in_row"][l] == (0 if l == 0 else p["out_row"][l - 1])
        if l < L - 1:
            spans.append((p["out_row"][l], widths[l + 1]))
        else:
            assert p["out_row"][l] == -1
    ga, gb = sorted(set(p["g_row"]))
    spans += [(ga, gw), (gb, gw)]
    assert p["g_row"][L - 1] == ga
    for l in range(L - 1):       # g_{l+1} and g_{l+2} in the two buffers
        assert {p["g_row"][l], p["g_row"][l + 1]} == {ga, gb}
    spans.sort()
    for (a, k), (b, _) in zip(spans, spans[1:]):
        assert a + k == b
    assert p["rows_total"] == sum(widths[:-1]) + 2 * gw
    if widths == [3] + [191] * 4 + [1]:
        assert p["rows_total"] == 1149 and T == 128
    sp = ft.dw_split(n, fleet, widths)
    assert sp["np"] == -(-n // 128) * 128 and sp["np"] % T == 0
    off = 0
    for l, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        assert p["wf_off"][l] == off
        off += 2 * (-(-a // kp) * kp) * (-(-b // 64) * 64)
        assert p["wb_off"][l] == off
        off += 2 * (-(-b // kp) * kp) * (-(-a // 64) * 64)
    assert p["wp_total"] == off
    assert all(o % 4 == 0 for o in p["wf_off"] + p["wb_off"])   # 16 bytes


@pytest.mark.parametrize("widths,fleet,n", WIDE_SHAPES, ids=IDS)
def test_dw_tiles_and_splits_cover_every_entry_once(widths, fleet, n):
    """wide_dw_kernel's block (tile, split) of layer l sums entries (i0 +
    r, o0 + c) of its fin x fout gradient of W, and the blocks of the
    first i-block its db, over coordinates [split * chunk, min(np, (split
    + 1) * chunk)): every parameter is summed by exactly one tile, every
    coordinate by exactly one split of each tile; a layer's partial sums
    have their own region, and a launch holds at most two waves of
    blocks."""
    p = ft.choose_plan(widths)
    sp = ft.dw_split(n, fleet, widths)
    hits = np.zeros(p["n_params"], np.int64)
    regions = []
    for l, (fin, fout) in enumerate(zip(widths[:-1], widths[1:])):
        ti, to = wide.dw_tiles(fin, fout)
        ob = wide.dw_columns(fout)
        assert ob == (64 if fout <= 64 else 128)
        for tile in range(ti * to):
            i0, o0 = tile // to * 64, tile % to * ob
            assert i0 < fin and o0 < fout
            i = np.arange(i0, min(i0 + 64, fin))
            o = np.arange(o0, min(o0 + ob, fout))
            np.add.at(hits, (p["p_off"][l] + i[:, None] * fout + o).ravel(),
                      1)
            if i0 == 0:
                np.add.at(hits, p["p_off"][l] + fin * fout + o, 1)
        s, chunk = sp["splits"][l], sp["chunk"][l]
        assert chunk % ft.DW_CHUNK == 0 and 1 <= s <= 65535
        assert (s - 1) * chunk < sp["np"] <= s * chunk
        waves = ft.WIDE_DW_BLOCKS * (2 if ob == 64 else 1)
        assert s == 1 or ti * to * fleet * s <= waves
        regions.append((sp["part_off"][l], s * (fin + 1) * fout))
    assert (hits == 1).all()
    for (a, k), (b, _) in zip(regions, regions[1:]):
        assert a + k == b
    assert regions[-1][0] + regions[-1][1] == sp["part_total"]


@pytest.mark.parametrize("k,n,kp", [(191, 191, 16), (3, 191, 16),
                                    (242, 1, 32), (1, 242, 32),
                                    (64, 64, 16), (37, 170, 32)])
def test_wide_pack_round_trip(k, n, kp):
    """ops/wide.py pack_layer: the (K, N) matrix split into TF32 halves
    (tf32_split_nearest: big + small within 2^-22 |x|, each a TF32 value)
    in mma B-fragment order, chunks of 64 columns, each chunk's k-blocks
    in order; lane 4 g + t of fragment (kb, j) holds rows 8 kb + t and 8
    kb + t + 4 of column 64 c + 8 j + g; zeros past the matrix.  unpack
    gives the halves back."""
    rng = np.random.default_rng(k * 1000 + n)
    m = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    pack = wide.pack_layer(m, kp)
    kpad, npad = -(-k // kp) * kp, -(-n // 64) * 64
    assert tuple(pack.shape) == (npad // 64, kpad // 8, 8, 32, 4)
    assert pack.numel() == wide.pack_floats(k, n, kp)
    big, small = wide.unpack_layer(pack, k, n)
    eb, es = tf32_split_nearest(m)
    assert torch.equal(big, eb) and torch.equal(small, es)
    bits = pack.contiguous().view(torch.int32)
    assert not (bits & 0x1FFF).any()              # TF32 values only
    assert float((big + small - m).abs().max()) <= \
        2.0 ** -22 * float(m.abs().max())
    for c, kb, j, lane in [(0, 0, 0, 0), (npad // 64 - 1, kpad // 8 - 1, 7,
                                          31), (0, 1, 3, 13)]:
        g, t = lane >> 2, lane & 3
        col = 64 * c + 8 * j + g
        for h in (0, 1):
            r = 8 * kb + t + 4 * h
            want = (eb[r, col], es[r, col]) if r < k and col < n else (0, 0)
            assert float(pack[c, kb, j, lane, h]) == float(want[0])
            assert float(pack[c, kb, j, lane, 2 + h]) == float(want[1])


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


_SINE = lambda L, w0: (("sine", w0),) * (L - 1) + (("none", 1.0),)
_RELU_SIG = tuple((("relu", 1.0), ("sigmoid", 1.0))[l % 2]
                  for l in range(6)) + (("none", 1.0),)
EMULATION_CASES = [   # (widths, acts, fleet true widths, loss, thresholds)
    ([3] + [242] * 4 + [1], _SINE(5, 20.0), None, "datal2", [0.7]),
    ([3] + [242] * 4 + [1], _SINE(5, 20.0), None, "datasmoothl1", [0.5]),
    (FLEET128, _SINE(7, 10.0), (98, 106, 117, 128), "datal2",
     [0.4, -np.inf, 0.6, -np.inf]),
    (FLEET128, _RELU_SIG, (98, 106, 117, 128), "datasmoothl1",
     [0.4, -np.inf, 0.6, -np.inf]),
    ([3] + [227] * 4 + [3], _SINE(5, 20.0), None, "datal2", None),
    ([3] + [64] * 23 + [1], _SINE(24, 20.0), None, "datal2", [0.7]),
]


@pytest.mark.parametrize("widths,acts,true,loss_name,thres", EMULATION_CASES,
                         ids=["3-242x4-1-l2", "3-242x4-1-l1", "fleet128",
                              "fleet128-relu-sigmoid", "3-227x4-3", "24x64"])
def test_wide_emulation_matches_plain_and_pallas(widths, acts, true,
                                                 loss_name, thres):
    """The wide layout's arithmetic (fused_train.wide_emulation: 3xTF32
    k-block sums added in float32, z stored and h, d recomputed from it
    through fast_sincos, dW per split in 32-coordinate chunks, db by
    quarters of a chunk, the splits in order) at N = 301 (a ragged tail:
    np = 384) against the float32 plain version and, block by block, the
    JAX Pallas kernel in interpret mode; a fleet's padded units get
    exactly 0."""
    fleet = 1 if true is None else len(true)
    layers, masks = _chain_np(widths, acts[0][1], seed=4, fleet=fleet,
                              true=true)
    rng = np.random.default_rng(9)
    n, c_in, c_out = 301, widths[0], widths[-1]
    coords = rng.uniform(-1, 1, (fleet, c_in, n)).astype(np.float32)
    values = rng.uniform(0, 1, (fleet, c_out, n)).astype(np.float32)
    weights = (1 + rng.uniform(0, 1, (fleet, c_out, n))).astype(np.float32)
    th = None if thres is None else np.asarray(thres, np.float32)
    L = len(widths) - 1
    um = None if true is None else [torch.from_numpy(masks)] * (L - 1) + [None]
    tl = [{k: torch.from_numpy(v) for k, v in l.items()} for l in layers]
    args = (tl, torch.from_numpy(coords), torch.from_numpy(values),
            torch.from_numpy(weights), acts)
    th_t = None if th is None else torch.from_numpy(th)
    le, ge = ft.wide_emulation(*args, loss_name=loss_name, thres=th_t,
                               unit_masks=um)
    lp, gp = ft.fused_train_grads_reference(
        *args, loss_name=loss_name, weight_thres=th_t, unit_masks=um)
    assert bool(((le - lp).abs() <= 1e-5 * lp.abs()).all())
    for l, (a, b) in enumerate(zip(ge["layers"], gp["layers"])):
        for k in ("w", "b"):
            d = float((a[k] - b[k]).abs().max())
            assert d <= 1e-4 * float(b[k].abs().max()) + 1e-6, (l, k, d)
    for i in range(fleet):
        jl, jg = pt.fused_train_grads(
            [{k: jnp.asarray(v[i]) for k, v in l.items()} for l in layers],
            jnp.asarray(coords[i]), jnp.asarray(values[i]),
            jnp.asarray(weights[i]), acts, loss_name=loss_name, beta=0.01,
            unit_masks=None if true is None else
            [jnp.asarray(masks[i])] * (L - 1) + [None],
            dynamic_thres=None if th is None else jnp.asarray(th[i]),
            interpret=True, tile=256)
        np.testing.assert_allclose(float(le[i]), float(jl), rtol=1e-4,
                                   atol=1e-5)
        for l, (a, b) in enumerate(zip(ge["layers"], jg["layers"])):
            for k in ("w", "b"):
                np.testing.assert_allclose(a[k][i].numpy(), np.asarray(b[k]),
                                           rtol=1e-4, atol=1e-5,
                                           err_msg=f"block {i} d{k}{l}")
        if true is not None:
            f = true[i]
            for l, a in enumerate(ge["layers"]):
                if l < L - 1:
                    assert not a["w"][i, :, f:].any()
                    assert not a["b"][i, f:].any()
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
