"""Kernel 1's streamed form (brief_pytorch_tpu_torch/ops/stream.py,
csrc/fused_train_stream.cu) on the CPU: which chains take it (exactly
those with a layer wider than 3,327 features), its scratch in bytes, its
table, which launch sums which gradient entries (each once per split,
the splits covering the coordinates once), and its arithmetic
(`stream_emulation`: thin end layers as fmaf reductions, z_1 recomputed
from the coordinates, 3xTF32 products with tf32_split_nearest on k-blocks
of 8 summed in float32 in groups of 32 k-blocks, sums over the
coordinates in chunks and splits) against the plain version and against
the JAX package's Pallas kernel in interpret mode, on the same numpy
inputs carried across with models/phi.params_from_numpy.  The form is
forced through its plan at small widths.  The kernel itself runs on the
card only (tests/test_torch_cuda_kernels.py, chip_smoke.py phase 20).

    python -m pytest tests/test_torch_fused_train_streamed.py -q -n 4

Tolerances: the emulation against the float32 plain version,
chip_smoke.py's compare_grads (loss rel 1e-5, each gradient 1e-4 *
max|plain| + 1e-6); against the JAX kernel in interpret mode, loss rtol
1e-5, gradients rtol 1e-4 / atol 1e-5 (3xTF32 products, as
tests/test_torch_fused_train_tiled.py).
"""
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from brief_pytorch_tpu.ops import pallas_train as pt
from brief_pytorch_tpu_torch.models.phi import params_from_numpy
from brief_pytorch_tpu_torch.ops import fused_decode as fd
from brief_pytorch_tpu_torch.ops import fused_train as ft
from brief_pytorch_tpu_torch.ops import stream as st

ROWS_REACH = ft.WIDE_MAX_FEATURES   # the wide layout's widest layer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so that the emulation's many small products do
    not contend with the other test processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sweep():
    """tests/test_torch_kernel_reach.py's chains: (layers, features) up to
    64 layers and 32,768 features within the decode's 32 MB budget."""
    out = []
    for layers in (2, 3, 5, 16, 17, 20, 33, 64):
        for f in (8, 22, 64, 191, 1024, 3327, 3328, 4096, 20971, 32768):
            widths = [3] + [f] * (layers - 1) + [1]
            if 4 * sum(a * b for a, b in zip(widths[:-1], widths[1:])) <= \
                    fd.WEIGHT_BUDGET:
                out.append((layers, f))
    return out


@pytest.mark.parametrize("layers,features", _sweep(), ids=lambda v: str(v))
def test_plan_takes_exactly_the_wide_chains(layers, features):
    """The streamed form takes a chain exactly when a layer is wider than
    the wide layout takes; its ends are thin (3 coordinates, one output),
    every other layer square, its block fits the card."""
    widths = [3] + [features] * (layers - 1) + [1]
    p = ft.choose_plan(widths)
    assert bool(p.get("stream")) == (features > ROWS_REACH)
    if p.get("stream"):
        assert p["layout"] == "wide" and p["smem_bytes"] <= ft.SMEM_LIMIT
        assert p["t0"] and p["tl"]
        assert p["square"] == list(range(1, layers - 1))


@pytest.mark.parametrize("widths,t0,tl,square", [
    ([3, 20971, 1], True, True, []),
    ([3, 4096, 4096, 1], True, True, [1]),
    ([2, 4000, 3], True, True, []),
    ([7, 4000, 8], True, True, []),
    ([8, 4000, 1], False, True, [0]),
    ([3, 4000, 9], True, False, [1]),
    ([3, 4000, 5, 4000, 1], True, True, [1, 2]),
])
def test_plan_sorts_the_layers(widths, t0, tl, square):
    """Thin layer 0 when c_in + 1 <= 8, thin last layer when c_out <= 8,
    the rest square; each square layer's output has its own rows (128
    aligned), H holds the widest square input, the thin last layer's g_L
    and partial rows follow, nothing overlaps; the padded W copies are
    (round128(fin), round128(fout)) each."""
    p = st.stream_plan(widths)
    assert (p["t0"], p["tl"], p["square"]) == (t0, tl, square)
    L = len(widths) - 1
    spans = []
    for l in square:
        spans.append((p["out_row"][l], -(-widths[l + 1] // 128) * 128))
    if square:
        spans.append((p["h_row"], max(-(-widths[l] // 128) * 128
                                      for l in square)))
    if tl:
        spans.append((p["out_row"][L - 1], widths[-1]))
        assert p["n_pp"] == -(-widths[L - 1] // st.FB)
        spans.append((p["pp_row"], p["n_pp"] * widths[-1]))
    if t0:
        assert p["out_row"][0] == -1
    spans.sort()
    assert spans[0][0] == 0
    for (a, k), (b, _) in zip(spans, spans[1:]):
        assert a + k == b
    assert spans[-1][0] + spans[-1][1] == p["rows_total"]
    off = 0
    for l in range(L):
        if l in square:
            assert p["wp_off"][l] == off and p["wp_off"][l] % 4 == 0
            assert p["wp_cols"][l] == -(-widths[l + 1] // 128) * 128
            off += -(-widths[l] // 128) * 128 * p["wp_cols"][l]
        else:
            assert p["wp_off"][l] == -1
    assert p["wp_total"] == off


def test_scratch_bytes_before_and_after():
    """The device bytes one call holds.  Before (the wide layout's
    streamed form): h_l and d_l of every coordinate, B * rows_total *
    round64(N) floats, 16.8 GB for 3-20971-1 at N = 100,000.  Now: g_L
    and the forward's 82 partial rows, and the partial sums of the
    gradients: under 0.1 GB; [3, 4096, 4096, 1] at N = 16,384 stores z_2
    and H, 0.54 GB of rows against 1.07 GB, about 0.7 GB in all."""
    old = lambda widths, n: 4 * (widths[0] + 2 * sum(widths[1:-1]) +
                                 widths[-1]) * (-(-n // 64) * 64)
    widths, n = [3, 20971, 1], 100_000
    assert old(widths, n) == 16_783_769_088
    p = st.stream_plan(widths)
    sp = st.stream_splits(p, widths, n, 1)
    assert p["rows_total"] == 1 + 82 and sp["np"] == 100_096
    new = st.scratch_bytes(p, sp, 1)
    assert new == 4 * (83 * 100_096 + sp["part_total"]) + 8 * 391
    assert new < 0.1e9
    widths, n = [3, 4096, 4096, 1], 16_384
    p = st.stream_plan(widths)
    sp = st.stream_splits(p, widths, n, 1)
    assert p["rows_total"] == 4096 + 4096 + 1 + 16
    new = st.scratch_bytes(p, sp, 1)
    assert old(widths, n) == 1_074_003_968
    assert 4 * p["rows_total"] * sp["np"] < 0.54e9 and new < 0.7e9


def _coverage(p, widths):
    """The launches of brief_fused_train_stream that write the partial
    sums, as (launch, layer, first, last + 1) gradient entries of the
    layer in the packed (W (fin, fout), b) order; each writes every split
    of the regions holding them."""
    L = len(widths) - 1
    out = []
    whole = lambda l: widths[l] * widths[l + 1] + widths[l + 1]
    if p["tl"]:
        out.append(("thin_bwd", L - 1, 0, whole(L - 1)))
        if L == 2 and p["t0"]:
            out.append(("thin_bwd", 0, 0, whole(0)))
    for l in range(L):
        nw = widths[l] * widths[l + 1]
        if l in p["square"]:
            out.append(("gemm_dw", l, 0, nw))
            out.append(("rowsum", l, nw, whole(l)))
        elif l == 0 and not (L == 2 and p["tl"]):
            out.append(("rowsum_x", 0, 0, whole(0)))
    return out


@pytest.mark.parametrize("widths,n,fleet", [
    ([3, 20971, 1], 100_000, 1),
    ([3, 4096, 1], 100_000, 2),
    ([3, 4096, 4096, 1], 16_384, 1),
    ([3, 3400, 3400, 1], 3000, 1),
    ([3, 4000, 5, 4000, 1], 1000, 2),
    ([8, 4000, 9], 777, 1),
    ([3, 4000, 9], 5000, 1),
])
def test_sums_cover_every_entry_once(widths, n, fleet):
    """Every gradient entry is written by exactly one launch (coverage),
    in every split of its region; the W and b regions of the layers tile
    the partial sums; each cut of the coordinates covers [0, np) once, in
    chunks of 32 (a product's slab), each split of at least 256
    coordinates unless the call has fewer; a launch that writes W and b
    (a thin layer's) cuts both alike, and the thin backward's two layers
    (L = 2) share their cut."""
    p = st.stream_plan(widths)
    sp = st.stream_splits(p, widths, n, fleet)
    L = len(widths) - 1
    assert sp["np"] % 256 == 0 and sp["np"] >= n
    hits = [np.zeros(a * b + b, np.int64)
            for a, b in zip(widths[:-1], widths[1:])]
    for launch, l, a, b in _coverage(p, widths):
        hits[l][a:b] += 1
        s = sp["layers"][l]
        if a < widths[l] * widths[l + 1] < b:        # W and b at once
            assert (s["splits"], s["chunk"]) == (s["bsplits"], s["bchunk"])
    assert all((h == 1).all() for h in hits)
    off = 0
    for l, s in enumerate(sp["layers"]):
        fin, fout = widths[l], widths[l + 1]
        assert s["part_off"] == off
        off += s["splits"] * fin * fout
        assert s["bpart_off"] == off
        off += s["bsplits"] * fout
        for splits, chunk in ((s["splits"], s["chunk"]),
                              (s["bsplits"], s["bchunk"])):
            assert chunk % 32 == 0 and 1 <= splits <= 65535
            cover = np.zeros(sp["np"], np.int64)
            for k in range(splits):
                cover[k * chunk:min(sp["np"], (k + 1) * chunk)] += 1
            assert (cover == 1).all() and (splits - 1) * chunk < sp["np"]
            assert chunk >= 256 or splits == 1
    assert off == sp["part_total"]
    if L == 2 and p["t0"] and p["tl"]:
        assert sp["layers"][0]["splits"] == sp["layers"][1]["splits"]
        assert sp["layers"][0]["chunk"] == sp["layers"][1]["chunk"]


def test_table_rows():
    """One StreamLayer row (16 words) a layer: widths, activation, offsets,
    rows, mask offset, the partial regions, w0 as its float32 bits."""
    widths = [3, 320, 320, 1]
    acts = (("sine", 20.0), ("sine", 30.0), ("none", 1.0))
    p = st.stream_plan(widths)
    sp = st.stream_splits(p, widths, 1000, 1)
    words = st.stream_table(p, widths, acts, [0, 320, -1], sp)
    rows = np.asarray(words, np.int32).reshape(3, st.STREAM_ROW_WORDS)
    assert rows[:, 0].tolist() == widths[:-1]
    assert rows[:, 1].tolist() == widths[1:]
    assert rows[:, 2].tolist() == [1, 1, 0]
    assert rows[:, 3].tolist() == p["p_off"]
    assert rows[:, 6].tolist() == p["out_row"]
    assert rows[:, 7].tolist() == [0, 320, -1]
    assert rows[:, 9].tolist() == [s["splits"] for s in sp["layers"]]
    assert rows[:, 11].tolist() == [s["bpart_off"] for s in sp["layers"]]
    assert rows[:, 13].tolist() == [s["bsplits"] for s in sp["layers"]]
    assert rows[:, 12].view(np.float32).tolist() == [20.0, 30.0, 1.0]


def test_a_streamed_chain_never_falls_back():
    """The launch goes to the streamed form's library and nowhere else:
    where it cannot be built or run (here: no nvcc, CPU tensors) the call
    raises; nothing runs the plain version, the rows form or autograd in
    its place."""
    widths = [3, 4096, 1]
    layers = [{"w": torch.zeros(1, 3, 4096), "b": torch.zeros(1, 4096)},
              {"w": torch.zeros(1, 4096, 1), "b": torch.zeros(1, 1)}]
    params = torch.cat([t.reshape(1, -1) for l in layers
                        for t in (l["w"], l["b"])], 1)
    x = torch.zeros(1, 3, 300)
    y = torch.zeros(1, 1, 300)
    p = ft.choose_plan(widths)
    assert p.get("stream")
    with pytest.raises(RuntimeError):
        st.launch(p, params, x, y, y, widths,
                  (("sine", 20.0), ("none", 1.0)), None, [-1, -1], None, 0,
                  0.01)


# ---- the arithmetic --------------------------------------------------------
def _fleet_np(widths, B, n, seed, true=None, acts_kind="sine"):
    """SIREN-initialised chains (numpy), their unit masks (true widths of
    the hidden layers, None: unmasked), a batch and thresholds."""
    rng = np.random.default_rng(seed)
    L = len(widths) - 1
    layers = []
    for l, (fin, fout) in enumerate(zip(widths[:-1], widths[1:])):
        r = 1.0 / fin if l == 0 else np.sqrt(6.0 / fin) / 20.0
        layers.append({"w": rng.uniform(-r, r, (B, fin, fout)).astype(
            np.float32), "b": rng.uniform(-r, r, (B, fout)).astype(
                np.float32)})
    masks = None
    if true is not None:
        masks = np.zeros((B, widths[1]), np.float32)
        for i, f in enumerate(true):
            masks[i, :f] = 1.0
    coords = rng.uniform(-1, 1, (B, widths[0], n)).astype(np.float32)
    values = rng.uniform(0, 1, (B, widths[-1], n)).astype(np.float32)
    weights = (1 + rng.uniform(0, 1, (B, widths[-1], n))).astype(np.float32)
    thres = np.array([0.5, -np.inf, 0.6][:B], np.float32)
    if acts_kind == "sine":
        acts = (("sine", 20.0),) * (L - 1) + (("none", 1.0),)
    else:
        acts = tuple((("relu", 1.0), ("sigmoid", 1.0))[l % 2]
                     for l in range(L - 1)) + (("none", 1.0),)
    return layers, masks, coords, values, weights, thres, acts


@pytest.mark.parametrize("widths,true,n,acts_kind,loss_name", [
    ([3, 3400, 1], None, 300, "sine", "datal2"),          # 3-3400-1
    ([3, 320, 320, 1], None, 300, "sine", "datal2"),      # a square layer
    ([3, 320, 320, 1], (313, 320), 257, "sine", "datasmoothl1"),
    ([3, 320, 320, 1], (300, 320), 300, "relu", "datal2"),
    ([3, 96, 96, 96, 1], None, 280, "sine", "datal2"),    # two square layers
    ([3, 300, 3], None, 300, "sine", "datasmoothl1"),     # c_out = 3
    ([2, 400, 1], (390, 400), 300, "sine", "datal2"),     # 2-D, masked
])
def test_emulation_matches_plain_and_pallas(widths, true, n, acts_kind,
                                            loss_name):
    """The streamed form's arithmetic, forced through its plan: within
    compare_grads' tolerances of the float32 plain version, and of the JAX
    kernel in interpret mode block by block; padded units' gradients
    exactly 0."""
    L = len(widths) - 1
    B = 1 if true is None else len(true)
    layers, masks, coords, values, weights, thres, acts = _fleet_np(
        widths, B, n, seed=n + L, true=true, acts_kind=acts_kind)
    if true is not None:       # padded units carry zero weights
        for l in range(L):
            if l > 0:
                layers[l]["w"] *= masks[:, :, None]
            if l < L - 1:
                layers[l]["w"] *= masks[:, None, :]
                layers[l]["b"] *= masks
    tl = params_from_numpy(layers)["layers"]
    tc, tv, tw = (torch.from_numpy(a) for a in (coords, values, weights))
    tt = torch.from_numpy(thres[:B]) if true is not None else None
    tm = None if true is None else \
        [torch.from_numpy(masks)] * (L - 1) + [None]
    kw = dict(loss_name=loss_name, beta=0.05)
    le, ge = st.stream_emulation(tl, tc, tv, tw, acts, thres=tt,
                                 unit_masks=tm, plan=st.stream_plan(widths),
                                 **kw)
    lp, gp = ft.fused_train_grads_reference(tl, tc, tv, tw, acts,
                                            weight_thres=tt, unit_masks=tm,
                                            **kw)
    assert bool(((le - lp).abs() <= 1e-5 * lp.abs()).all())
    for a, b in zip(ge["layers"], gp["layers"]):
        for key in ("w", "b"):
            d = float((a[key] - b[key]).abs().max())
            assert d <= 1e-4 * float(b[key].abs().max()) + 1e-6, key
    for i in range(B):
        jl, jg = pt.fused_train_grads(
            [{k: jnp.asarray(v[i]) for k, v in l.items()} for l in layers],
            jnp.asarray(coords[i]), jnp.asarray(values[i]),
            jnp.asarray(weights[i]), acts,
            unit_masks=None if true is None else
            [jnp.asarray(masks[i])] * (L - 1) + [None],
            dynamic_thres=None if true is None else jnp.asarray(thres[i]),
            interpret=True, tile=256, **kw)
        np.testing.assert_allclose(float(le[i]), float(jl), rtol=1e-5)
        for l, (a, b) in enumerate(zip(ge["layers"], jg["layers"])):
            for k in ("w", "b"):
                np.testing.assert_allclose(a[k][i].numpy(), np.asarray(b[k]),
                                           rtol=1e-4, atol=1e-5,
                                           err_msg=f"block {i} d{k}{l}")
            if true is not None:
                f = true[i]
                if l < L - 1:
                    assert not a["w"][i, :, f:].any()
                    assert not a["b"][i, f:].any()
                if l > 0:
                    assert not a["w"][i, f:, :].any()


@pytest.mark.parametrize("widths", [[8, 200, 200, 1], [3, 200, 200, 10],
                                    [3, 200, 5, 200, 1]])
def test_emulation_of_square_ends(widths):
    """Chains whose ends are not thin (8 coordinate channels, 10 outputs)
    or with a thin middle layer: every layer the kernel cannot reduce
    runs as a padded square product; against the plain version."""
    layers, _, coords, values, weights, _, acts = _fleet_np(widths, 1, 260,
                                                            seed=5)
    tl = params_from_numpy(layers)["layers"]
    tc, tv, tw = (torch.from_numpy(a) for a in (coords, values, weights))
    le, ge = st.stream_emulation(tl, tc, tv, tw, acts, loss_name="datal2",
                                 plan=st.stream_plan(widths))
    lp, gp = ft.fused_train_grads_reference(tl, tc, tv, tw, acts,
                                            loss_name="datal2")
    assert bool(((le - lp).abs() <= 1e-5 * lp.abs()).all())
    for a, b in zip(ge["layers"], gp["layers"]):
        for key in ("w", "b"):
            d = float((a[key] - b[key]).abs().max())
            assert d <= 1e-4 * float(b[key].abs().max()) + 1e-6, key


def test_grouped_sums_hold_a_long_product():
    """A 2,048-wide reduction (256 k-blocks) summed as the kernel sums it,
    in groups of 32 k-blocks: within a few float32 ulps of the float64
    product, as close as the plain float32 product."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0, 1, (1, 16, 2048)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(0, 1, (1, 2048, 8)).astype(np.float32))
    truth = a.double() @ b.double()
    got = st._product(a, b).double()
    plain = (a @ b).double()
    err = float(((got - truth).abs() / truth).max())
    assert err <= 4 * float(((plain - truth).abs() / truth).max()) + 1e-7
    assert err < 2e-6 and math.isfinite(err)
