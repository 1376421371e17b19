"""The port's kernels past their old reach (16 layers, 3,327 features, 4
grid axes), on the CPU: the plain versions of kernels 1, 2 and 3
(ops/fused_train.py, ops/fused_decode.py, ops/fused_siren.py) against the
JAX package's Pallas kernels in interpret mode at 20 layers, past 3,327
features and on a 5-axis grid, with the same numpy inputs; the per-layer
tables the kernels read from device memory; and a plan, naming its
layout, for every chain of up to 64 layers and 32,768 features within the
decode's weight budget.  The kernels themselves run on the card only
(tests/test_torch_cuda_kernels.py, chip_smoke.py phase 20).

Tolerances (those of tests/test_torch_fused_train.py,
test_torch_fused_decode_tc.py and test_torch_fused_siren_tc.py): kernel 1
loss rtol 1e-5, gradients atol 1e-5 / rtol 1e-4 (both sum the batch in
float32, in other orders); kernels 2 and 3 atol 1e-5 against the Pallas
kernel.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from brief_pytorch_tpu.ops import pallas_decode as pd
from brief_pytorch_tpu.ops import pallas_siren as ps
from brief_pytorch_tpu.ops import pallas_train as pt
from brief_pytorch_tpu_torch.ops import chain_stream as cs
from brief_pytorch_tpu_torch.ops import fused_decode as fd
from brief_pytorch_tpu_torch.ops import fused_siren as fs
from brief_pytorch_tpu_torch.ops import fused_train as ft
from brief_pytorch_tpu_torch.ops import stream as st

DEEP = [3] + [8] * 19 + [1]          # 20 layers
WIDE = [3, 3400, 1]                  # past 3,327 features
WIDE2 = [3, 3400, 3400, 1]
SINE = ("sine", 20.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The wide chains' matmuls: one intra-op thread, so that they do not
    contend with the other test processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layers(widths, seed, w0=20.0):
    """SIREN's initialisation rule per layer, from a numpy seed."""
    rng = np.random.default_rng(seed)
    layers = []
    for l, (fin, fout) in enumerate(zip(widths[:-1], widths[1:])):
        r = 1.0 / fin if l == 0 else np.sqrt(6.0 / fin) / w0
        layers.append({"w": rng.uniform(-r, r, (fin, fout)).astype(np.float32),
                       "b": rng.uniform(-r, r, fout).astype(np.float32)})
    return layers


def _acts(widths):
    return (SINE,) * (len(widths) - 2) + (("none", 1.0),)


def _torch(layers):
    return [{k: torch.from_numpy(v) for k, v in l.items()} for l in layers]


def _jax(layers):
    return [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]


def _batch(c_in, n, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, lo=0.0, hi=1.0: rng.uniform(lo, hi, s).astype(np.float32)
    return f(c_in, n, lo=-1.0), f(1, n), 1 + f(1, n)


def _close_grads(tl, tg, jl, jg):
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for l, (a, b) in enumerate(zip(tg, jg)):
        for k in ("w", "b"):
            assert tuple(a[k].shape) == tuple(b[k].shape)
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       atol=1e-5, rtol=1e-4,
                                       err_msg=f"d{k} layer {l}")


# --- kernel 1: the train step -------------------------------------------
@pytest.mark.parametrize("widths,n", [(DEEP, 600), (WIDE, 300),
                                      (WIDE2, 256)],
                         ids=["20-layers", "3-3400-1", "3-3400x2-1"])
@pytest.mark.parametrize("loss_name", ["datal2", "datasmoothl1"])
def test_train_plain_matches_pallas(widths, n, loss_name):
    layers = _layers(widths, seed=len(widths))
    coords, values, weights = _batch(3, n, seed=n)
    acts = _acts(widths)
    kw = dict(loss_name=loss_name, beta=0.01, weight_thres=0.7)
    jl, jg = pt.fused_train_grads(
        _jax(layers), jnp.asarray(coords), jnp.asarray(values),
        jnp.asarray(weights), acts, tile=256, interpret=True, **kw)
    tl, tg = ft.fused_train_grads(
        _torch(layers), torch.from_numpy(coords), torch.from_numpy(values),
        torch.from_numpy(weights), acts, **kw)
    _close_grads(tl, tg["layers"], jl, jg["layers"])


@pytest.mark.parametrize("true_widths,layers_", [((5, 7, 8), 20),
                                                 ((3300, 3400), 2)],
                         ids=["3x20-layers", "2x3-3400-1"])
def test_train_fleet_plain_matches_pallas(true_widths, layers_):
    """The fleet form: chains padded to the widest with unit masks and a
    threshold per block (-inf: none) against the JAX kernel per block, as
    jax.vmap runs it in block_trainer.run_block_segment."""
    n, B = 300, len(true_widths)
    width = max(true_widths)
    padded = [3] + [width] * (layers_ - 1) + [1]
    acts = _acts(padded)
    blocks, masks = [], []
    for i, f in enumerate(true_widths):
        own = _layers([3] + [f] * (layers_ - 1) + [1], seed=10 + i)
        pad = []
        for l in own:
            w = np.zeros((width if l["w"].shape[0] > 3 else 3,
                          width if l["w"].shape[1] > 1 else 1), np.float32)
            w[:l["w"].shape[0], :l["w"].shape[1]] = l["w"]
            b = np.zeros(w.shape[1], np.float32)
            b[:l["b"].shape[0]] = l["b"]
            pad.append({"w": w, "b": b})
        blocks.append(pad)
        masks.append((np.arange(width) < f).astype(np.float32))
    batch = [_batch(3, n, seed=20 + i) for i in range(B)]
    thres = np.array([0.6, -np.inf, 0.4][:B], np.float32)
    stacked = [{k: torch.from_numpy(np.stack([blk[l][k] for blk in blocks]))
                for k in ("w", "b")} for l in range(layers_)]
    unit = [torch.from_numpy(np.stack(masks))] * (layers_ - 1) + [None]
    tl, tg = ft.fused_train_grads_fleet(
        stacked, *(torch.from_numpy(np.stack([b[j] for b in batch]))
                       for j in range(3)), acts, loss_name="datal2",
        beta=0.01, unit_masks=unit, thres=torch.from_numpy(thres))
    for i in range(B):
        jl, jg = pt.fused_train_grads(
            _jax(blocks[i]), *(jnp.asarray(x) for x in batch[i]), acts,
            loss_name="datal2", beta=0.01, tile=256, interpret=True,
            unit_masks=[jnp.asarray(masks[i])] * (layers_ - 1) + [None],
            dynamic_thres=jnp.float32(thres[i]))
        _close_grads(tl[i], [{k: g[k][i] for k in ("w", "b")}
                             for g in tg["layers"]], jl, jg["layers"])


# --- kernel 2: the grid decode --------------------------------------------
@pytest.mark.parametrize("widths,spatial", [
    (DEEP, (5, 6, 7)),                       # 20 layers
    ([5, 22, 22, 22, 22, 1], (2, 3, 4, 5, 6)),   # a 5-axis grid
    ([3, 3400, 1], (3, 4, 5)),               # past 3,327 features
], ids=["20-layers", "5-axes", "3-3400-1"])
def test_decode_plain_matches_pallas(widths, spatial):
    layers = _layers(widths, seed=len(spatial))
    acts = _acts(widths)
    ref = np.asarray(pd.fused_decode_grid(_jax(layers), spatial, acts, "n11",
                                          tile=256, interpret=True))
    out = fd.fused_decode_grid(_torch(layers), spatial, acts, "n11")
    assert out.shape == ref.shape == (int(np.prod(spatial)), widths[-1])
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("spatial", [(2, 3, 4, 5, 6), (2, 3, 2, 3, 2, 3, 2,
                                                        3, 4)])
def test_split_index_any_number_of_axes(spatial):
    """The wide form's split of the flat voxel index (v // stride_a -
    (v // stride_{a-1}) size_a, 32-bit multiply-shifts) against numpy's
    unravel_index, for grids past the narrow form's 4 axes."""
    v = np.arange(int(np.prod(spatial)))
    lead, idx = fd.split_index(v, spatial)
    want = np.unravel_index(v, spatial)
    np.testing.assert_array_equal(lead, want[0])
    for a, got in enumerate(idx):
        np.testing.assert_array_equal(got, want[1 + a])


# --- kernel 3: the batch-major forward ------------------------------------
@pytest.mark.parametrize("widths,n", [(DEEP, 300), (WIDE, 200)],
                         ids=["20-layers", "3-3400-1"])
def test_siren_plain_matches_pallas(widths, n):
    layers = _layers(widths, seed=n)
    acts = _acts(widths)
    x = np.random.default_rng(n).uniform(-1, 1, (n, 3)).astype(np.float32)
    ref = np.asarray(ps.fused_chain_apply(_jax(layers), jnp.asarray(x), acts,
                                          tile=256, interpret=True))
    out = fs.fused_chain_apply(_torch(layers), torch.from_numpy(x), acts)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("widths", [[3, 300, 1], [3, 300, 300, 1],
                                    [3, 257, 257, 257, 1]],
                         ids=["3-300-1", "3-300x2-1", "3-257x3-1"])
def test_streamed_sums_model(widths):
    """Chains of 257-3,327 features (3-300-1: the thin 3-F-1 sums; the
    others: square layers in 64-column tiles, their 38 or 33 k-blocks in
    groups of 32) take the streamed form in both kernels, and its model
    through fused_siren.chain_tc_model given the plan agrees with the
    plain version; where the chain is narrow the plan changes nothing."""
    layers = _torch(_layers(widths, seed=3))
    acts = _acts(widths)
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (64, 3)).astype(np.float32))
    plan = fs.choose_plan(widths)
    assert plan == fd.choose_plan(widths) == cs.stream_plan(widths)
    plain = fs.fused_chain_apply_reference(layers, x, acts)
    emu = fs.chain_tc_model(layers, x, acts, plan=plan)
    assert float((emu - plain).abs().max()) <= \
        2e-6 + 2e-6 * float(plain.abs().max())
    narrow = [3, 22, 22, 1]
    nl = _torch(_layers(narrow, seed=4))
    assert torch.equal(
        fs.chain_tc_model(nl, x, _acts(narrow)),
        fs.chain_tc_model(nl, x, _acts(narrow),
                          plan=fs.choose_plan(narrow)))


# --- the plans and the tables ---------------------------------------------
def _sweep():
    """(layers, features) up to 64 layers and 32,768 features whose
    weights take at most the decode's 32 MB budget."""
    out = []
    for layers in (2, 3, 5, 16, 17, 20, 33, 64):
        for f in (8, 22, 64, 191, 1024, 3327, 3328, 4096, 20971, 32768,
                  256, 257):
            widths = [3] + [f] * (layers - 1) + [1]
            if 4 * sum(a * b for a, b in zip(widths[:-1], widths[1:])) <= \
                    fd.WEIGHT_BUDGET:
                out.append((layers, f))
    return out


@pytest.mark.parametrize("layers,features", _sweep(),
                         ids=lambda v: str(v))
def test_every_chain_has_a_plan(layers, features):
    widths = [3] + [features] * (layers - 1) + [1]
    p1 = ft.choose_plan(widths)
    assert p1["layout"] in ("narrow", "tiled", "wide")
    assert p1["smem_bytes"] <= ft.SMEM_LIMIT
    if p1["layout"] == "wide":
        assert p1["stream"] == (max(widths) > ft.WIDE_MAX_FEATURES)
    for mod in (fd, fs):
        p = mod.choose_plan(widths)
        assert p["layout"] in ("narrow", "wide")
        assert p["smem_bytes"] <= fd.SMEM_LIMIT
        # past 256 features the streamed form (ops/chain_stream.py), the
        # only one that keeps activations in a device scratch
        assert bool(p.get("stream")) == (max(widths) > 256)
    p5 = fd.choose_plan([5] + widths[1:])     # a 5-axis grid: the wide form
    assert p5["layout"] == "wide"


@pytest.mark.parametrize("widths", [DEEP, [3] + [9] * 19 + [1],
                                    [3] + [78] * 19 + [1], WIDE, WIDE2])
def test_tables_hold_every_layer(widths):
    """Each kernel's per-layer table: one row of the kernel's struct size
    per layer, whatever the depth (the narrow and tiled layouts' dW job
    codes after their rows), w0 as its float32 bits."""
    acts = _acts(widths)
    L = len(widths) - 1
    p = ft.choose_plan(widths)
    masks = [-1] * L
    if p["layout"] == "narrow":
        words = ft.narrow_table(p, widths, acts, masks, [0] * (3 * L))
        assert len(words) == L * ft.NARROW_ROW_WORDS + len(p["job_table"])
    elif p["layout"] == "tiled":
        words = ft.tiled_table(p, widths, acts, masks)
        assert len(words) == L * ft.TILED_ROW_WORDS + len(ft.dw_codes(p))
    else:   # the wide layout's rows form, or its streamed form
        if p["stream"]:
            words = st.stream_table(p, widths, acts, masks,
                                    st.stream_splits(p, widths, 1000, 1))
        else:
            words = ft.wide_table(p, widths, acts, masks,
                                  ft.dw_split(1000, 1, widths))
        assert len(words) == L * ft.WIDE_ROW_WORDS == L * st.STREAM_ROW_WORDS
        rows = np.asarray(words, np.int32).reshape(L, ft.WIDE_ROW_WORDS)
        assert rows[:, 0].tolist() == widths[:-1]
        assert rows[:, 1].tolist() == widths[1:]
        w0 = rows[:-1, 12].astype(np.int32).view(np.float32)
        assert w0.tolist() == [20.0] * (L - 1)
    pd_ = fd.choose_plan(widths)
    table = cs.stream_table if pd_.get("stream") else fd.chain_table
    words = table(pd_, widths, acts, [0] * (2 * L)) + \
        fd.axis_table((4, 5, 6), False)
    assert len(words) == L * fd.CHAIN_ROW_WORDS + 3 * fd.AXIS_ROW_WORDS
