"""Kernels 2 and 3's streamed form on the CPU (brief_pytorch_tpu_torch/ops/
chain_stream.py; csrc/chain_stream.cuh): which chains take it, the scratch
a call holds, its table, and its arithmetic emulated (`stream_model`, also
through fused_siren.chain_tc_model given the plan) against the plain
versions and the JAX package's Pallas kernels in interpret mode, the form
forced through `stream_plan` at small widths.  The kernels themselves run
on the card only (tests/test_torch_cuda_kernels.py, chip_smoke.py phase
20d).

Inputs and weights come from numpy seeds, carried into both packages
(the φ cases through `params_from_numpy`).  Tolerances: against the
float32 plain version, 2e-6 + 2e-6 * max|plain| (the chains' sums in
another float32 order: fmaf by feature, 3xTF32 k-blocks in groups);
against the Pallas kernel in interpret mode, atol 1e-5 (the tolerance of
tests/test_torch_fused_decode_tc.py and test_torch_fused_siren_tc.py);
against a float64 evaluation, at most 2 x the plain version's distance,
max and mean (chip_smoke.py's F64_RATIO).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from brief_pytorch_tpu.models.phi import init_phi as jinit
from brief_pytorch_tpu.ops import pallas_decode as pd
from brief_pytorch_tpu.ops import pallas_siren as ps
from brief_pytorch_tpu_torch.models import phi as tphi
from brief_pytorch_tpu_torch.ops import chain_stream as cs
from brief_pytorch_tpu_torch.ops import fused_decode as fd
from brief_pytorch_tpu_torch.ops import fused_siren as fs
from brief_pytorch_tpu_torch.ops.chain import chain_layer_specs

from test_torch_kernel_reach import _sweep

pytestmark = pytest.mark.skipif(not ps._HAS_PALLAS, reason="no pallas")

TIGHT = (2e-6, 2e-6)         # (absolute, times max|plain|)
F64_RATIO = 2.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulation is many float64 elementwise ops: one intra-op thread,
    so that it does not contend with the other test processes' threads."""
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


def _torch(layers):
    return [{k: torch.from_numpy(v) for k, v in l.items()} for l in layers]


def _jax(layers):
    return [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]


def _acts(widths, act="sine"):
    w0 = 20.0 if act == "sine" else 1.0
    return ((act, w0),) * (len(widths) - 2) + (("none", 1.0),)


def _rows(n, c, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (n, c)).astype(
        np.float32)


def _close(out, plain, tol=TIGHT):
    assert out.shape == plain.shape
    assert float((out - plain).abs().max()) <= \
        tol[0] + tol[1] * float(plain.abs().max())


def _float64(layers, x, acts):
    h = x.double()
    for layer, (act, w0) in zip(layers, acts):
        z = (h @ layer["w"].double() + layer["b"].double()).float()
        h = fs._act(z, act, w0).double()
    return h


# --- which chains take it, and what a call holds --------------------------
@pytest.mark.parametrize("layers,features", _sweep(), ids=lambda v: str(v))
def test_exactly_the_wide_chains_take_it(layers, features):
    """Over the reach sweep of tests/test_torch_kernel_reach.py, both
    kernels' plans are the streamed form exactly where a layer is wider
    than 256 features (a 5-axis grid too), never at or below, and its
    shared memory fits a block."""
    assert cs.STREAM_WIDTH == 256
    widths = [3] + [features] * (layers - 1) + [1]
    for mod in (fd, fs):
        for w in (widths, [5] + widths[1:]):
            p = mod.choose_plan(w)
            assert bool(p.get("stream")) == (max(w) > 256)
            assert p["smem_bytes"] <= fd.SMEM_LIMIT
            if p.get("stream"):
                assert p == cs.stream_plan(w)
                assert p["layout"] == "wide"


@pytest.mark.parametrize("widths,thin,square", [
    ([3, 20971, 1], True, []),                 # 3-F-1: no product
    ([3, 22213, 1], True, []),                 # the demo volume at 80x
    ([3, 4096, 4096, 1], False, [1]),          # one square layer
    ([3, 3400, 3400, 3400, 2], False, [1, 2]),
    ([12, 3400, 5], False, [0]),               # c_in + 1 > 8: square in
    ([3, 3400, 20], False, [1]),               # c_out > 8: square out
    ([3, 3400], False, [0]),                   # one layer
])
def test_plan_sorts_the_layers(widths, thin, square):
    p = cs.stream_plan(widths)
    assert (p["thin"], p["square"]) == (thin, square)
    for l in range(len(widths) - 1):
        if l in square:
            # 64-column tiles where they pad less (the 20 outputs)
            gn = 64 if -(-widths[l + 1] // 64) % 2 else 128
            assert p["gn"][l] == gn
            assert p["wp_cols"][l] == -(-widths[l + 1] // gn) * gn
            assert p["wp_off"][l] >= 0
        else:
            assert p["wp_off"][l] == -1
    assert p["wp_total"] == sum(-(-widths[l] // 32) * 32 * p["wp_cols"][l]
                                for l in square)


@pytest.mark.parametrize("widths,stream", [
    ([3] + [256] * 4 + [1], False),            # the widest in shared memory
    ([3] + [257] * 4 + [1], True),             # one feature past it
    ([3, 257, 1], True),                       # a 3-F-1 chain
    ([2] + [256] * 2 + [3], False),
    ([256, 22, 22, 1], False),                 # kernel 3: the widest input
    ([257, 22, 22, 1], True),                  # an input past 256
    ([300, 8, 1], True),
])
def test_the_edge_at_256(widths, stream):
    """Both kernels send a chain to the streamed form exactly where a layer
    or the input passes 256 features; at or below it the wide form's plan
    holds its rows in shared memory, and wide_plan refuses a layer past
    it (an input of 257-424 features would still fit its shared memory:
    the streamed form takes it all the same)."""
    for mod in (fd, fs):
        if mod is fd and widths[0] > fd.NARROW_AXES + 8:
            continue                # no grid has so many axes
        p = mod.choose_plan(widths)
        assert bool(p.get("stream")) == stream
        assert p["smem_bytes"] <= fd.SMEM_LIMIT
        if stream:
            assert p == cs.stream_plan(widths)
    if max(widths[1:]) > 256:
        with pytest.raises(ValueError):
            fd.wide_plan(widths)
    else:
        assert not fd.wide_plan(widths).get("stream")


@pytest.mark.parametrize("fout,gn,cols", [
    (257, 64, 320), (300, 64, 320), (320, 64, 320), (383, 128, 384),
    (384, 128, 384), (448, 64, 448), (1024, 128, 1024), (3400, 128, 3456),
])
def test_narrow_tiles(fout, gn, cols):
    """A square layer takes 64-column product tiles where they pad its
    outputs less than 128-column ones (257 and 300 features: 320 columns
    against 384), else 128.  The thin last layer's partial sums count the
    tiles of its input layer."""
    widths = [3, fout, fout, 1]
    p = cs.stream_plan(widths)
    assert (p["gn"][1], p["wp_cols"][1]) == (gn, cols)
    assert p["wp_total"] == -(-fout // 32) * 32 * cols
    call = cs.stream_call(p, 1000)
    assert call["tiles"] == cols // gn
    assert call["part_floats"] == call["tiles"] * call["R"]
    assert cols <= -(-fout // 128) * 128


@pytest.mark.parametrize("widths,n", [
    ([3, 20971, 1], 64 ** 3), ([3, 20971, 1], 65_536),
    ([3, 22213, 1], 64 * 512 * 512), ([3, 22213, 1], 10_112),
    ([3, 4096, 4096, 1], 65_536), ([3, 4096, 4096, 1], 64 ** 3),
    ([3, 3400, 3400, 3400, 2], 1000), ([12, 3400, 5], 300),
])
def test_call_chunks_and_scratch(widths, n):
    """A call's chunks cover its rows in multiples of 128, the H buffers
    within H_BUDGET, a full chunk a whole number of waves of product
    blocks (one an SM), the thin sums' splits within the feature blocks;
    the scratch it holds, in bytes, against the 2 x 132 x rows x 132
    floats the wide form's scratch instance once held (2.92 GB at
    3-20971-1; rows: 8 x the most k-blocks of a layer input)."""
    p = cs.stream_plan(widths)
    call = cs.stream_call(p, n)
    assert call["R"] % 128 == 0 and call["chunks"] * call["R"] >= n > \
        (call["chunks"] - 1) * call["R"]
    assert p["n_h"] * call["h_floats"] * 4 <= cs.H_BUDGET
    if p["thin"]:
        assert 1 <= call["S"] <= p["n_fb"] and call["kernels"] == \
            2 * call["chunks"]
        assert call["part_floats"] == call["S"] * call["R"] * widths[-1]
    else:
        assert call["kernels"] == 1 + call["chunks"] * (
            1 + len(p["square"]) + int(p["tl"]))
        if call["chunks"] > 1:
            cols = max(c // g for c, g in zip(p["wp_cols"], p["gn"]) if g)
            assert call["R"] // 128 * cols % cs.H100_SMS == 0
    old_rows = 8 * max(fd.packed_layout(widths)["kb"])
    old_bytes = 4 * 132 * 2 * old_rows * fd.WIDE_STRIDE
    got = cs.scratch_bytes(p, call)
    assert got == 4 * (p["wp_total"] + p["n_h"] * call["h_floats"]
                       + call["part_floats"])
    if widths == [3, 20971, 1]:
        assert old_bytes > 2.9e9 and got < 1e7
    if widths == [3, 4096, 4096, 1]:    # 24 waves of 132 blocks a chunk
        assert call["R"] == 99 * 128
        assert got == 4 * (4096 * 4096 + 4096 * 12672 + 32 * 12672)


def test_table_rows():
    """One 48-byte StreamLayer row a layer: the W and b pointers, widths,
    activation, w0's float32 bits, the padded copy's offset and stride;
    kernel 2 appends the grid's axis rows."""
    widths = [3, 4096, 4096, 1]
    p = cs.stream_plan(widths)
    acts = _acts(widths)
    words = cs.stream_table(p, widths, acts, list(range(100, 106)))
    rows = np.asarray(words, np.int32).reshape(3, cs.ROW_WORDS)
    assert rows[:, 0].tolist() == [100, 102, 104]
    assert rows[:, 4].tolist() == widths[:-1]
    assert rows[:, 5].tolist() == widths[1:]
    assert rows[:, 7].view(np.float32).tolist() == [20.0, 20.0, 1.0]
    assert rows[:, 8].tolist() == [-1, 0, -1]
    assert rows[:, 9].tolist() == [0, 4096, 0]
    assert rows[:, 10].tolist() == [0, 128, 0]


# --- the arithmetic --------------------------------------------------------
ROW_CASES = [
    # (label, widths, hidden activation, rows)
    ("3-3400-1", [3, 3400, 1], "sine", 200),
    ("3-320-320-1", [3, 320, 320, 1], "sine", 300),
    ("3-200x3-3", [3, 200, 200, 200, 3], "relu", 130),
    ("12-200-300-5", [12, 200, 300, 5], "sine", 150),
    ("3-500-20", [3, 500, 20], "sigmoid", 100),
    ("2-300-2", [2, 300, 2], "sine", 257),
]


@pytest.mark.parametrize("label,widths,act,n", ROW_CASES,
                         ids=[c[0] for c in ROW_CASES])
def test_rows_model_matches_plain_and_pallas(label, widths, act, n):
    """Kernel 3's streamed form forced at small widths: the emulated
    arithmetic (thin ends by fmaf, 3xTF32 k-blocks in groups, the
    epilogue's partial sums in order) against the plain version, the
    Pallas kernel in interpret mode and (sine chains) float64."""
    layers = _layers(widths, seed=len(label))
    acts = _acts(widths, act)
    x = _rows(n, widths[0], seed=n)
    plan = cs.stream_plan(widths)
    emu = fs.chain_tc_model(_torch(layers), torch.from_numpy(x), acts,
                            plan=plan)
    assert torch.equal(emu, cs.stream_model(_torch(layers),
                                            torch.from_numpy(x), acts, plan))
    plain = fs.fused_chain_apply_reference(_torch(layers),
                                           torch.from_numpy(x), acts)
    _close(emu, plain)
    ref = np.asarray(ps.fused_chain_apply(_jax(layers), jnp.asarray(x), acts,
                                          tile=256, interpret=True))
    np.testing.assert_allclose(emu.numpy(), ref, rtol=0, atol=1e-5)
    if act != "sine":   # relu / sigmoid outputs here are mostly exact
        return
    truth = _float64(_torch(layers), torch.from_numpy(x), acts)
    e_emu, e_plain = (emu.double() - truth).abs(), (plain.double() -
                                                   truth).abs()
    assert float(e_emu.max()) <= F64_RATIO * float(e_plain.max())
    assert float(e_emu.mean()) <= F64_RATIO * float(e_plain.mean())


RANGE_CASES = [
    # (hidden widths, activation): 257-3,327 features, once the wide
    # form's scratch instance's
    (257, "sine"), (257, "relu"), (257, "sigmoid"),
    (300, "sine"), (300, "relu"), (300, "sigmoid"),
    (383, "sine"), (383, "relu"), (383, "sigmoid"),
]


@pytest.mark.parametrize("f,act", RANGE_CASES,
                         ids=[f"3-{f}x4-1-{a}" for f, a in RANGE_CASES])
def test_range_257_to_3327_matches_plain_pallas_and_float64(f, act):
    """3-Fx4-1 for F of 257, 300 and 383 (the streamed form's square
    layers in 64-column tiles at 257 and 300, 128 at 383; its thin ends)
    as both kernels take it: kernel 3 on rows and kernel 2 on the
    coordinates it builds from a grid, each through
    fused_siren.chain_tc_model given the plan (chain_stream.stream_model),
    against the plain version (TIGHT), the Pallas kernel in interpret mode
    (atol 1e-5) and a float64 evaluation (at most F64_RATIO x the plain
    version's distance, max and mean).  The weights follow SIREN's rule
    with the chain's own w0 (1 for relu and sigmoid: at w0 = 20 their
    outputs are the last bias to within an ulp, and a distance from
    float64 says nothing)."""
    widths = [3] + [f] * 4 + [1]
    plan = fs.choose_plan(widths)
    assert plan == fd.choose_plan(widths) == cs.stream_plan(widths)
    layers = _layers(widths, seed=f, w0=20.0 if act == "sine" else 1.0)
    acts = _acts(widths, act)
    spatial = (3, 5, 7)
    for x, ref in (
            (torch.from_numpy(_rows(96, 3, seed=f)), None),
            (fd.grid_coords(spatial, "n11"), np.asarray(pd.fused_decode_grid(
                _jax(layers), spatial, acts, "n11", tile=128,
                interpret=True)))):
        emu = fs.chain_tc_model(_torch(layers), x, acts, plan=plan)
        assert torch.equal(emu, cs.stream_model(_torch(layers), x, acts,
                                                plan))
        plain = fs.fused_chain_apply_reference(_torch(layers), x, acts)
        _close(emu, plain)
        if ref is None:
            ref = np.asarray(ps.fused_chain_apply(
                _jax(layers), jnp.asarray(x.numpy()), acts, tile=256,
                interpret=True))
        else:
            _close(plain, fd.fused_decode_grid_reference(
                _torch(layers), spatial, acts, "n11"), (0.0, 0.0))
        np.testing.assert_allclose(emu.numpy(), ref, rtol=0, atol=1e-5)
        truth = _float64(_torch(layers), x, acts)
        e_emu = (emu.double() - truth).abs()
        e_plain = (plain.double() - truth).abs()
        assert float(e_emu.max()) <= F64_RATIO * float(e_plain.max())
        assert float(e_emu.mean()) <= F64_RATIO * float(e_plain.mean())


@pytest.mark.parametrize("widths,spatial,act", [
    ([3, 3400, 1], (4, 8, 8), "sine"),
    ([3, 320, 320, 1], (3, 5, 7), "sine"),
    ([2, 400, 2], (9, 11), "relu"),
], ids=["3-3400-1", "3-320-320-1", "2-400-2"])
def test_grid_model_matches_plain_and_pallas(widths, spatial, act):
    """Kernel 2's streamed form forced at small widths, on the coordinates
    it builds from the voxel index (fused_decode.grid_coords): the
    emulation against the plain decode and the Pallas kernel in interpret
    mode."""
    layers = _layers(widths, seed=7)
    acts = _acts(widths, act)
    coords = fd.grid_coords(spatial, "n11")
    emu = fs.chain_tc_model(_torch(layers), coords, acts,
                            plan=cs.stream_plan(widths))
    plain = fd.fused_decode_grid_reference(_torch(layers), spatial, acts,
                                           "n11")
    _close(emu, plain)
    ref = np.asarray(pd.fused_decode_grid(_jax(layers), spatial, acts, "n11",
                                          tile=128, interpret=True))
    np.testing.assert_allclose(emu.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("widths,n", [([3, 20971, 1], 65_536),
                                      ([3, 4000, 1], 4096),
                                      ([3, 4096, 4096, 1], 64 ** 3)])
def test_call_follows_the_sm_count(widths, n, sms):
    """A call sized for a card of `sms` SMs (the wrappers pass the
    device's multi_processor_count): 3-F-1's splits bring a chunk to
    THIN_PER_SM blocks an SM, within the feature blocks; a chunk of
    square products a whole number of waves of product blocks, one an
    SM; the chunks cover the rows."""
    p = cs.stream_plan(widths)
    call = cs.stream_call(p, n, sms)
    assert call["chunks"] * call["R"] >= n > (call["chunks"] - 1) * call["R"]
    if p["thin"]:
        blocks = -(-call["R"] // cs.THIN_ROWS)
        assert call["S"] == min(p["n_fb"],
                                max(1, -(-cs.THIN_PER_SM * sms // blocks)))
    else:
        assert call["chunks"] > 1
        assert call["R"] // 128 * (max(p["wp_cols"]) // 128) % sms == 0


def test_splits_keep_the_sums_close():
    """3-F-1's feature blocks in splits (as many as fill the card at small
    N, one at large N): the split sums stay within the plain version's
    tolerance whatever their count."""
    widths = [3, 4000, 1]
    layers = _torch(_layers(widths, seed=5))
    acts = _acts(widths)
    p = cs.stream_plan(widths)
    x = torch.from_numpy(_rows(96, 3, seed=5))
    assert cs.stream_call(p, 96)["S"] == p["n_fb"]     # every block a split
    emu = cs.stream_model(layers, x, acts, p)
    _close(emu, fs.fused_chain_apply_reference(layers, x, acts))


def test_phi_chain_through_params_from_numpy():
    """A SIREN φ of the JAX package at 3,400 features, its weights carried
    across with params_from_numpy: the streamed form's emulation against
    the JAX package's forward and the plain version."""
    cfg = {"name": "SIREN", "coords_channel": 3, "data_channel": 1,
           "features": 3400, "layers": 2, "w0": 20}
    jmodel = jinit(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = tphi.init_phi(cfg)
    tparams = tphi.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                            jparams))
    widths = fs.chain_widths(tmodel.spec)
    assert widths == [3, 3400, 1] and fs.choose_plan(widths) == \
        fd.choose_plan(widths) == cs.stream_plan(widths)
    acts = chain_layer_specs(tmodel.spec)
    x = _rows(128, 3, seed=11)
    emu = fs.chain_tc_model(tparams["layers"], torch.from_numpy(x), acts,
                            plan=fs.choose_plan(widths))
    _close(emu, fs.fused_chain_apply_reference(tparams["layers"],
                                               torch.from_numpy(x), acts))
    ref = np.asarray(jmodel.apply(jparams, jnp.asarray(x)))
    np.testing.assert_allclose(emu.numpy(), ref, rtol=0, atol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU both wrappers compute the plain version of a chain that
    takes the streamed form on the card (no kernel, no count)."""
    widths = [3, 3400, 1]
    layers = _torch(_layers(widths, seed=2))
    acts = _acts(widths)
    before = (fd.launches, fs.launches, fd.stream_launches,
              fs.stream_launches)
    out = fd.fused_decode_grid(layers, (3, 4, 5), acts, "n11")
    assert torch.equal(out, fd.fused_decode_grid_reference(
        layers, (3, 4, 5), acts, "n11"))
    x = torch.from_numpy(_rows(64, 3, seed=2))
    assert torch.equal(fs.fused_chain_apply(layers, x, acts),
                       fs.fused_chain_apply_reference(layers, x, acts))
    assert (fd.launches, fs.launches, fd.stream_launches,
            fs.stream_launches) == before
