"""The decode kernel's tensor-core design on the CPU
(brief_pytorch_tpu_torch/ops/fused_decode.py `choose_plan`,
`packed_layout`, `pack_weights`, `fast_divisor`, `split_index`;
csrc/fused_decode.cu): its 3xTF32 arithmetic emulated in plain torch, the
pre-split weight packing, the plan at the shapes the main paths decode,
and the 32-bit index split.  The kernel itself runs on the card only
(tests/test_torch_cuda_kernels.py).

The emulation runs the kernel's products as it orders them: the bias
starts each accumulator, then per k-block of 8 inputs s = a_small b_big,
s += a_big b_small, s += a_big b_big from zero and c += s in float32, with
B big and small read back from `pack_weights` (the kernel's packed copy)
and A split by fused_train.tf32_split_nearest; voxels in the plan's tiles
(16 or 32 a warp in the narrow form, 128 a block in the wide one),
coordinates from the kernel's index split.  The CPU model of the
tensor core's sums, fused_siren.chain_tc_model on
fused_decode.grid_coords, is held against a float64 evaluation.
Tolerances: against the float32 plain version, the card tests' 1e-5 *
max|plain| + 1e-5; against the JAX kernel in interpret mode,
tests/test_torch_fused_decode.py's atol 1e-5.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from brief_pytorch_tpu.ops import pallas_decode as pd
from brief_pytorch_tpu_torch.ops import chain_stream as cs
from brief_pytorch_tpu_torch.ops import fused_decode as fd
from brief_pytorch_tpu_torch.ops import fused_train as ft

SINGLE = [3, 22, 22, 22, 22, 1]           # SingleTask default, 64^3 at 80x
HIPCT = [3] + [66] * 6 + [1]              # the widest HiP-CT chunk
DEMO80 = [3, 191, 191, 191, 191, 1]       # SingleTask on a demo volume, 80x
DEMO50 = [3, 242, 242, 242, 242, 1]       # the same at 50x
SIRENFT = [3, 60, 15, 15, 15, 1]          # an uneven chain
SINE = ("sine", 20.0)


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


def _coords(spatial, mode, enc_periods):
    """(pop, c_in) coordinates as the kernel builds them: the index split
    of split_index, the lead axis lo + i * step in float32 (two roundings,
    no fused multiply-add), the plane axes from the wrapper's tables."""
    pop = int(np.prod(spatial))
    lead, idx = fd.split_index(np.arange(pop), spatial)
    lo, step, scale = fd._lead_affine(spatial, mode, enc_periods)
    z0 = np.float32(lo) + lead.astype(np.float32) * np.float32(step)
    z0 = torch.from_numpy(z0.astype(np.float32))
    if enc_periods is not None:
        z0 = fd.fast_sin(torch.tensor(scale) * z0)
    tables = fd._plane_tables(spatial, mode, enc_periods, "cpu")
    off = np.cumsum([0] + list(spatial[1:]))
    cols = [z0] + [tables[int(off[a]) + torch.from_numpy(i)]
                   for a, i in enumerate(idx)]
    return torch.stack(cols, dim=1)


def emulate(layers, spatial, acts, mode="n11", enc_periods=None):
    """The kernel's function with its 3xTF32 arithmetic, tile by tile."""
    widths = [len(spatial)] + [l["w"].shape[1] for l in layers]
    plan = fd.choose_plan(widths)
    lay = fd.packed_layout(widths)
    packed = fd.pack_weights(layers, widths)
    mats = []
    for l, (fin, fout) in enumerate(zip(widths[:-1], widths[1:])):
        kb, nt = lay["kb"][l], lay["nt"][l]
        f0 = 4 * lay["frag_off"][l]
        frags = packed[f0:f0 + 128 * kb * nt].view(kb, nt, 32, 4)
        bb, bs = ft.unpack_fragments(frags, 8 * kb, fout)
        b0 = lay["bias_off"][l]
        mats.append((bb, bs, packed[b0:b0 + fout]))
    x_all = _coords(spatial, mode, enc_periods)
    pop, tile = x_all.shape[0], plan["tile"]
    out = []
    for v0 in range(0, pop, tile):
        h = torch.zeros(tile, 8)
        x = x_all[v0:v0 + tile]
        h[:x.shape[0], :x.shape[1]] = x
        for (bb, bs, bias), (act, w0) in zip(mats, acts):
            c = bias.expand(tile, -1).clone()
            for k in range(0, bb.shape[0], 8):
                ab, as_ = ft.tf32_split_nearest(h[:, k:k + 8].contiguous())
                s = as_ @ bb[k:k + 8]
                s = s + ab @ bs[k:k + 8]
                c = c + (s + ab @ bb[k:k + 8])
            h = fd._act(c, act, w0)
            pad = -h.shape[1] % 8
            h = torch.cat([h, fd._act(torch.zeros(tile, pad), act, w0)], 1)
        out.append(h[:min(tile, pop - v0), :widths[-1]])
    return torch.cat(out)


def _pallas(layers, spatial, acts, mode, enc_periods):
    jl = [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]
    return np.asarray(pd.fused_decode_grid(jl, spatial, acts, mode, tile=128,
                                           interpret=True,
                                           enc_periods=enc_periods))


CASES = [
    # (label, widths, acts of the hidden layers, grid, mode, enc_periods)
    ("single", SINGLE, SINE, (5, 6, 7), "n11", None),
    ("sirenpos", SINGLE, SINE, (5, 4, 6), "n11", (2.0, 3.0, 2.0)),
    ("relu", SINGLE, ("relu", 1.0), (4, 9), "0,1", None),
    ("sigmoid", SINGLE, ("sigmoid", 1.0), (3, 4, 5, 6), "-1,1", None),
    ("uneven", SIRENFT, SINE, (3, 7, 11), "n11", None),
    ("hipct", HIPCT, ("sine", 10.0), (2, 9, 13), "n11", None),
    ("wide", [3, 100, 100, 100, 1], SINE, (3, 5, 17), "n11", None),
    ("wide-191", [3, 191, 191, 1], SINE, (2, 3, 45), "-1,1", None),
]


@pytest.mark.parametrize("label,widths,hidden,spatial,mode,enc", CASES,
                         ids=[c[0] for c in CASES])
def test_emulated_3xtf32_matches_plain_and_pallas(label, widths, hidden,
                                                  spatial, mode, enc):
    widths = [len(spatial)] + widths[1:]
    layers = _layers(widths, seed=len(label))
    acts = (hidden,) * (len(widths) - 2) + (("none", 1.0),)
    emu = emulate(_torch(layers), spatial, acts, mode, enc)
    plain = fd.fused_decode_grid_reference(_torch(layers), spatial, acts,
                                           mode, enc_periods=enc)
    assert emu.shape == plain.shape == (int(np.prod(spatial)), widths[-1])
    assert float((emu - plain).abs().max()) <= \
        1e-5 * float(plain.abs().max()) + 1e-5
    ref = _pallas(layers, spatial, acts, mode, enc)
    np.testing.assert_allclose(emu.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("widths", [SINGLE, HIPCT, SIRENFT, [4, 9, 3],
                                    [2, 8, 16, 5], DEMO80])
def test_packed_weights_round_trip(widths):
    """pack_weights holds each layer's W as B fragments, big + small
    within 2^-21 |w| of it (big and small each rounded to TF32, to
    nearest, as the kernels' split_tf32_nearest does; zeros past W), then
    the biases, zero-padded to 8; the layout tiles the buffer."""
    layers = _torch(_layers(widths, seed=3))
    lay = fd.packed_layout(widths)
    packed = fd.pack_weights(layers, widths)
    assert packed.shape == (lay["packed_floats"],)
    ends = [4 * o for o in lay["frag_off"][1:]] + [lay["bias_off"][0]]
    for l, layer in enumerate(layers):
        fin, fout = layer["w"].shape
        kb, nt = lay["kb"][l], lay["nt"][l]
        f0 = 4 * lay["frag_off"][l]
        assert ends[l] - f0 == 128 * kb * nt
        big, small = ft.unpack_fragments(
            packed[f0:ends[l]].view(kb, nt, 32, 4), 8 * kb, 8 * nt)
        want_b, want_s = ft.tf32_split_nearest(layer["w"])
        assert torch.equal(big[:fin, :fout], want_b)
        assert torch.equal(small[:fin, :fout], want_s)
        assert not big[fin:].any() and not big[:, fout:].any()
        assert not small[fin:].any() and not small[:, fout:].any()
        assert float(((big + small)[:fin, :fout] - layer["w"]).abs().max()) \
            <= 2.0 ** -21 * float(layer["w"].abs().max())
        b0 = lay["bias_off"][l]
        assert torch.equal(packed[b0:b0 + fout], layer["b"])
        assert not packed[b0 + fout:b0 + 8 * nt].any()
    assert lay["bias_off"][-1] + 8 * lay["nt"][-1] == lay["packed_floats"]


@pytest.mark.parametrize("widths,layout,inst,tile,warps", [
    (SINGLE, "narrow", 3, 32, 16),
    (HIPCT, "narrow", 9, 32, 8),
    (DEMO80, "wide", 3, 128, 8),
    (DEMO50, "wide", 4, 128, 8),
])
def test_plan_at_the_main_paths_shapes(widths, layout, inst, tile, warps):
    """The five decode shapes of PERF.md (64^3 and 256^3 share 5 x 22):
    the form, its instance and tile, shared memory within a block's limit,
    and the warps per SM the plan states (>= 16 at 5 x 22, >= 8 at the
    HiP-CT chunk, 4 before)."""
    p = fd.choose_plan(widths)
    assert (p["layout"], p["inst"], p["tile"]) == (layout, inst, tile)
    assert p["smem_bytes"] <= fd.SMEM_LIMIT
    assert p["warps_per_sm"] == warps
    assert not p.get("stream")
    if layout == "narrow":
        # the pre-split weights are what the block holds
        assert p["smem_bytes"] == 4 * p["packed_floats"]
    else:
        # a ring of slabs of one k-block for 8 x kNW n-tiles (as many as
        # fit, 3 at least), and the 128-voxel tile's input rows (every
        # k-block of the widest layer)
        assert 8 * inst >= max(p["nt"]) > 8 * (inst - 1)
        assert 3 <= p["stages"] <= fd.MAX_STAGES
        assert p["smem_bytes"] == fd.BARRIER_BYTES + \
            p["stages"] * 8 * inst * 512 + 4 * 8 * max(p["kb"]) * \
            fd.WIDE_STRIDE


@pytest.mark.parametrize("widths,layout,stream", [
    ([3, 7, 7, 7, 7, 1], "narrow", False),        # brain64's chunks
    ([3] + [88] * 4 + [1], "narrow", False),      # 12 n-tiles of registers
    ([3] + [96] * 4 + [1], "wide", False),        # its weights overflow
    ([3] + [64] * 15 + [1], "wide", False),       # 16 layers of 64
    ([3, 512, 512, 512, 512, 1], "wide", True),   # past 256 features
    ([3, 3327, 1], "wide", True),                 # the widest of old
    ([3] + [8] * 16 + [1], "narrow", False),      # 17 layers
    ([3] + [22] * 19 + [1], "narrow", False),     # 20 layers
    ([3] + [64] * 23 + [1], "wide", False),       # 24 layers of 64
    ([3, 3328, 1], "wide", True),                 # past 3,327 features
    ([3, 20971, 1], "wide", True),                # hipct at 80x, 2 layers
    ([4, 22, 22, 22, 22, 1], "narrow", False),    # 4 axes, as before
    ([5, 22, 22, 22, 22, 1], "wide", False),      # a 5-axis grid
    ([9, 22, 22, 1], "wide", False),              # 9 axes: 2 k-blocks
    ([3] + [256] * 4 + [1], "wide", False),       # the widest in smem
    ([3] + [257] * 4 + [1], "wide", True),        # past 256: streamed
])
def test_plan_reach(widths, layout, stream):
    """Every chain has a form, of any depth and width (the chains the
    kernel took before, and past its old 16 layers and 3,327 features),
    over any number of axes; past 256 features the streamed form
    (ops/chain_stream.py), the only one that keeps activations in a
    device scratch; at most 256, the wide form holds its layer input's
    rows in shared memory, and wide_plan refuses a wider chain."""
    p = fd.choose_plan(widths)
    assert (p["layout"], bool(p.get("stream"))) == (layout, stream)
    assert p["smem_bytes"] <= fd.SMEM_LIMIT
    assert (max(widths) > 256) == stream
    if stream:
        assert p == cs.stream_plan(widths)
        with pytest.raises(ValueError):
            fd.wide_plan(widths)
    elif layout == "wide":
        # the rows of the layer input: 8 x its most k-blocks
        assert 8 * max(p["kb"]) >= max(widths)
        assert p["smem_bytes"] >= 4 * 8 * max(p["kb"]) * fd.WIDE_STRIDE


@pytest.mark.parametrize("d", [1, 2, 3, 7, 64, 100, 255, 256, 257, 511, 512,
                               4097, 65535, 65536, 65537, 262144,
                               (1 << 30) - 1, 1 << 30, (1 << 30) + 1,
                               (1 << 31) - 1])
def test_fast_divisor_is_exact_below_2_31(d):
    """n // d as the kernel computes it (high word of n * mul, shifted),
    for n at both ends of [0, 2^31), around multiples of d, and at
    random."""
    mul, shift = fd.fast_divisor(d)
    assert 0 <= mul < 1 << 32
    rng = np.random.default_rng(d % 1000)
    top = (1 << 31) - 1
    n = np.concatenate([
        np.arange(0, 4096), np.arange(top - 4096, top + 1),
        rng.integers(0, 1 << 31, 100_000),
        np.clip(np.arange(1, 200)[:, None] * d + np.arange(-2, 3)[None],
                0, top).ravel(),
        (top // d) * d + np.arange(-3, 1)])
    n = n[(n >= 0) & (n <= top)]
    np.testing.assert_array_equal(fd.fast_div(n, mul, shift), n // d)


@pytest.mark.parametrize("spatial", [(64, 64, 64), (64, 512, 512),
                                     (64, 256, 256), (37, 41), (3, 4, 5, 6),
                                     (1, 6, 7), (2047, 1023, 1025),
                                     (3, 715827882), (13, 11, 15015533)])
def test_split_index_matches_the_64bit_split(spatial):
    """The kernel's 32-bit split gives the axis indices the 64-bit / and %
    gave, on the first and last voxels (ragged tails), around every lead
    row, and at random; grids of up to 2^31 - 1 voxels."""
    pop = int(np.prod(spatial))
    assert pop < 1 << 31
    plane = pop // spatial[0]
    rng = np.random.default_rng(pop % 997)
    v = np.concatenate([np.arange(min(pop, 5000)),
                        np.arange(max(0, pop - 5000), pop),
                        rng.integers(0, pop, 50_000),
                        np.clip(np.arange(spatial[0])[:, None] * plane
                                + np.arange(-1, 2)[None], 0, pop - 1).ravel()])
    lead, idx = fd.split_index(v, spatial)
    np.testing.assert_array_equal(lead, v // plane)
    p = v - (v // plane) * plane
    for a in range(len(spatial) - 2, -1, -1):
        np.testing.assert_array_equal(idx[a], p % spatial[a + 1])
        p = p // spatial[a + 1]


F64_RATIO = 2.0    # chip_smoke.py's: float32's accuracy, max and mean


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulations are many small float32 and float64 ops: one intra-op
    thread, so that they do not contend with the other test processes'
    threads (tests/test_torch_fused_siren_tc.py does the same)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _float64(layers, coords, acts):
    """The chain with each layer's products and sums in float64, its
    pre-activation rounded once to float32 (chip_smoke.float64_chain)."""
    h = coords.double()
    for layer, (act, w0) in zip(layers, acts):
        z = (h @ layer["w"].double() + layer["b"].double()).float()
        h = fd._act(z, act, w0).double()
    return h


@pytest.mark.parametrize("label,widths,w0,spatial", [
    ("single", SINGLE, 20.0, (16, 16, 16)),
    ("hipct", HIPCT, 10.0, (4, 32, 32)),
    ("wide-191", [3, 191, 191, 1], 20.0, (2, 32, 40)),
])
def test_model_of_the_sums_keeps_float32_accuracy(label, widths, w0,
                                                  spatial):
    """Kernel 2's arithmetic on the CPU (fused_siren.chain_tc_model, the
    tensor core's mma.sync sums bit for bit, on the coordinates the
    kernel builds, fused_decode.grid_coords): each k-block's three
    products summed from zero and added in float32 keep it within
    F64_RATIO x the plain version's distance from a float64 evaluation,
    max and mean; the tensor core's own truncating sums, which kernel 2
    took before, do not (mean)."""
    from brief_pytorch_tpu_torch.ops import fused_siren as fs
    layers = _torch(_layers(widths, seed=len(label), w0=w0))
    acts = (("sine", w0),) * (len(widths) - 2) + (("none", 1.0),)
    coords = fd.grid_coords(spatial, "n11")
    assert torch.equal(coords, _coords(spatial, "n11", None))
    truth = _float64(layers, coords, acts)

    def dist(out):
        d = (out.double() - truth).abs()
        return float(d.max()), float(d.mean())

    plain = dist(fd.fused_decode_grid_reference(layers, spatial, acts, "n11"))
    near = dist(fs.chain_tc_model(layers, coords, acts))
    trunc = dist(fs.chain_tc_model(layers, coords, acts, nearest=False))
    assert near[0] <= F64_RATIO * plain[0]
    assert near[1] <= F64_RATIO * plain[1]
    assert trunc[1] > F64_RATIO * plain[1]
