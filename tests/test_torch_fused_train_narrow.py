"""The train kernel's narrow layout (brief_pytorch_tpu_torch/ops/fused_train.py
`plan`, `narrow_plan`, `tf32_split`, `pack_fragments`; csrc/fused_train.cu
`fused_train_kernel`) on the CPU: its 3xTF32 arithmetic emulated in plain
torch, the B-fragment packing of W and W^T, and its plan.  The kernel
itself runs on the card only (tests/test_torch_cuda_kernels.py).

The emulation runs the kernel's three products as it orders them: per
k-block of 8, c += a_small b_big, c += a_big b_small, c += a_big b_big
(each product of two TF32 values is exact in float32; below three output
n-tiles, and in a small chain's dW, the kernel sums the terms in separate
accumulators, which rounds within the same tolerances); dW over
8-coordinate steps with the big * big term and the cross terms summed
apart.  Tolerances: against the float32 plain version, chip_smoke.py's
compare_grads (loss rel 1e-5, each gradient 1e-4 * max|plain| + 1e-6);
against the JAX kernel in interpret mode, tests/test_torch_fused_train.py's
(loss rtol 1e-5, gradients atol 1e-5 / rtol 1e-4).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from brief_pytorch_tpu.ops import pallas_train as pt
from brief_pytorch_tpu_torch.ops import fused_train as ft

SINGLE = [3, 22, 22, 22, 22, 1]          # SingleTask default, 64^3 at 80x
BRAIN64 = [3, 7, 7, 7, 7, 1]             # brain64.yaml's blocks
PYRAMID = [3, 27, 24, 21, 18, 1]         # SIREN_Pyramid, features_dis 3
ACTS = {"sine": (("sine", 20.0),), "relu": (("relu", 1.0),),
        "sigmoid": (("sigmoid", 1.0),)}


def _chain_acts(widths, act):
    return ACTS[act] * (len(widths) - 2) + (("none", 1.0),)


def _mm3(a, b):
    """a @ b in 3xTF32 over k-blocks of 8, in the kernel's order."""
    c = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], 8):
        ab, as_ = ft.tf32_split(a[:, k:k + 8])
        bb, bs = ft.tf32_split(b[k:k + 8])
        c = c + as_ @ bb
        c = c + ab @ bs
        c = c + ab @ bb
    return c


def _dw3(h, g):
    """h^T g over the coordinates in 8-coordinate steps, the big * big
    term and the two cross terms accumulated apart, then added."""
    acc = torch.zeros(h.shape[1], g.shape[1])
    cor = torch.zeros_like(acc)
    for k in range(0, h.shape[0], 8):
        hb, hs = ft.tf32_split(h[k:k + 8].T.contiguous())
        gb, gs = ft.tf32_split(g[k:k + 8])
        cor = cor + hs @ gb
        cor = cor + hb @ gs
        acc = acc + hb @ gb
    return acc + cor


def emulate(layers, coords, values, weights, acts, *, loss_name,
            beta=0.01, thres=None, masks=None):
    """One chain's (loss, grads) with the narrow kernel's arithmetic:
    coordinate-major, each layer's input with a ones column and W with the
    bias as its last row."""
    n = coords.shape[1]
    x = coords.T
    hs, ds = [], []
    for l, (layer, (act, w0)) in enumerate(zip(layers, acts)):
        h_aug = torch.cat([x, torch.ones(n, 1)], dim=1)
        hs.append(h_aug)
        w_aug = torch.cat([layer["w"], layer["b"][None]], dim=0)
        z = _mm3(h_aug, w_aug)
        x, d = ft._act_fwd(z, act, w0)
        if d is None:
            d = torch.ones_like(z)
        if masks is not None and masks[l] is not None:
            x, d = x * masks[l], d * masks[l]
        ds.append(d)
    pred, y, wv = x, values.T, weights.T
    weff = wv if thres is None else torch.where(pred <= thres, 1.0, wv)
    e = pred - y
    if loss_name == "datal2":
        l_elem, g = e * e, 2.0 * weff * e
    else:
        ae = e.abs()
        l_elem = torch.where(ae < beta, 0.5 * ae * ae / beta, ae - 0.5 * beta)
        g = weff * torch.where(ae < beta, e / beta, torch.sign(e))
    loss = (weff * l_elem).sum()
    g = g * ds[-1]
    m = float(n * values.shape[0])
    grads = [None] * len(layers)
    for l in range(len(layers) - 1, -1, -1):
        dw = _dw3(hs[l], g)
        grads[l] = {"w": dw[:-1] / m, "b": dw[-1] / m}
        if l > 0:
            g = _mm3(g, layers[l]["w"].T.contiguous()) * ds[l - 1]
    return loss / m, grads


def _inputs(widths, n, seed):
    rng = np.random.default_rng(seed)
    layers = []
    for l, (fin, fout) in enumerate(zip(widths[:-1], widths[1:])):
        r = 1.0 / fin if l == 0 else np.sqrt(6.0 / fin) / 20.0
        layers.append({"w": rng.uniform(-r, r, (fin, fout)).astype(np.float32),
                       "b": rng.uniform(-r, r, fout).astype(np.float32)})
    coords = rng.uniform(-1, 1, (widths[0], n)).astype(np.float32)
    values = rng.uniform(0, 1, (widths[-1], n)).astype(np.float32)
    weights = (1 + rng.uniform(0, 1, (widths[-1], n))).astype(np.float32)
    return layers, coords, values, weights


def _close_compare_grads(lk, gk, lp, gp):
    assert abs(float(lk) - float(lp)) <= 1e-5 * abs(float(lp))
    for a, b in zip(gk, gp):
        for key in ("w", "b"):
            d = float((a[key] - b[key]).abs().max())
            assert d <= 1e-4 * float(b[key].abs().max()) + 1e-6, key


# ---- 3xTF32 arithmetic -----------------------------------------------------
def test_tf32_split_rounds_like_cvt_rna():
    """big keeps 10 mantissa bits, rounded to the nearest with ties away
    from zero; big + small holds x to 2^-21 relative; zero splits into
    zeros (padded units keep exactly 0 gradient)."""
    one = 1.0 + 2.0 ** -11          # exactly half a TF32 ulp above 1
    x = torch.tensor([one, -one, 1.0 + 3 * 2.0 ** -12, 0.0, 2.0 ** -130])
    big, small = ft.tf32_split(x)
    assert big[0] == 1.0 + 2.0 ** -10 and big[1] == -(1.0 + 2.0 ** -10)
    assert big[2] == 1.0 + 2.0 ** -10 and big[3] == 0 and small[3] == 0
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32)) * 100
    b, s = ft.tf32_split(r)
    for t in (b, s):
        assert int((t.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((b + s - r).abs() / r.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("widths", [SINGLE, BRAIN64])
@pytest.mark.parametrize("act", ["sine", "relu", "sigmoid"])
@pytest.mark.parametrize("loss_name,thres", [("datal2", 0.6),
                                             ("datasmoothl1", None)])
def test_emulated_3xtf32_matches_plain_and_pallas(widths, act, loss_name,
                                                  thres):
    """The kernel's arithmetic at 5 x 22 and 3-7x4-1 with sine, relu and
    sigmoid hidden layers: within compare_grads' tolerances of the
    float32 plain version, and of the JAX kernel in interpret mode."""
    layers, coords, values, weights = _inputs(widths, 300, seed=len(act))
    acts = _chain_acts(widths, act)
    kw = dict(loss_name=loss_name, beta=0.01, weight_thres=thres)
    tl = [{k: torch.from_numpy(v) for k, v in l.items()} for l in layers]
    tc, tv, tw = map(torch.from_numpy, (coords, values, weights))
    le, ge = emulate(tl, tc, tv, tw, acts, loss_name=loss_name, thres=thres)
    lp, gp = ft.fused_train_grads_reference(tl, tc, tv, tw, acts, **kw)
    _close_compare_grads(le, ge, lp, gp["layers"])
    jl, jg = pt.fused_train_grads(
        [{k: jnp.asarray(v) for k, v in l.items()} for l in layers],
        jnp.asarray(coords), jnp.asarray(values), jnp.asarray(weights), acts,
        tile=256, interpret=True, **kw)
    np.testing.assert_allclose(float(le), float(jl), rtol=1e-5)
    for a, b in zip(ge, jg["layers"]):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       atol=1e-5, rtol=1e-4)


def test_emulated_fleet_block_with_masks():
    """A brain64 block padded from 5 to 7 units: the masked emulation
    matches the plain version's fleet form, and every gradient into a
    padded unit is exactly 0."""
    layers, coords, values, weights = _inputs(BRAIN64, 200, seed=7)
    tl = [{k: torch.from_numpy(v) for k, v in l.items()} for l in layers]
    tc, tv, tw = map(torch.from_numpy, (coords, values, weights))
    mask = torch.tensor([1, 1, 1, 1, 1, 0, 0], dtype=torch.float32)
    masks = [mask] * 4 + [None]
    acts = _chain_acts(BRAIN64, "sine")
    le, ge = emulate(tl, tc, tv, tw, acts, loss_name="datal2", thres=40.0,
                     masks=masks)
    lp, gp = ft.fused_train_grads_reference(
        [{k: v[None] for k, v in l.items()} for l in tl], tc[None], tv[None],
        tw[None], acts, loss_name="datal2", weight_thres=torch.tensor([40.0]),
        unit_masks=[m[None] for m in masks[:-1]] + [None])
    _close_compare_grads(le, ge, lp[0],
                         [{k: v[0] for k, v in g.items()}
                          for g in gp["layers"]])
    for l, g in enumerate(ge):
        if l < 4:
            assert torch.count_nonzero(g["w"][:, 5:]) == 0
            assert torch.count_nonzero(g["b"][5:]) == 0
        if l > 0:
            assert torch.count_nonzero(g["w"][5:, :]) == 0


# ---- fragment packing -----------------------------------------------------
@pytest.mark.parametrize("rows,cols", [(4, 22), (23, 22), (23, 1), (22, 22),
                                       (8, 7), (61, 15), (1, 24)])
def test_fragment_packing_round_trips(rows, cols):
    """pack_fragments lays (K, N) out as the kernel's B fragments: lane
    4g + t of (k, j) holds m[8k + 2t (+1)][8j + g], big then small; it
    unpacks to tf32_split(m), and every entry past m is zero."""
    m = torch.from_numpy(np.random.default_rng(rows * cols).standard_normal(
        (rows, cols)).astype(np.float32))
    kb, nt = -(-rows // 8), -(-cols // 8) + 1     # one padded n-tile more
    frags = ft.pack_fragments(m, kb, nt)
    assert tuple(frags.shape) == (kb, nt, 32, 4)
    big, small = ft.unpack_fragments(frags, rows, cols)
    rb, rs = ft.tf32_split(m)
    assert torch.equal(big, rb) and torch.equal(small, rs)
    for k in range(kb):
        for j in range(nt):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for e in range(2):
                    i, o = 8 * k + 2 * t + e, 8 * j + g
                    inside = i < rows and o < cols
                    want = rb[i, o] if inside else 0.0
                    assert frags[k, j, lane, e] == want
                    if not inside:
                        assert frags[k, j, lane, 2 + e] == 0.0


# ---- the plan -------------------------------------------------------------
@pytest.mark.parametrize("widths", [SINGLE, BRAIN64, PYRAMID,
                                    [3, 60, 15, 15, 15, 1],
                                    [3, 30, 24, 19, 15, 1], [2, 33, 33, 3]])
def test_narrow_plan_is_disjoint_and_aligned(widths):
    """B fragments, the activation store and the loss buffer do not
    overlap, each region starts on 16 bytes; the store's row stride is
    4 or 20 mod 32 floats (fragment accesses hit distinct banks); the dW
    tiles of the jobs dealt to the warps cover every (W; b) entry of
    every layer exactly once."""
    p = ft.narrow_plan(widths)
    assert p is not None and p["smem_bytes"] <= ft.SMEM_LIMIT
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
    assert all(a % 4 == 0 for a, _ in regions)
    assert regions[-1][0] + regions[-1][1] == p["smem_bytes"] // 4
    assert p["stride"] % 32 in (4, 20) and p["stride"] >= p["block"]
    rows = [(p["x_row"][0], widths[0] + 1), (p["yw_row"], 2 * widths[-1])]
    for l in range(L):
        if l < L - 1:
            rows.append((p["h_row"][l], widths[l + 1] + 1))
        rows.append((p["g_row"][l], widths[l + 1]))
    rows.sort()
    for (a, n), (b, _) in zip(rows, rows[1:]):
        assert a + n == b
    assert rows[-1][0] + rows[-1][1] == p["rows"]
    seen = np.zeros(p["n_params"], dtype=int)
    codes = [c for c in p["job_table"] if c >= 0]
    assert sorted(codes) == sorted(l << 24 | mt << 16 | n0 << 8 | cnt
                                   for l, mt, n0, cnt in p["dw_jobs"])
    for code in codes:
        l, mt, n0, cnt = code >> 24, code >> 16 & 255, code >> 8 & 255, \
            code & 255
        fin, fout = widths[l], widths[l + 1]
        for r in range(16 * mt, 16 * mt + 16):
            for q in range(8 * n0, 8 * (n0 + cnt)):
                i, o = (q, r) if p["dw_gmajor"][l] else (r, q)
                if i <= fin and o < fout:
                    seen[p["p_off"][l] + i * fout + o] += 1
    assert (seen == 1).all()
    per_warp = [sum(c >= 0 for c in p["job_table"][4 * w:4 * w + 4])
                for w in range(p["warps"])]
    assert max(per_warp) <= p["jobs"] and sum(per_warp) == len(codes)
    assert all(c < 0 for c in p["job_table"][4 * p["warps"]:])


def test_single_task_chain_holds_16_warps_per_sm():
    """5 x 22: one block of 16 warps per SM (each group of warps with its
    store of 16 coordinates a warp), its weights and stores within a
    block's 227 KB, one dW job per warp."""
    p = ft.choose_plan(SINGLE)
    assert p["layout"] == "narrow" and p["threads"] == 32 * 16
    assert ft.resident_warps(p) >= 16
    assert p["smem_bytes"] + 1024 <= ft.SM_SMEM
    assert len(p["dw_jobs"]) <= p["warps"] and p["jobs"] == 1


@pytest.mark.parametrize("widths,layout", [
    ([3] + [4] * 4 + [1], "narrow"),
    ([3] + [8] * 4 + [1], "narrow"),
    (SINGLE, "narrow"),
    ([3] + [33] * 4 + [1], "narrow"),       # its last 5-layer width
    ([3] + [64] * 4 + [1], "tiled"),        # the old layout's 5-layer edge
    ([3] + [48] * 6 + [1], "tiled"),        # its 7-layer edge
    (PYRAMID, "narrow"),
    (BRAIN64, "narrow"),
])
def test_every_old_narrow_chain_keeps_a_kernel(widths, layout):
    """Every chain the old one-thread-per-coordinate layout took still gets
    a layout: the new narrow one where it keeps NARROW_MIN_WARPS warps per
    SM, else the tiled one (10-12x faster than the old layout at 5 x 64 and
    7 x 48 on the card, PERF.md)."""
    p = ft.choose_plan(widths)
    assert p["layout"] == layout and p["smem_bytes"] <= ft.SMEM_LIMIT
    if layout == "narrow":
        assert ft.resident_warps(p) >= ft.NARROW_MIN_WARPS
    else:
        n = ft.narrow_plan(widths)
        assert n is None or ft.resident_warps(n) < ft.NARROW_MIN_WARPS
