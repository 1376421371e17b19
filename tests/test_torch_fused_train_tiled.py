"""The train kernel's tiled layout (brief_pytorch_tpu_torch/ops/fused_train.py
`tiled_plan`, `dw_map`; csrc/fused_train.cu `fused_train_tiled_kernel`) on
the CPU: which chains get it, its shared-memory layout, its thread -> dW
entry map, and the plain version at the HiP-CT bucket's width (4 blocks of
3-64x6-1, true widths 49/52/58/64) against the JAX package's Pallas kernel
run in interpret mode, block by block.  The kernel itself runs on the card
only (tests/test_torch_cuda_kernels.py).

Tolerances of the JAX comparison: loss rtol 1e-5, gradients rtol 1e-5 /
atol 1e-6 (both sum the batch in float32, in another order).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from brief_pytorch_tpu.ops import pallas_train as pt
from brief_pytorch_tpu_torch.ops import fused_train as ft

HIPCT = [3] + [64] * 6 + [1]           # the HiP-CT DivideTask bucket


@pytest.mark.parametrize("widths,layout", [
    ([3, 22, 22, 22, 22, 1], "narrow"),       # SingleTask default, 80x
    ([3] + [7] * 4 + [1], "narrow"),          # brain64.yaml's blocks
    (HIPCT, "tiled"),
    ([3] + [66] * 6 + [1], "tiled"),
    ([3] + [95] * 4 + [1], "tiled"),          # a SingleTask chain, 5 x 95
    ([3] + [128] * 6 + [1], "wide"),          # a bucket past the tiled one
    ([3] + [186] * 4 + [1], "wide"),          # SingleTask default at 128^3
    ([3, 512, 512, 512, 512, 1], "wide"),     # the SingleTask default, wider
    ([3] + [8] * 16 + [1], "narrow"),         # 17 layers: past the old 16
])
def test_choose_plan_picks_the_layout(widths, layout):
    p = ft.choose_plan(widths)
    assert p["layout"] == layout and p["smem_bytes"] <= ft.SMEM_LIMIT
    if layout == "tiled":   # only where the narrow layout does not fit
        n = ft.narrow_plan(widths)
        assert n is None or ft.resident_warps(n) < ft.NARROW_MIN_WARPS


@pytest.mark.parametrize("widths", [
    HIPCT, [3] + [66] * 6 + [1], [3] + [95] * 4 + [1], [2, 70, 61, 3],
])
def test_tiled_plan_is_disjoint_and_aligned(widths):
    """Weights, the loss buffer and the activation rows do not overlap;
    every weight row and activation block starts on 16 bytes (float4
    reads), the activation rows on 128 bytes (the bank permutation); it
    fits SMEM_LIMIT."""
    p = ft.tiled_plan(widths)
    r4 = lambda x: (x + 3) // 4 * 4
    regions = [(p["w_off"][l], r4(widths[l] + 1) * r4(widths[l + 1]))
               for l in range(len(widths) - 1)]
    regions += [(p["red_off"], ft.TILED_THREADS)]
    regions.sort()
    for (a, n), (b, _) in zip(regions, regions[1:]):
        assert a + n <= b
    assert all(off % 4 == 0 for off, _ in regions)
    assert regions[-1][0] + regions[-1][1] <= p["act_off"]
    assert p["act_off"] % 32 == 0
    # activation rows: coordinates + ones, then h_l + ones and g_l per layer
    spans = [(0, widths[0] + 1)]
    for l in range(len(widths) - 1):
        spans += [(p["h_row"][l], widths[l + 1] + 1),
                  (p["g_row"][l], widths[l + 1])]
    spans.sort()
    for (a, n), (b, _) in zip(spans, spans[1:]):
        assert a + n <= b and b % 4 == 0
    assert p["x_row"] == [0] + p["h_row"][:-1]
    rows = p["g_row"][-1] + r4(widths[-1])
    assert p["smem_bytes"] == 4 * (p["act_off"] + rows * ft.TILED_TILE)
    assert p["smem_bytes"] <= ft.SMEM_LIMIT
    assert p["n_params"] == sum(a * b + b for a, b in
                                zip(widths[:-1], widths[1:]))


@pytest.mark.parametrize("widths", [
    HIPCT, [3] + [66] * 6 + [1], [3] + [95] * 4 + [1], [2, 70, 61, 3],
])
def test_dw_map_covers_every_entry_once(widths):
    """Each (W, b) entry of each layer is summed by exactly one thread
    slot: entry (i, o) of a tile, i <= fin (i == fin: the bias), o < fout,
    at p_off[l] + i * fout + o, as the kernel writes it out."""
    p = ft.tiled_plan(widths)
    table = np.asarray(ft.dw_map(widths, p["slots"]))
    assert table.shape == (p["slots"], ft.TILED_THREADS)
    hits = np.zeros(p["n_params"], np.int64)
    for code in table.ravel():
        if code < 0:
            continue
        l, ig, og = code >> 16, (code >> 8) & 255, code & 255
        fin, fout = widths[l], widths[l + 1]
        assert 4 * ig <= fin and 4 * og < fout
        for a in range(4):
            for b in range(4):
                i, o = 4 * ig + a, 4 * og + b
                if i <= fin and o < fout:
                    hits[p["p_off"][l] + i * fout + o] += 1
    assert (hits == 1).all()
    # the fewest slots of the kernel's instances that hold every tile
    assert p["slots"] == min(
        s for s in ft.TILED_SLOTS
        if len(ft.dw_tiles(widths)) <= s * ft.TILED_THREADS)


def test_dw_map_refuses_too_few_slots():
    with pytest.raises(ValueError, match="exceed"):
        ft.dw_map(HIPCT, 4)


def _hipct_fleet(n, seed=0):
    """4 SIREN chains 3-f x6-1, w0 = 10, true widths 49/52/58/64 padded to
    64 (zeros beyond each block's width), their masks, per-block
    thresholds (finite and -inf) and a batch of n coordinates per block."""
    true = (49, 52, 58, 64)
    rng = np.random.default_rng(seed)
    B, F = len(true), 64
    masks = np.zeros((B, F), np.float32)
    for i, f in enumerate(true):
        masks[i, :f] = 1.0
    layers = []
    for l, (fi, fo) in enumerate(zip(HIPCT[:-1], HIPCT[1:])):
        bound = 1.0 / fi if l == 0 else np.sqrt(6.0 / fi) / 10.0
        w = rng.uniform(-bound, bound, (B, fi, fo)).astype(np.float32)
        b = rng.uniform(-0.3, 0.3, (B, fo)).astype(np.float32)
        if l > 0:
            w *= masks[:, :, None]
        if l < len(HIPCT) - 2:
            w *= masks[:, None, :]
            b *= masks
        layers.append({"w": w, "b": b})
    coords = rng.uniform(-1, 1, (B, 3, n)).astype(np.float32)
    values = rng.uniform(0, 1, (B, 1, n)).astype(np.float32)
    weights = (1 + rng.uniform(0, 1, (B, 1, n))).astype(np.float32)
    thres = np.array([0.4, -np.inf, 0.6, -np.inf], np.float32)
    return layers, masks, coords, values, weights, thres


@pytest.mark.parametrize("loss_name", ["datal2", "datasmoothl1"])
def test_hipct_fleet_matches_pallas_interpret(loss_name):
    """The plain version the tiled kernel is held to, at the HiP-CT
    bucket's width (N = 1,000: no multiple of the 32-coordinate tile),
    against the JAX kernel in interpret mode, block by block, with the
    unit masks and thresholds block_trainer.run_block_segment passes."""
    acts = (("sine", 10.0),) * 6 + (("none", 1.0),)
    layers, masks, coords, values, weights, thres = _hipct_fleet(1000)
    um = [torch.from_numpy(masks)] * 6 + [None]
    tl, tg = ft.fused_train_grads_fleet(
        [{k: torch.from_numpy(v) for k, v in l.items()} for l in layers],
        torch.from_numpy(coords), torch.from_numpy(values),
        torch.from_numpy(weights), acts, loss_name=loss_name, beta=0.05,
        unit_masks=um, thres=torch.from_numpy(thres))
    assert tuple(tl.shape) == (4,)
    for i in range(4):
        jl, jg = pt.fused_train_grads(
            [{k: jnp.asarray(v[i]) for k, v in l.items()} for l in layers],
            jnp.asarray(coords[i]), jnp.asarray(values[i]),
            jnp.asarray(weights[i]), acts, loss_name=loss_name, beta=0.05,
            unit_masks=[jnp.asarray(masks[i])] * 6 + [None],
            dynamic_thres=jnp.asarray(thres[i]), interpret=True, tile=256)
        np.testing.assert_allclose(float(tl[i]), float(jl), rtol=1e-5)
        for l, (a, b) in enumerate(zip(tg["layers"], jg["layers"])):
            for k in ("w", "b"):
                np.testing.assert_allclose(a[k][i].numpy(), np.asarray(b[k]),
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"block {i} d{k}{l}")
            # padded units of this block: exactly zero gradient
            f = int(masks[i].sum())
            if l < 6:
                assert not a["w"][i, :, f:].any() and not a["b"][i, f:].any()
            if l > 0:
                assert not a["w"][i, f:, :].any()

