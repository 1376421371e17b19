"""The train kernel's tiled layout (brief_pytorch_tpu_torch/ops/fused_train.py
`tiled_plan`, `tiled_jobs`, `dw_map`, `dw_codes`, `swizzle`,
`tiled_emulation`; csrc/fused_train.cu `fused_train_tiled_kernel`) on the
CPU: which chains get it, its shared-memory layout, its dW jobs, a
simulation of the kernel's every shared-memory access and mma fragment
(`_Kernel`, float64, no TF32: it checks the addresses and the fragment
layouts, and that each warp access hits 32 distinct banks), its 3xTF32
arithmetic (`tiled_emulation`) and the plain version, both against the
JAX package's Pallas kernel run in interpret mode, block by block.  The
kernel itself runs on the card only (tests/test_torch_cuda_kernels.py).

Tolerances: the simulation against the plain version in float64, 1e-9
relative (the same sums in another order); the emulation against the
float32 plain version, chip_smoke.py's compare_grads (loss rel 1e-5, each
gradient 1e-4 * max|plain| + 1e-6); the plain version and the emulation
against the JAX kernel in interpret mode, loss rtol 1e-5, gradients rtol
1e-5 / atol 1e-6 (plain) and rtol 1e-4 / atol 1e-5 (the emulation's
3xTF32 products, as tests/test_torch_fused_train_narrow.py).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from brief_pytorch_tpu.ops import pallas_train as pt
from brief_pytorch_tpu_torch.ops import fused_train as ft

HIPCT = [3] + [64] * 6 + [1]           # the HiP-CT bucket of PR 5's run
HIPCT66 = [3] + [66] * 6 + [1]         # hipct.yaml's bucket, 51/54/60/66
SMALL = [3, 20, 17, 13, 1]             # a few layers, narrow widths


def _r8(x):
    return (x + 7) // 8 * 8


@pytest.mark.parametrize("widths,layout", [
    ([3, 22, 22, 22, 22, 1], "narrow"),       # SingleTask default, 80x
    ([3] + [7] * 4 + [1], "narrow"),          # brain64.yaml's blocks
    (HIPCT, "tiled"),
    (HIPCT66, "tiled"),
    ([3] + [58] * 6 + [1], "tiled"),          # vessel.yaml's bucket
    ([3] + [28] * 6 + [1], "tiled"),          # neuron.yaml's bucket
    ([2] + [47] * 4 + [1], "tiled"),          # the PNG's 2-D fleet
    ([2] + [92] * 4 + [1], "tiled"),          # the 2048^2 PNG, SingleTask
    ([3] + [9] * 19 + [1], "tiled"),          # layers 20 on the fixture
    ([3] + [95] * 4 + [1], "tiled"),          # a SingleTask chain, 5 x 95
    ([3] + [96] * 4 + [1], "tiled"),          # 12 dW jobs a warp: kJ 13
    ([2, 169, 169, 1], "tiled"),              # 13 dW jobs a warp
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
        assert p["jobs"] in ft.TILED_JOBS and p["mt"] in ft.TILED_MT


@pytest.mark.parametrize("widths,mt", [
    (HIPCT, 2), (HIPCT66, 2), ([3] + [58] * 6 + [1], 2),
    ([3] + [28] * 6 + [1], 4), ([3] + [95] * 4 + [1], 2), ([2, 70, 61, 3], 8),
    ([3] + [9] * 19 + [1], 4), ([3, 12, 12, 1], 8),
])
def test_tiled_plan_is_disjoint_and_aligned(widths, mt):
    """W, the store, the masks, the layer table, the chain's widths, the dW
    codes and the loss buffer do not overlap; each layer's W holds its
    fin + 1 rows (the bias first) at a stride of 4 mod 8
    (>= fout), and every float a product reads lies in the W area; the
    store's regions (two input buffers, h with its ones row and d / g per
    layer) are disjoint and start on multiples of 8 rows, and every row a
    dW job reads (all TILED_JOB of its tiles) lies in the store; the plan
    takes the largest m-tile count that fits and fits SMEM_LIMIT."""
    p = ft.tiled_plan(widths)
    assert p["mt"] == mt and p["block"] == 16 * mt
    assert p["smem_bytes"] <= ft.SMEM_LIMIT
    bigger = [m for m in ft.TILED_MT if m > mt]
    assert all(ft.tiled_plan(widths, m)["smem_bytes"] > ft.SMEM_LIMIT
               for m in bigger)
    L = len(widths) - 1
    ws = []
    for l, (fin, fout) in enumerate(zip(widths[:-1], widths[1:])):
        s = p["w_stride"][l]
        assert s >= fout and s % 8 == 4
        ws.append((p["w_off"][l], (fin + 1) * s))
        # the forward's rows < round8(fin + 1), the input gradient's rows
        # 1 .. round8(fin), columns < round8(fout)
        last = p["w_off"][l] + max(_r8(fin + 1) - 1, _r8(fin)) * s + \
            _r8(fout)
        assert last <= p["w_floats"]
    for (a, n), (b, _) in zip(ws, ws[1:]):
        assert a + n == b
    assert ws[-1][0] + ws[-1][1] <= p["w_floats"] and p["w_floats"] % 32 == 0
    regions = [(0, p["buf_rows"]), (p["buf_rows"], p["buf_rows"])]
    assert p["yw_row"] >= widths[0] + 1 and p["yw_row"] % 8 == 0
    assert p["yw_row"] + 2 * widths[-1] <= p["buf_rows"]
    for l in range(L):
        if l < L - 1:
            regions.append((p["h_row"][l], _r8(widths[l + 1] + 1)))
            assert p["x_row"][l + 1] == p["h_row"][l]
        regions.append((p["g_row"][l], _r8(widths[l + 1])))
    for (a, n), (b, _) in zip(regions, regions[1:]):
        assert a + n == b and a % 8 == 0 and b % 8 == 0
    end = regions[-1][0] + regions[-1][1]
    assert end <= p["store_rows"] <= end + 16
    for l, gm, m, n0, cnt in p["dw_jobs"]:
        ra, rb = (p["g_row"][l], p["x_row"][l]) if gm else \
            (p["x_row"][l], p["g_row"][l])
        assert ra + 16 * m + 16 <= p["store_rows"]
        assert rb + 8 * (n0 + ft.TILED_JOB) <= p["store_rows"]
    T = p["block"]
    assert p["mask_sm"] == p["w_floats"] + p["store_rows"] * T
    assert p["tab_sm"] >= p["mask_sm"] + sum(widths[1:])
    assert p["tab_sm"] % 4 == 0     # 16-byte table rows
    assert p["width_sm"] == p["tab_sm"] + L * ft.TILED_ROW_WORDS
    assert p["desc_sm"] >= p["width_sm"] + L
    assert p["red_off"] >= p["desc_sm"] + ft.TILED_WARPS * p["jobs"]
    assert p["smem_bytes"] == 4 * (p["red_off"] + ft.TILED_WARPS)
    assert p["n_params"] == sum(a * b + b for a, b in
                                zip(widths[:-1], widths[1:]))


@pytest.mark.parametrize("widths", [
    HIPCT, HIPCT66, [3] + [95] * 4 + [1], [2, 70, 61, 3], SMALL,
    [3] + [9] * 19 + [1], [3] + [96] * 4 + [1],
])
def test_dw_map_covers_every_entry_once(widths):
    """Each (W, b) entry of each layer is summed by exactly one tile of one
    job of one warp: entry (i, o) of a tile, i <= fin (i == fin: the
    bias), o < fout, at p_off[l] + i * fout + o, as the kernel writes it
    out; each warp holds a contiguous run of at most `jobs` (the
    instance) jobs, and the codes the kernel reads say the same (a slot
    without a job reads rows 0 and is never written)."""
    p = ft.tiled_plan(widths)
    runs = ft.dw_map(p)
    assert len(runs) == ft.TILED_WARPS
    assert [j for r in runs for j in r] == p["dw_jobs"]
    assert max(len(r) for r in runs) == p["per_warp"] <= p["jobs"]
    codes = np.asarray(ft.dw_codes(p)).reshape(ft.TILED_WARPS, p["jobs"], 2)
    hits = np.zeros(p["n_params"], np.int64)
    for w, run in enumerate(runs):
        for s in range(p["jobs"]):
            a, b = codes[w, s]
            if s >= len(run):
                assert a == 0 and b == -1
                continue
            l, gm, m, n0, cnt = run[s]
            assert (b >> 20, (b >> 19) & 1, (b >> 12) & 127, (b >> 4) & 255,
                    b & 15) == (l, gm, m, n0, cnt)
            assert 1 <= cnt <= ft.TILED_JOB
            fin, fout = widths[l], widths[l + 1]
            for r in range(16):
                for q in range(8 * cnt):
                    i, o = (8 * n0 + q, 16 * m + r) if gm else \
                        (16 * m + r, 8 * n0 + q)
                    if i <= fin and o < fout:
                        hits[p["p_off"][l] + i * fout + o] += 1
    assert (hits == 1).all()


def test_swizzle_is_a_permutation_of_each_row():
    """Within a row of 32 coordinates the swizzle permutes them; pi(r & 7)
    takes every multiple of 4 below 32 once over 8 rows."""
    for r in range(16):
        assert sorted(ft.swizzle(r, u) for u in range(32)) == list(range(32))
    assert sorted(ft.swizzle(r, 0) for r in range(8)) == list(range(0, 32, 4))


def test_too_many_dw_jobs_take_the_wide_layout():
    """A bucket whose dW jobs exceed TILED_JOBS' largest instance for 8
    warps gets no tiled instance (jobs 0), and choose_plan gives it the
    wide layout; a chain within it gets the least instance that holds its
    run."""
    big = [3] + [128] * 6 + [1]
    p = ft.tiled_plan(big)
    assert p["per_warp"] > max(ft.TILED_JOBS) and p["jobs"] == 0
    assert ft.choose_plan(big)["layout"] == "wide"
    p = ft.tiled_plan(HIPCT66)
    assert len(p["dw_jobs"]) == 81 and p["per_warp"] == 11
    assert p["jobs"] == 11


# ---- a simulation of the kernel's accesses, in float64 -------------------
LANE = np.arange(32)
G, TQ = LANE >> 2, LANE & 3


def _mma(a, b):
    """C of mma.sync.m16n8k8 from the lanes' A (32, 4) and B (32, 2)
    fragments (csrc/tf32.cuh's layouts), as the lanes' C (32, 4)."""
    A = np.zeros((16, 8))
    A[G, TQ], A[G + 8, TQ], A[G, TQ + 4], A[G + 8, TQ + 4] = a.T
    B = np.zeros((8, 8))
    B[TQ, G], B[TQ + 4, G] = b.T
    C = A @ B
    return np.stack([C[G, 2 * TQ], C[G, 2 * TQ + 1], C[G + 8, 2 * TQ],
                     C[G + 8, 2 * TQ + 1]], 1)


class _Kernel:
    """fused_train_tiled_kernel for one chain of a fleet, step by step as
    csrc/fused_train.cu writes it, on a float64 shared memory: every warp
    access goes through `ld` / `st` (32 addresses), which record whether
    it hit 32 distinct banks."""

    def __init__(self, p, widths, acts, params, masks, mask_off, eff):
        self.p, self.widths, self.acts = p, widths, acts
        self.mask_off, self.eff = mask_off, eff
        self.T = p["block"]
        self.sm = np.zeros(p["red_off"] + ft.TILED_WARPS)
        self.conflicts = []
        self.st_ = p["w_floats"]
        for l, (fin, fout) in enumerate(zip(widths[:-1], widths[1:])):
            src = params[p["p_off"][l]:p["p_off"][l] + (fin + 1) * fout]
            for i in range(fin + 1):      # the bias (i == fin) as row 0
                o0 = p["w_off"][l] + (i + 1 if i < fin else 0) * \
                    p["w_stride"][l]
                self.sm[o0:o0 + fout] = src[i * fout:(i + 1) * fout]
            rows = [p["x_row"][l]]
            if l == 0:
                rows.append(p["buf_rows"])
            for r in rows:
                for u in range(self.T):
                    self.sm[self.at(r, u)] = 1.0
        if masks is not None:
            self.sm[p["mask_sm"]:p["mask_sm"] + len(masks)] = masks

    def at(self, r, u):
        return self.st_ + r * self.T + ft.swizzle(r, u)

    def _bank(self, addr):
        if len(set((np.asarray(addr) % 32).tolist())) != 32:
            self.conflicts.append(np.asarray(addr).copy())

    def ld(self, addr):
        self._bank(addr)
        return self.sm[addr]

    def st(self, addr, v):
        self._bank(addr)
        self.sm[addr] = v

    def product(self, paired, ar, u, w_off, ws, kb_n, n_tile):
        """tiled_product for one n-tile: the lanes' C (32, 4)."""
        r0, r1 = (2 * TQ, 2 * TQ + 1) if paired else (TQ, TQ + 4)
        c = np.zeros((32, 4))
        for kb in range(kb_n):
            rows0, rows1 = ar + 8 * kb + r0, ar + 8 * kb + r1
            a = np.stack([self.ld(self.at(rows0, u)),
                          self.ld(self.at(rows0, u + 8)),
                          self.ld(self.at(rows1, u)),
                          self.ld(self.at(rows1, u + 8))], 1)
            if paired:
                w = w_off + (8 * kb + 2 * TQ) * ws + 8 * n_tile + G
                b = np.stack([self.ld(w), self.ld(w + ws)], 1)
            else:                     # W^T from W's row 1
                w = w_off + (8 * n_tile + G + 1) * ws + 8 * kb + TQ
                b = np.stack([self.ld(w), self.ld(w + 4)], 1)
            c += _mma(a, b)
        return c

    def run(self, coords, values, weights, n, loss_name, beta, thr,
            tiles):
        """The block's tiles `tiles` in order; returns its partial row (the
        gradients, then the loss)."""
        p, T, L, wd = self.p, self.T, len(self.widths) - 1, self.widths
        MT, c_in, c_out = p["mt"], wd[0], wd[-1]
        gsize = ft.TILED_WARPS // MT
        runs = ft.dw_map(p)
        acc = np.zeros((ft.TILED_WARPS, p["jobs"], ft.TILED_JOB, 32, 4))
        loss_acc = 0.0
        for k, tile in enumerate(tiles):
            par = k & 1
            pr = par * p["buf_rows"]
            base = tile * T
            idx = base + np.arange(T)
            ok = idx < n
            for ch in range(c_in + 2 * c_out):
                src = coords[ch] if ch < c_in else \
                    values[ch - c_in] if ch < c_in + c_out else \
                    weights[ch - c_in - c_out]
                r = pr + (1 + ch if ch < c_in else p["yw_row"] + ch - c_in)
                self.sm[self.at(r, np.arange(T))] = np.where(
                    ok, src[np.minimum(idx, n - 1)], 0.0)
            # each group alone through the forward and the input gradients
            for grp in range(MT):
                u = 16 * grp + G
                fin_e = c_in
                for l in range(L):
                    fin, fout = wd[l], wd[l + 1]
                    fout_e = self.eff[l]
                    act, w0 = self.acts[l]
                    xr = p["x_row"][l] + (pr if l == 0 else 0)
                    mo = self.mask_off[l]
                    kb_n, nt_n = (fin_e + 8) >> 3, (fout_e + 7) >> 3
                    fin_e = fout_e
                    for warp in range(grp, ft.TILED_WARPS, MT):
                        for nt in range(warp // MT, nt_n, gsize):
                            c = self.product(True, xr, u, p["w_off"][l],
                                             p["w_stride"][l], kb_n, nt)
                            for e in range(4):
                                o = 8 * nt + 2 * TQ + (e & 1)
                                uu = u + 8 * (e >> 1)
                                z = torch.from_numpy(c[:, e])
                                h, dv = ft._act_fwd(z, act, w0)
                                h = h.numpy()
                                dv = np.ones(32) if dv is None else dv.numpy()
                                keep = o < (fout if l < L - 1 else c_out)
                                m = np.ones(32)
                                if mo >= 0:
                                    m = np.where(keep, self.sm[
                                        p["mask_sm"] + mo +
                                        np.minimum(o, fout - 1)], 1.0)
                                h, dv = h * m, dv * m
                                oo = np.minimum(o, fout - 1)
                                if l < L - 1:
                                    self._masked_st(self.at(
                                        p["h_row"][l] + 1 + oo, uu), h, keep)
                                    self._masked_st(self.at(p["g_row"][l] + oo,
                                                            uu), dv, keep)
                                    continue
                                yr = pr + p["yw_row"] + oo
                                y = self.sm[self.at(yr, uu)]
                                wv = self.sm[self.at(yr + c_out, uu)]
                                weff = np.where(h <= thr, 1.0, wv)
                                weff = np.where(base + uu < n, weff, 0.0)
                                er = h - y
                                if loss_name == "datal2":
                                    le, gg = er * er, 2 * weff * er
                                else:
                                    ae = np.abs(er)
                                    le = np.where(ae < beta, 0.5 * ae * ae /
                                                  beta, ae - 0.5 * beta)
                                    gg = weff * np.where(ae < beta, er / beta,
                                                         np.sign(er))
                                loss_acc += float((weff * le)[keep].sum())
                                self._masked_st(self.at(p["g_row"][l] + oo,
                                                        uu), gg * dv, keep)
                for l in range(L - 1, 0, -1):
                    fin, fout = wd[l], wd[l + 1]
                    dr = p["g_row"][l - 1]
                    kb_n = (self.eff[l] + 7) >> 3
                    nt_n = (self.eff[l - 1] + 7) >> 3
                    for warp in range(grp, ft.TILED_WARPS, MT):
                        for nt in range(warp // MT, nt_n, gsize):
                            c = self.product(False, p["g_row"][l], u,
                                             p["w_off"][l], p["w_stride"][l],
                                             kb_n, nt)
                            for e in range(4):
                                i = 8 * nt + 2 * TQ + (e & 1)
                                keep = i < fin
                                a = self.at(dr + np.minimum(i, fin - 1),
                                            u + 8 * (e >> 1))
                                self._masked_st(a, c[:, e] * self.sm[a],
                                                keep)
            # dW, every warp over the tile's coordinates
            codes = np.asarray(ft.dw_codes(p)).reshape(ft.TILED_WARPS,
                                                       p["jobs"], 2)
            for warp in range(ft.TILED_WARPS):
                for kb in range(2 * MT):
                    for s in range(p["jobs"]):
                        code = int(codes[warp, s, 0])
                        ra = (code & 0x1fff) + (pr if code >> 26 & 1 else 0)
                        rb = (code >> 13 & 0x1fff) + \
                            (pr if code >> 27 & 1 else 0)
                        ua, ub = 8 * kb + TQ, 8 * kb + TQ + 4
                        a = np.stack([self.ld(self.at(ra + G, ua)),
                                      self.ld(self.at(ra + G + 8, ua)),
                                      self.ld(self.at(ra + G, ub)),
                                      self.ld(self.at(ra + G + 8, ub))], 1)
                        for j in range(ft.TILED_JOB):
                            r = rb + 8 * j + G
                            b = np.stack([self.ld(self.at(r, ua)),
                                          self.ld(self.at(r, ub))], 1)
                            acc[warp, s, j] += _mma(a, b)
        out = np.zeros(p["n_params"] + 1)
        for warp, run in enumerate(runs):
            for s, (l, gm, m, n0, cnt) in enumerate(run):
                fin, fout = wd[l], wd[l + 1]
                for j in range(cnt):
                    for e in range(4):
                        r = 16 * m + G + 8 * (e >> 1)
                        q = 8 * (n0 + j) + 2 * TQ + (e & 1)
                        k, o = (q, r) if gm else (r, q)
                        i = np.where(k == 0, fin, k - 1)   # row 0: the bias
                        keep = (k <= fin) & (o < fout)
                        out[p["p_off"][l] + (i * fout + o)[keep]] = \
                            acc[warp, s, j][keep, e]
        out[-1] = loss_acc
        return out

    def _masked_st(self, addr, v, keep):
        """A store predicated by `keep`: the active lanes' banks distinct."""
        if len(set((addr[keep] % 32).tolist())) != int(keep.sum()):
            self.conflicts.append(addr.copy())
        self.sm[addr[keep]] = v[keep]


def _fleet(widths, true, n, seed, acts_kind="sine"):
    """B chains of `widths` (padded), true hidden widths `true`, their
    masks, thresholds (finite and -inf), a batch of n per chain."""
    rng = np.random.default_rng(seed)
    B, L = len(true), len(widths) - 1
    F = widths[1]
    masks = np.zeros((B, F), np.float32)
    for i, f in enumerate(true):
        masks[i, :f] = 1.0
    w0 = 10.0
    layers = []
    for l, (fi, fo) in enumerate(zip(widths[:-1], widths[1:])):
        bound = 1.0 / fi if l == 0 else np.sqrt(6.0 / fi) / w0
        w = rng.uniform(-bound, bound, (B, fi, fo)).astype(np.float32)
        b = rng.uniform(-0.3, 0.3, (B, fo)).astype(np.float32)
        if l > 0:
            w *= masks[:, :fi, None]
        if l < L - 1:
            w *= masks[:, None, :fo]
            b *= masks[:, :fo]
        layers.append({"w": w, "b": b})
    cin, cout = widths[0], widths[-1]
    coords = rng.uniform(-1, 1, (B, cin, n)).astype(np.float32)
    values = rng.uniform(0, 1, (B, cout, n)).astype(np.float32)
    weights = (1 + rng.uniform(0, 1, (B, cout, n))).astype(np.float32)
    thres = np.array([(0.4, -np.inf, 0.6, -np.inf)[i % 4] for i in range(B)],
                     np.float32)
    if acts_kind == "sine":
        acts = (("sine", w0),) * (L - 1) + (("none", 1.0),)
    else:
        acts = tuple((("relu", 1.0), ("sigmoid", 1.0))[l % 2]
                     for l in range(L - 1)) + (("none", 1.0),)
    return layers, masks, coords, values, weights, thres, acts


def _torch_fleet(layers, coords, values, weights, thres, masks, L,
                 dtype=torch.float32):
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dtype)
    return ([{k: t(v) for k, v in l.items()} for l in layers], t(coords),
            t(values), t(weights), torch.from_numpy(thres).to(dtype),
            [t(masks)] * (L - 1) + [None])


@pytest.mark.parametrize("widths,true,n,blocks,loss_name,acts_kind", [
    (SMALL, None, 150, 2, "datal2", "sine"),
    ([3, 20, 20, 20, 1], (17, 20), 111, 3, "datasmoothl1", "sine"),
    ([2, 12, 12, 3], (9, 12), 200, 2, "datasmoothl1", "relu"),
    ([3] + [9] * 7 + [1], (9,), 70, 1, "datal2", "sine"),
    (HIPCT66, (66,), 40, 1, "datal2", "sine"),
    ([3] + [66] * 3 + [1], (51, 60), 45, 2, "datasmoothl1", "sine"),
])
def test_kernel_simulation_matches_plain(widths, true, n, blocks, loss_name,
                                         acts_kind):
    """The kernel's addresses, fragments, regions, input buffers and dW
    codes, in float64 (`_Kernel`, tiles dealt to `blocks` blocks as the
    grid deals them), against the plain version in float64, 1e-9
    relative; a ragged tail (n no multiple of the tile), masked units of
    a padded fleet block and both thresholds; every warp access of
    shared memory hits 32 distinct banks."""
    L = len(widths) - 1
    true = true or (widths[1],)
    layers, masks, coords, values, weights, thres, acts = _fleet(
        widths, true, n, seed=n, acts_kind=acts_kind)
    if len(set(widths[1:-1])) > 1:       # uneven widths: no masks
        masks = None
    p = ft.tiled_plan(widths)
    tl, tc, tv, tw, tt, tm = _torch_fleet(
        layers, coords, values, weights, thres,
        masks if masks is not None else np.ones((len(true), widths[1])), L,
        torch.float64)
    if masks is None:
        tm = None
    lp, gp = ft.fused_train_grads_reference(
        tl, tc, tv, tw, acts, loss_name=loss_name, beta=0.05,
        weight_thres=tt, unit_masks=tm)
    T = p["block"]
    n_tiles = -(-n // T)
    mask_off, off = [], 0
    for l in range(L):
        mask_off.append(off if (masks is not None and l < L - 1) else -1)
        off += widths[l + 1] if mask_off[-1] >= 0 else 0
    for i in range(len(true)):
        params = np.concatenate([np.concatenate([l["w"][i].ravel(),
                                                 l["b"][i]])
                                 for l in layers]).astype(np.float64)
        mrow = None if masks is None else np.concatenate([masks[i]] *
                                                         (L - 1))
        eff = ft.tiled_widths(widths, None if masks is None else
                              [masks[i]] * (L - 1) + [None])
        if masks is not None and L > 1:
            assert eff[:-1] == [true[i]] * (L - 1)
        total = np.zeros(p["n_params"] + 1)
        for b in range(blocks):
            k = _Kernel(p, widths, acts, params, mrow, mask_off, eff)
            total += k.run(coords[i].astype(np.float64),
                           values[i].astype(np.float64),
                           weights[i].astype(np.float64), n, loss_name, 0.05,
                           float(thres[i]), list(range(b, n_tiles, blocks)))
            assert not k.conflicts, f"{len(k.conflicts)} conflicted accesses"
        total /= n * widths[-1]
        assert abs(total[-1] - float(lp[i])) <= 1e-9 * abs(float(lp[i]))
        o = 0
        for l, (fin, fout) in enumerate(zip(widths[:-1], widths[1:])):
            got_w = total[o:o + fin * fout].reshape(fin, fout)
            got_b = total[o + fin * fout:o + (fin + 1) * fout]
            o += (fin + 1) * fout
            for got, want in ((got_w, gp["layers"][l]["w"][i]),
                              (got_b, gp["layers"][l]["b"][i])):
                want = want.numpy()
                scale = np.abs(want).max() + 1e-300
                assert np.abs(got - want).max() <= 1e-9 * scale, (l, i)


@pytest.mark.parametrize("true,blocks,n_tiles", [
    ((51, 54, 60, 66), 132, 3125),     # the HiP-CT fleet on an H100
    ((58, 58, 58, 58), 132, 3125),     # vessel: equal chains, equal shares
    ((66,), 132, 3125),                # one chain: the whole grid
    ((51, 66), 132, 40),               # few tiles: at most n_tiles a chain
    (tuple(range(20, 84)), 132, 10),   # 64 chains: at least one each
])
def test_tiled_shares_divide_the_grid_by_work(true, blocks, n_tiles):
    """tiled_shares (csrc/fused_train.cu tiled_share_kernel's twin): each
    chain at least 1 and at most n_tiles blocks, runs back to back in
    chain order, all the grid used unless every chain is full, and the
    blocks in proportion to tiled_work within one block (a chain with
    more work a block could take one from one with less); the widths are
    the masks' (tiled_widths), the products' k-blocks and n-tiles stop
    there."""
    L = 7
    masks = [np.concatenate([np.ones(f), np.zeros(max(true) - f)])
             for f in true]
    widths = [3] + [max(true)] * (L - 1) + [1]
    work = []
    for m in masks:
        eff = ft.tiled_widths(widths, [m] * (L - 1) + [None])
        assert eff == [int(m.sum())] * (L - 1) + [1]
        work.append(ft.tiled_work(3, eff, 11))
    spans = ft.tiled_shares(work, blocks, n_tiles)
    first = 0
    for (f, k) in spans:
        assert f == first and 1 <= k <= n_tiles
        first += k
    assert first == min(blocks, n_tiles * len(true)) or \
        first == max(blocks, len(true))
    for a, (_, ka) in zip(work, spans):
        for b, (_, kb) in zip(work, spans):
            if ka > 1 and kb < n_tiles:      # no move would even them out
                assert a * (kb + 1) >= b * (ka - 1) or a / (ka - 1) >= b / kb
    if len(set(true)) == 1:
        assert len({k for _, k in spans}) <= 2


# ---- the 3xTF32 arithmetic ------------------------------------------------
def _close_compare_grads(lk, gk, lp, gp):
    assert bool(((lk - lp).abs() <= 1e-5 * lp.abs()).all())
    for a, b in zip(gk, gp):
        for key in ("w", "b"):
            d = float((a[key] - b[key]).abs().max())
            assert d <= 1e-4 * float(b[key].abs().max()) + 1e-6, key


@pytest.mark.parametrize("widths,true,n,acts_kind", [
    (HIPCT66, (51, 54, 60, 66), 700, "sine"),
    ([3] + [58] * 6 + [1], (58, 58, 58, 58), 300, "sine"),
    (SMALL, None, 300, "sine"),
    ([3, 24, 24, 24, 1], (17, 24), 257, "relu"),
])
@pytest.mark.parametrize("loss_name", ["datal2", "datasmoothl1"])
def test_tiled_emulation_matches_plain_and_pallas(widths, true, n, acts_kind,
                                                  loss_name):
    """The kernel's 3xTF32 arithmetic (`tiled_emulation`: TF32 splits of
    both operands, each k-block's sum added in float32, dW over k-blocks
    of 8 coordinates in the grid's order) with masks and per-block
    thresholds, at the HiP-CT fleet's widths and at small sizes: within
    compare_grads' tolerances of the float32 plain version, and of the
    JAX kernel in interpret mode, block by block; padded units' gradients
    exactly 0."""
    L = len(widths) - 1
    true = true or (widths[1],)
    layers, masks, coords, values, weights, thres, acts = _fleet(
        widths, true, n, seed=n + L, acts_kind=acts_kind)
    uneven = len(set(widths[1:-1])) > 1
    tl, tc, tv, tw, tt, tm = _torch_fleet(layers, coords, values, weights,
                                          thres, masks, L)
    if uneven:
        tm = None
    kw = dict(loss_name=loss_name, beta=0.05)
    le, ge = ft.tiled_emulation(tl, tc, tv, tw, acts, thres=tt, unit_masks=tm,
                                mt=ft.tiled_plan(widths)["mt"], blocks=3,
                                **kw)
    lp, gp = ft.fused_train_grads_reference(tl, tc, tv, tw, acts,
                                            weight_thres=tt, unit_masks=tm,
                                            **kw)
    _close_compare_grads(le, ge["layers"], lp, gp["layers"])
    for i in range(len(true)):
        jl, jg = pt.fused_train_grads(
            [{k: jnp.asarray(v[i]) for k, v in l.items()} for l in layers],
            jnp.asarray(coords[i]), jnp.asarray(values[i]),
            jnp.asarray(weights[i]), acts,
            unit_masks=None if uneven else
            [jnp.asarray(masks[i])] * (L - 1) + [None],
            dynamic_thres=jnp.asarray(thres[i]), interpret=True, tile=256,
            **kw)
        np.testing.assert_allclose(float(le[i]), float(jl), rtol=1e-5)
        for l, (a, b) in enumerate(zip(ge["layers"], jg["layers"])):
            for k in ("w", "b"):
                np.testing.assert_allclose(a[k][i].numpy(), np.asarray(b[k]),
                                           rtol=1e-4, atol=1e-5,
                                           err_msg=f"block {i} d{k}{l}")
            f = true[i]
            if not uneven and l < L - 1:
                assert not a["w"][i, :, f:].any() and not a["b"][i, f:].any()
            if not uneven and l > 0:
                assert not a["w"][i, f:, :].any()


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
