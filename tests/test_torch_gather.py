"""The gather options of the port's samplers against the JAX package's, on
the CPU: Compress.sampler.vector_len (runs of consecutive voxels) and
Compress.raw_gather (an integer volume gathered raw and dequantized).

Single sampler: the JAX RandomPointSampler draws its indices, run rows
or run starts from a key; the test draws the same numbers from the same
key and injects them into the port's sampler (sample_at / sample_rows /
run_indices): coords, values and weights equal exactly, for vector_len
1, 8 and 32, in the aligned form (L divides the population) and the
unaligned one.  Fleet: the JAX run_block_segment takes one SGD step (lr
1) from a key; the port's draw_batch gets the uniform draws that key gives
each block (u) and takes the same step (fleet_step): draws equal exactly
(checked against the JAX formulas and vector_run_starts), losses within
1e-5 relative and gradients within 1e-5 of max|grad| (the matmuls sum in
other orders).  The oracles are tests/test_samplers.py and
tests/test_block_trainer.py:360.  Raw-gather values (raw * A + B in
float32, as the JAX package computes them) equal the JAX package's raw
gather within 1 ulp, and the normalized gather's within 1 ulp of the
normalized range's top (ulp(100) = 7.63e-6, absolute): the affine and the
host's normalization round differently, which near 0 is many ulps of a
small value (the JAX oracle allows 2e-4).
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from brief_pytorch_tpu.core import config as jcfg
from brief_pytorch_tpu.core import coords as jcoords
from brief_pytorch_tpu.core.normalize import normalize_data
from brief_pytorch_tpu.models.phi import init_phi as jinit
from brief_pytorch_tpu.parallel import block_trainer as jbt
from brief_pytorch_tpu.train.optim import make_optimizer as jopt
from brief_pytorch_tpu.train.samplers import RandomPointSampler as JSampler
from brief_pytorch_tpu_torch.core import config as tcfg
from brief_pytorch_tpu_torch.models.phi import init_phi as tinit
from brief_pytorch_tpu_torch.parallel import block_trainer as tbt
from brief_pytorch_tpu_torch.train.fit import raw_dequant
from brief_pytorch_tpu_torch.train.samplers import \
    RandomPointSampler as TSampler
from brief_pytorch_tpu_torch.train.samplers import device_raw

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small CPU training steps: one intra-op thread, so that they do
    not contend with the other test processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASE = dict(coords_channel=3, data_channel=1, layers=4, w0=20, res=False)
CC = """
sampler: {name: randompoint, cube_count: 1, cube_len: [1000, 1000, 1000],
          sample_size: 64, vector_len: 1, gpu_force: true}
loss: {name: datal2, beta: 0.01, weight: [none], weight_thres: 0}
half: false
coords_mode: "-1,1"
optimizer_name_phi: SGD
lr_phi: 1.0
lr_scheduler_phi: {name: none}
"""


TOP_ULP = float(np.spacing(np.float32(100.0)))   # minmaxany_0_100's top


def _volume(shape, c=1, seed=0):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 60000, shape + (c,)).astype(np.uint16)
    norm, side = normalize_data(raw, name="minmaxany_0_100")
    return raw, np.asarray(norm, np.float32), side


# --- the single-volume sampler ----------------------------------------------
@pytest.mark.parametrize("L", [1, 8, 32])
@pytest.mark.parametrize("shape", [(4, 8, 16), (3, 7, 11)],
                         ids=["aligned", "unaligned"])
@pytest.mark.parametrize("weighted", [False, True])
def test_vector_draws_equal_jax_by_injection(L, shape, weighted):
    """The same indices, rows or run starts give the same coords, values
    and weights as the JAX sampler's draw from the key that gave them."""
    _, norm, _ = _volume(shape, c=2)
    pop = int(np.prod(shape))
    data = norm.reshape(pop, 2)
    weight = np.random.default_rng(3).uniform(1, 2, data.shape).astype(
        np.float32) if weighted else None
    S = 100
    js = JSampler(shape, "-1,1", S, L)
    ts = TSampler(shape, "-1,1", S, L)
    key = jax.random.PRNGKey(L)
    want = js.sample(key, jnp.asarray(data),
                     None if weight is None else jnp.asarray(weight))
    n_runs = -(-S // L)
    tdata = torch.from_numpy(data)
    tw = None if weight is None else torch.from_numpy(weight)
    if L == 1:
        idx = np.asarray(jax.random.randint(key, (S,), 0, pop))
        got = ts.sample_at(torch.from_numpy(idx).long(), tdata, tw)
    elif pop % L == 0:
        rows = np.asarray(jax.random.randint(key, (n_runs,), 0, pop // L))
        got = ts.sample_rows(torch.from_numpy(rows).long(), tdata, tw)
    else:
        starts = np.asarray(jax.random.randint(key, (n_runs,), 0,
                                               max(1, pop - L + 1)))
        got = ts.sample_at(ts.run_indices(torch.from_numpy(starts).long()),
                           tdata, tw)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("pop,L", [(4096, 8), (4099, 8)])
def test_vector_run_marginal_is_uniform(pop, L):
    """At a fixed seed the port's runs are uniform: aligned rows over the
    pop / L rows, unaligned run starts over [0, pop - L] (counts within 5
    standard deviations of a uniform draw's), each run L consecutive
    voxels."""
    s = TSampler((pop,), "-1,1", 800 * L, L)
    gen = torch.Generator().manual_seed(7)
    data = torch.arange(pop, dtype=torch.float32)[:, None]
    firsts = []
    for _ in range(50):
        _, vals, _ = s.sample(gen, data, None)
        runs = vals[:, 0].long().reshape(-1, L)
        assert (runs - runs[:, :1] == torch.arange(L)).all()
        firsts.append(runs[:, 0].numpy())
    firsts = np.concatenate(firsts)
    if pop % L == 0:
        assert (firsts % L == 0).all()
        firsts, slots = firsts // L, pop // L
    else:
        slots = pop - L + 1
    counts = np.bincount(firsts, minlength=slots)
    assert len(counts) == slots and counts.min() > 0
    mean = len(firsts) / slots
    assert np.abs(counts - mean).max() <= 5 * math.sqrt(mean)


def test_raw_gather_values_within_1ulp_of_normalized():
    """An integer volume gathered raw and dequantized with raw_dequant's
    (A, B) gives the normalized gather's values within ulp(100), and the
    JAX package's raw gather within 1 ulp; coords equal exactly."""
    shape = (6, 10, 12)
    raw, norm, side = _volume(shape)
    A, B = raw_dequant("minmaxany_0_100", side)
    ts_raw = TSampler(shape, "-1,1", 512, 8, A, B, raw_uint16=True)
    ts = TSampler(shape, "-1,1", 512, 8)
    pop = int(np.prod(shape))
    dev_raw = device_raw(raw.reshape(pop, 1), "cpu")
    assert dev_raw.dtype == torch.int16     # 2 bytes a voxel, as uint16
    rows = torch.randint(0, pop // 8, (64,),
                         generator=torch.Generator().manual_seed(0))
    c_raw, v_raw, _ = ts_raw.sample_rows(rows, dev_raw, None)
    c, v, _ = ts.sample_rows(rows, torch.from_numpy(norm.reshape(pop, 1)),
                             None)
    assert v_raw.dtype == torch.float32
    np.testing.assert_array_equal(c_raw.numpy(), c.numpy())
    assert np.abs(v_raw.numpy() - v.numpy()).max() <= TOP_ULP
    key = jax.random.PRNGKey(1)
    want = JSampler(shape, "-1,1", 512, 8, A, B).sample(
        key, jnp.asarray(raw.reshape(pop, 1)), None)
    jrows = np.asarray(jax.random.randint(key, (64,), 0, pop // 8))
    got = ts_raw.sample_rows(torch.from_numpy(jrows).long(), dev_raw, None)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_max_ulp(got[1].numpy(), np.asarray(want[1]),
                                    maxulp=1)


# --- the fleet ----------------------------------------------------------------
SHAPES = ((3, 5, 41), (4, 4, 33), (2, 6, 36))   # Vmax 615: no L divides it
WIDTHS = (6, 9, 7)


def fleet_blocks(shapes=SHAPES, widths=WIDTHS, raw=False, seed=0):
    """Blocks for both packages' fleets: normalized data, unit weights, and
    under `raw` the uint16 chunk with its dequant (A, B)."""
    out = []
    for i, (s, f) in enumerate(zip(shapes, widths)):
        r, norm, side = _volume(s, seed=seed + i)
        b = {"name": f"b{i}", "data_norm": norm, "weight": np.ones_like(norm),
             "weight_thres_norm": 0.0, "widths": f}
        if raw:
            b["data_raw"], b["dequant"] = r, raw_dequant("minmaxany_0_100",
                                                         side)
        out.append(b)
    return out


def fleet_step_pair(blocks, *, L, pad, half=False, S=64, seed=0):
    """One SGD step (lr 1) of a bucket in both packages on the same draws:
    the JAX run_block_segment from PRNGKey(seed), the port's draw_batch on
    the u that key gives each block, then fleet_step.  Returns (JAX loss,
    port loss, JAX grads, port grads, port batch, u, the JAX stack)."""
    B = len(blocks)
    jmodels = [jinit({"name": "SIREN", **BASE, "features": b["widths"]})
               for b in blocks]
    spec, jlayers, jmasks, jenc = jbt.build_stacked(jmodels,
                                                    jax.random.PRNGKey(5))
    jbatch = jbt.BlockBatch.build(blocks, pad_multiple=pad)
    tx = jopt("SGD", 1.0, jcfg.loads("{name: none}"))
    opt_state = jax.vmap(tx.init)(jlayers)
    key = jax.random.PRNGKey(seed)
    dq = {} if jbatch.dq_scale is None else dict(
        dq_scale=jnp.asarray(jbatch.dq_scale),
        dq_offset=jnp.asarray(jbatch.dq_offset))
    layers_np = jax.tree_util.tree_map(np.asarray, jlayers)
    new, _, losses = jbt.run_block_segment(
        jax.tree_util.tree_map(jnp.array, jlayers), opt_state, jmasks, jenc,
        jnp.asarray(jbatch.data), None, jnp.asarray(jbatch.valid),
        jnp.asarray(jbatch.shapes), jnp.zeros((B,), jnp.float32), key,
        spec=spec, tx=tx, loss_name="datal2", beta=0.01, use_thres=False,
        n_steps=1, sample_size=S, coords_mode="-1,1", half=half,
        sampler="randompoint", vector_len=L, fused=False, **dq)
    jgrads = [{k: l[k] - np.asarray(n[k]) for k in ("w", "b")}
              for l, n in zip(layers_np, new)]
    # the u each block's draw took from the step's key (JAX
    # run_block_segment: split per step, then per block)
    keys_b = jax.random.split(jax.random.split(key, 1)[0], B)
    vmax = jbatch.data.shape[1]
    form = tbt.vector_form("randompoint", L, vmax)
    n_runs = -(-S // L)
    shape = {"randompoint": (S, 3), "aligned": (n_runs,),
             "runs": (n_runs, 3)}[form]
    u = np.stack([np.asarray(jax.random.uniform(k, shape)) for k in keys_b])

    cc = tcfg.loads(CC)
    cc.half = half
    tblocks = [{**b, "model": tinit({"name": "SIREN", **BASE,
                                     "features": b["widths"]}),
                "sampler_name": "randompoint"} for b in blocks]
    st = tbt.BlockFleetTrainer(seed=0, device="cpu")._prepare_bucket(
        tblocks, list(range(B)), cc)
    st.params, st.masks = tbt.stacked_from_numpy(
        layers_np, [np.asarray(m) for m in jmasks])
    tb = tbt.BlockBatch.build(tblocks, pad_multiple=pad)
    st.data = device_raw(tb.data, "cpu")
    batch = tbt.draw_batch(
        "randompoint", None, st.data, None, torch.from_numpy(tb.valid),
        torch.from_numpy(tb.shapes), "-1,1", sample_size=S, vector_len=L,
        dq_scale=st.dq_scale, dq_offset=st.dq_offset,
        raw_uint16=tb.data.dtype == np.uint16, u=torch.from_numpy(u))
    loss, grads = tbt.fleet_step(st, *batch, loss_name="datal2", beta=0.01)
    return (np.asarray(losses[0]), loss.numpy(), jgrads, grads["layers"],
            batch, u, jbatch, form)


@pytest.mark.parametrize("L,pad,form", [
    (1, 1, "randompoint"), (8, 8, "aligned"), (32, 32, "aligned"),
    (8, 1, "runs"), (32, 1, "runs")])
def test_fleet_vector_step_equals_jax_on_injected_draws(L, pad, form):
    jl, tl, jg, tg, batch, u, jbatch, got_form = fleet_step_pair(
        fleet_blocks(), L=L, pad=pad)
    assert got_form == form
    coords, vals, _, _ = batch
    # the draws, against the JAX formulas on the same u
    for b in range(len(SHAPES)):
        sv = jnp.asarray(jbatch.shapes[b])
        if form == "aligned":
            n_rows = max(int(jbatch.valid[b]) // L, 1)
            r = np.minimum((u[b] * np.float32(n_rows)).astype(np.int64),
                           n_rows - 1)
            idx = (r[:, None] * L + np.arange(L)).reshape(-1)[:64]
            axes = jcoords.flat_to_axes24(jnp.asarray(idx), sv)
        elif form == "runs":
            starts = jbt.vector_run_starts(
                jax.random.split(jax.random.split(
                    jax.random.PRNGKey(0), 1)[0], 3)[b], sv, L, -(-64 // L))
            offs = np.zeros((L, 3), np.int32)
            offs[:, 2] = np.arange(L)
            axes = (np.asarray(starts)[:, None, :] + offs).reshape(-1, 3)[:64]
            idx = (axes * np.asarray(jcoords.row_major_strides(sv))).sum(-1)
        else:
            axes = jnp.minimum((jnp.asarray(u[b]) * sv.astype(jnp.float32))
                               .astype(jnp.int32), sv - 1)
            idx = np.asarray(jnp.sum(axes * jcoords.row_major_strides(sv),
                                     axis=-1))
        np.testing.assert_array_equal(
            coords[b].numpy(),
            np.asarray(jcoords.axes_to_coords(jnp.asarray(axes), sv,
                                              "-1,1")))
        np.testing.assert_array_equal(vals[b, :, 0].numpy(),
                                      jbatch.data[b, np.asarray(idx), 0])
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for a, b in zip(tg, jg):
        for k in ("w", "b"):
            scale = np.abs(b[k]).max()
            assert np.abs(a[k].numpy() - b[k]).max() <= 1e-5 * scale + 1e-7


def test_fleet_raw_stack_step_equals_jax_and_float_stack():
    """Integer stacks (raw_gather): the port's bucket keeps uint16, its
    step equals the JAX integer stack's on the same draws, and its
    dequantized values are within ulp(100) of the float32 stack's."""
    jl, tl, jg, tg, batch, _, jbatch, _ = fleet_step_pair(
        fleet_blocks(raw=True), L=8, pad=8)
    assert jbatch.data.dtype == np.uint16
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for a, b in zip(tg, jg):
        for k in ("w", "b"):
            assert np.abs(a[k].numpy() - b[k]).max() <= \
                1e-5 * np.abs(b[k]).max() + 1e-7
    _, _, _, _, fbatch, _, _, _ = fleet_step_pair(fleet_blocks(), L=8, pad=8)
    assert np.abs(batch[1].numpy() - fbatch[1].numpy()).max() <= TOP_ULP
    st = tbt.BlockFleetTrainer(seed=0, device="cpu")
    cc = tcfg.loads(CC)
    cc.sampler.vector_len = 8
    cc.optimizer_name_phi, cc.lr_phi = "Adamax", 0.001
    blocks = [{**b, "model": tinit({"name": "SIREN", **BASE,
                                    "features": b["widths"]})}
              for b in fleet_blocks(raw=True)]
    st.train(blocks, cc, 3)
    stats = st.fleet_stats()[0]
    assert stats["data_dtype"] == "uint16" and stats["vector_len"] == 8
    assert stats["vmax"] % 8 == 0 and all(np.isfinite(st.last_losses[0]))


@pytest.mark.parametrize("S,L", [(37, 8), (512, 8)])
def test_fleet_vector_rows_and_starts_are_uniform(S, L):
    """The fleet's run rows and run starts from torch's float32 uniform
    draws: every row (start) reachable, counts within 5 standard
    deviations of a uniform draw's."""
    n = 200_000
    gen = torch.Generator().manual_seed(S)
    rows = tbt.vector_rows(torch.rand((1, n), generator=gen),
                           torch.tensor([S * L]), L)[0].numpy()
    counts = np.bincount(rows, minlength=S)
    assert len(counts) == S and counts.min() > 0
    assert np.abs(counts - n / S).max() <= 5 * math.sqrt(n / S)
    starts = tbt.vector_run_starts(torch.rand((1, n, 2), generator=gen),
                                   torch.tensor([[3, S + L - 1]]), L)[0]
    last = np.bincount(starts[:, 1].numpy(), minlength=S)
    assert len(last) == S and starts[:, 0].max() == 2
    assert np.abs(last - n / S).max() <= 5 * math.sqrt(n / S)
