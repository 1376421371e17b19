"""The port's block fleet (brief_pytorch_tpu_torch/parallel/block_trainer.py)
against the JAX package's on the CPU.

The same numpy stacks go to both packages' stacked_apply and decode_blocks
(tolerance 1e-6 absolute on outputs of magnitude ~1: both run the same
float32 chain, the matmuls reduce in other orders).  Draws are compared by
index injection (the same u or corners give the same indices and
coordinates, exactly) and by their marginal distribution.
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from brief_pytorch_tpu.core import config as jcfg
from brief_pytorch_tpu.core import coords as jcoords
from brief_pytorch_tpu.models.phi import init_phi as jinit
from brief_pytorch_tpu.parallel import block_trainer as jbt
from brief_pytorch_tpu_torch.core import config as tcfg
from brief_pytorch_tpu_torch.models.phi import init_phi as tinit
from brief_pytorch_tpu_torch.parallel import block_trainer as tbt

BASE = dict(coords_channel=3, data_channel=1, layers=4, w0=20, res=False)
WIDTHS = (5, 9, 7)


def _models(init, widths=WIDTHS, **extra):
    return [init({"name": "SIREN", **BASE, "features": f, **extra})
            for f in widths]


def _jax_stacks(widths=WIDTHS, **extra):
    """The JAX fleet's stacks (spec, layers, masks) and the same as numpy."""
    spec, layers, masks, _ = jbt.build_stacked(_models(jinit, widths, **extra),
                                               jax.random.PRNGKey(3))
    layers_np = [{k: np.asarray(v) for k, v in l.items()} for l in layers]
    return spec, layers, masks, layers_np, [np.asarray(m) for m in masks]


def test_build_stacked_round_trip():
    models = _models(tinit)
    spec, params, masks = tbt.build_stacked(models, seed=7)
    assert spec.dims == ((3, 9), (9, 9), (9, 9), (9, 1))
    assert [tuple(m.shape) for m in masks] == [(3, 9)] * 3 + [(3, 1)]
    per_block = tbt.unstack_params(params["layers"], models)
    for bi, (m, f) in enumerate(zip(models, WIDTHS)):
        own = m.init(tbt._block_generator(7, bi))["layers"]
        for l, (a, b) in enumerate(zip(per_block[bi]["layers"], own)):
            assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
        np.testing.assert_array_equal(masks[0][bi].numpy(),
                                      (np.arange(9) < f).astype(np.float32))
        # everything outside the block's own widths is zero
        for l, layer in enumerate(params["layers"]):
            fi, fo = tbt._linear_dims(m.spec)[l]
            w = layer["w"][bi].clone()
            w[:fi, :fo] = 0
            assert int(torch.count_nonzero(w)) == 0
            assert int(torch.count_nonzero(layer["b"][bi, fo:])) == 0


def test_build_stacked_warm_start_and_topology_check():
    models = _models(tinit, (4, 6))
    warm = [[{"w": np.full((3, 4), 0.5, np.float32),
              "b": np.zeros(4, np.float32)},
             {"w": np.ones((4, 4), np.float32), "b": np.ones(4, np.float32)},
             {"w": np.ones((4, 4), np.float32), "b": np.ones(4, np.float32)},
             {"w": np.ones((4, 1), np.float32), "b": np.ones(1, np.float32)}],
            None]
    _, params, _ = tbt.build_stacked(models, 0, warm)
    assert float(params["layers"][0]["w"][0, :, :4].min()) == 0.5
    with pytest.raises(ValueError, match="do not fit"):
        tbt.build_stacked(models, 0, [warm[0][:3], None])
    with pytest.raises(ValueError, match="incompatible"):
        tbt.build_stacked(_models(tinit, (4,)) + _models(tinit, (4,), w0=30),
                          0)


def test_stacked_from_numpy_and_apply_match_jax():
    spec, jlayers, jmasks, layers_np, masks_np = _jax_stacks()
    params, masks = tbt.stacked_from_numpy(layers_np, masks_np)
    tspec, _, _ = tbt.build_stacked(_models(tinit), 0)
    assert tspec.dims == spec.dims and tspec.entries == spec.entries
    x = np.random.default_rng(0).uniform(-1, 1, (3, 50, 3)).astype(np.float32)
    ref = jax.vmap(lambda l, m, c: jbt.stacked_apply(l, m, c, spec))(
        jlayers, jmasks, jnp.asarray(x))
    out = tbt.stacked_apply(params["layers"], masks, torch.from_numpy(x),
                            tspec)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_stacked_apply_sirenpos_matches_jax():
    models_j = [jinit({"name": "SIRENPos", **BASE, "features": f,
                       "T": [2.0, 3.0, 2.0]}) for f in WIDTHS]
    spec, jlayers, jmasks, _ = jbt.build_stacked(models_j,
                                                 jax.random.PRNGKey(1))
    models_t = [tinit({"name": "SIRENPos", **BASE, "features": f,
                       "T": [2.0, 3.0, 2.0]}) for f in WIDTHS]
    tspec, _, _ = tbt.build_stacked(models_t, 0)
    params, masks = tbt.stacked_from_numpy(
        [{k: np.asarray(v) for k, v in l.items()} for l in jlayers],
        [np.asarray(m) for m in jmasks])
    x = np.random.default_rng(1).uniform(-1, 1, (3, 40, 3)).astype(np.float32)
    ref = jax.vmap(lambda l, m, c: jbt.stacked_apply(l, m, c, spec))(
        jlayers, jmasks, jnp.asarray(x))
    out = tbt.stacked_apply(params["layers"], masks, torch.from_numpy(x),
                            tspec)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("mode", ["-1,1", "n11"])
def test_decode_blocks_matches_jax(mode):
    spec, jlayers, jmasks, layers_np, masks_np = _jax_stacks()
    params, masks = tbt.stacked_from_numpy(layers_np, masks_np)
    tspec, _, _ = tbt.build_stacked(_models(tinit), 0)
    shapes = np.array([[6, 7, 8], [5, 9, 4], [1, 11, 12]], np.int32)
    vmax = int(np.prod(shapes, axis=1).max())
    ref = jbt.decode_blocks(jlayers, jmasks, {}, jnp.asarray(shapes),
                            spec=spec, slab=128, coords_mode=mode, half=False,
                            vmax=vmax)
    out = tbt.decode_blocks(params["layers"], masks,
                            torch.from_numpy(shapes).long(), tspec, slab=100,
                            coords_mode=mode, vmax=vmax)
    assert tuple(out.shape) == tuple(ref.shape) == (3, vmax, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_padded_decode_equals_unpadded_blocks():
    """Each block of the padded, masked fleet decode equals its own chain
    decoded alone (the padding is inert)."""
    models = _models(tinit)
    spec, params, masks = tbt.build_stacked(models, 2)
    shapes = torch.tensor([[4, 5, 6], [3, 3, 3], [2, 7, 5]])
    vmax = int(shapes.prod(1).max())
    out = tbt.decode_blocks(params["layers"], masks, shapes, spec, slab=64,
                            coords_mode="-1,1", vmax=vmax)
    for bi, (m, p) in enumerate(zip(models, tbt.unstack_params(
            params["layers"], models))):
        v = int(shapes[bi].prod())
        axes = tbt.flat_to_axes24(torch.arange(v), shapes[bi])
        coords = tbt.axes_to_coords(axes, shapes[bi], "-1,1")
        np.testing.assert_allclose(out[bi, :v].numpy(),
                                   m.apply(p, coords).numpy(), rtol=0,
                                   atol=1e-6)


# --- draws -----------------------------------------------------------------
SHAPES = np.array([[6, 7, 8], [5, 9, 4], [1, 11, 12]], np.int64)


def test_randompoint_draw_by_injection():
    """The same u gives the same per-axis indices, flat indices and
    coordinates as the JAX fleet's randompoint draw
    (block_trainer.py:558-567)."""
    u = np.array(jax.random.uniform(jax.random.PRNGKey(0), (3, 500, 3)))
    shapes_t = torch.from_numpy(SHAPES)
    axes = tbt.point_axes(torch.from_numpy(u), shapes_t)
    idx = (axes * tbt.row_major_strides(shapes_t)[:, None, :]).sum(-1)
    coords = tbt.axes_to_coords(axes, shapes_t[:, None, :], "-1,1")
    for b, shape in enumerate(SHAPES.astype(np.int32)):
        sv = jnp.asarray(shape)
        jaxes = jnp.minimum((jnp.asarray(u[b]) * sv.astype(jnp.float32))
                            .astype(jnp.int32), sv - 1)
        jidx = jnp.sum(jaxes * jcoords.row_major_strides(sv), axis=-1)
        np.testing.assert_array_equal(axes[b].numpy(), np.asarray(jaxes))
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(
            coords[b].numpy(),
            np.asarray(jcoords.axes_to_coords(jaxes, sv, "-1,1")))


def test_randomcube_draw_by_injection():
    """The same corners give the same positions and flat indices as the
    JAX fleet's cube_positions / cube_gather_indices."""
    cube_len, cube_count = (1, 3, 2), 4
    shapes_t = torch.from_numpy(SHAPES)
    for b, shape in enumerate(SHAPES.astype(np.int32)):
        key = jax.random.PRNGKey(b)
        sv = jnp.asarray(shape)
        maxs = sv - jnp.asarray(cube_len, sv.dtype) + 1
        corners = jax.random.randint(key, (cube_count, 3),
                                     jnp.zeros((3,), jnp.int32), maxs)
        jpos = jbt.cube_positions(key, sv, cube_len, cube_count)
        jidx = jbt.cube_gather_indices(key, sv, cube_len, cube_count)
        tc = torch.from_numpy(np.array(corners)).long()[None]
        pos = tbt.cube_positions(tc, cube_len)[0]
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        idx = tbt.cube_gather_indices(tc, shapes_t[b:b + 1], cube_len)[0]
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("S", [1, 7, 64, 613, 2048])
def test_point_axes_marginal_is_uniform(S):
    """floor(u * S) over torch's float32 uniform draws: every position is
    reachable and the counts are those of a uniform draw (each within 5
    standard deviations of n / S)."""
    n = 400_000
    gen = torch.Generator().manual_seed(S)
    u = torch.rand((1, n, 1), generator=gen)
    pos = tbt.point_axes(u, torch.tensor([[S]]))[0, :, 0].numpy()
    assert pos.min() >= 0 and pos.max() < S
    counts = np.bincount(pos, minlength=S)
    mean = n / S
    sd = math.sqrt(mean * (1 - 1 / S)) if S > 1 else 1.0
    assert np.abs(counts - mean).max() <= 5 * sd + 1e-9


def test_cube_corners_marginal_is_uniform():
    shapes = torch.tensor([[9, 6, 20]])
    cube_len = (4, 6, 5)
    gen = torch.Generator().manual_seed(0)
    u = torch.rand((1, 200_000, 3), generator=gen)
    corners = tbt.cube_corners(u, shapes, cube_len)[0].numpy()
    for a, (s, l) in enumerate(zip((9, 6, 20), cube_len)):
        counts = np.bincount(corners[:, a], minlength=s - l + 1)
        assert len(counts) == s - l + 1 and counts.min() > 0
        mean = 200_000 / (s - l + 1)
        assert np.abs(counts - mean).max() <= 5 * math.sqrt(mean) + 1e-9


def test_draw_batch_fullbatch_and_gathers():
    rng = np.random.default_rng(0)
    blocks = [{"data_norm": rng.uniform(0, 1, tuple(s) + (1,)).astype(
        np.float32), "weight": rng.uniform(1, 2, tuple(s) + (1,)).astype(
        np.float32)} for s in SHAPES]
    batch = tbt.BlockBatch.build(blocks)
    assert batch.vmax == 336 and list(batch.valid) == [336, 180, 132]
    data, weight = torch.from_numpy(batch.data), torch.from_numpy(batch.weight)
    valid, shapes = torch.from_numpy(batch.valid), torch.from_numpy(batch.shapes)
    c, v, w, sv = tbt.draw_batch("fullbatch", None, data, weight, valid,
                                 shapes, "-1,1", sample_size=0)
    assert torch.equal(sv[..., 0].sum(1).long(), valid)
    for b, blk in enumerate(blocks):
        n = int(valid[b])
        np.testing.assert_array_equal(v[b, :n].numpy(),
                                      blk["data_norm"].reshape(-1, 1))
        np.testing.assert_array_equal(
            c[b, :n].numpy(), np.asarray(jcoords.axes_to_coords(
                jcoords.flat_to_axes24(jnp.arange(n), jnp.asarray(SHAPES[b])),
                jnp.asarray(SHAPES[b]), "-1,1")))
    gen = torch.Generator().manual_seed(1)
    c, v, w, sv = tbt.draw_batch("randompoint", gen, data, weight, valid,
                                 shapes, "-1,1", sample_size=64)
    assert sv is None and tuple(v.shape) == (3, 64, 1)
    for b, blk in enumerate(blocks):
        # each drawn value is the block's voxel at the drawn coordinate
        step = 2.0 / np.maximum(SHAPES[b] - 1, 1)
        ax = np.rint((c[b].numpy() + 1.0) / np.where(SHAPES[b] > 1, step, 1)
                     ).astype(int)
        np.testing.assert_array_equal(
            v[b, :, 0].numpy(), blk["data_norm"][tuple(ax.T)][:, 0])
        np.testing.assert_array_equal(
            w[b, :, 0].numpy(), blk["weight"][tuple(ax.T)][:, 0])


def test_fleet_fused_supported():
    spec, _, _ = tbt.build_stacked(_models(tinit), 0)
    assert tbt.fleet_fused_supported(spec, "datal2", "randompoint", False)
    assert tbt.fleet_fused_supported(spec, "datasmoothl1", "randomcube",
                                     False)
    assert not tbt.fleet_fused_supported(spec, "datal2", "fullbatch", False)
    assert not tbt.fleet_fused_supported(spec, "datal2", "randompoint", True)
    pos, _, _ = tbt.build_stacked(
        [tinit({"name": "SIRENPos", **BASE, "features": 4})], 0)
    assert not tbt.fleet_fused_supported(pos, "datal2", "randompoint", False)


# --- the step loop -----------------------------------------------------------
CC = """
sampler: {name: randompoint, cube_count: 1, cube_len: [64, 64, 64],
          sample_size: 256, gpu_force: true}
loss: {name: datal2, beta: 0.01, weight: [none], weight_thres: 0}
half: false
coords_mode: "-1,1"
optimizer_name_phi: Adamax
lr_phi: 0.001
lr_scheduler_phi: {name: none}
"""


def _blocks(widths=WIDTHS, shapes=((6, 7, 8), (5, 9, 4), (4, 4, 4)),
            thres=(0.0, 40.0, 0.0), seed=0):
    rng = np.random.default_rng(seed)
    return [{"name": f"blk{i}",
             "data_norm": rng.uniform(0, 100, s + (1,)).astype(np.float32),
             "weight": rng.uniform(1, 2, s + (1,)).astype(np.float32),
             "model": tinit({"name": "SIREN", **BASE, "features": f}),
             "weight_thres_norm": t}
            for i, (f, s, t) in enumerate(zip(widths, shapes, thres))]


def test_fused_and_autograd_steps_agree_on_the_cpu():
    """The bucket's step through the fused kernel's plain version (the CPU
    side of the fleet wrapper) and through autograd over stacked_apply:
    the same draws, losses within 1e-5 relative, parameters after 5
    Adamax steps within 1e-5."""
    cc = tcfg.loads(CC)
    states = []
    for fused in (True, False):
        blocks = _blocks()
        trainer = tbt.BlockFleetTrainer(seed=0, device="cpu")
        for b in blocks:
            b["sampler_name"] = "randompoint"
        st = trainer._prepare_bucket(blocks, [0, 1, 2], cc)
        st.fused = fused
        st.losses = trainer._run_segment(st, cc, 5)
        states.append(st)
    a, b = states
    assert torch.isfinite(a.losses).all()
    np.testing.assert_allclose(a.losses.numpy(), b.losses.numpy(), rtol=1e-5)
    for la, lb in zip(a.params["layers"], b.params["layers"]):
        for k in ("w", "b"):
            np.testing.assert_allclose(la[k].numpy(), lb[k].numpy(),
                                       rtol=1e-5, atol=1e-6)


def test_fleet_train_buckets_checkpoints_and_state(tmp_path):
    cc = tcfg.loads(CC)
    cc.sampler.name = "randomcube"
    cc.sampler.cube_len = [4, 4, 8]
    blocks = _blocks(shapes=((6, 7, 8), (4, 4, 4), (4, 4, 4)))
    seen = []
    trainer = tbt.BlockFleetTrainer(seed=0, device="cpu")
    state = str(tmp_path / "trainstate_fleet.npz")
    trainer.train(blocks, cc, 6, checkpoint_cb=lambda s, b, p: seen.append(
        (s, [tuple(x["layers"][0]["w"].shape) for x in p])),
        checkpoints=[3, 6], state_path=state)
    # the 4^3 blocks are covered by their clipped cube: a full-batch bucket
    assert sorted(s["sampler"] for s in trainer.fleet_stats()) == \
        ["fullbatch", "randomcube"]
    assert trainer.fused_paths() == [False, False]
    assert seen == [(3, [(3, 5), (3, 9), (3, 7)]),
                    (6, [(3, 5), (3, 9), (3, 7)])]
    assert all(np.isfinite(l).all() for l in trainer.last_losses)
    with np.load(state) as z:
        assert int(z["step"]) == 6
        assert {"b0p0", "b0o0", "b0key", "b1p0", "fingerprint"} <= \
            set(z.files)
    assert all("params" in b for b in blocks)


@pytest.mark.parametrize("override,match", [
    ({"half": True}, "half"),
    ({"sampler": {"vector_len": 4}}, "vector_len"),
])
def test_unported_options_raise(override, match):
    """half, vector_len and a block with a config of its own (solo_cfg)
    raised here until they were ported; now each trains: the bucket takes
    the option (bf16 products, runs of 4 voxels clamped to the shortest
    last axis), the losses are finite, and the solo_cfg block trains on
    the solo path."""
    cc = tcfg.merge(tcfg.loads(CC), override)
    trainer = tbt.BlockFleetTrainer(seed=0, device="cpu")
    trainer.train(_blocks(), cc, 2)
    st = trainer._states[0]
    assert {"half": st.half, "vector_len": st.vector_len == 4}[match]
    assert all(np.isfinite(l).all() for l in trainer.last_losses)
    blocks = _blocks()
    blocks[1]["solo_cfg"] = tcfg.loads(CC)
    trainer = tbt.BlockFleetTrainer(seed=0, device="cpu")
    trainer.train(blocks, tcfg.loads(CC), 2)
    assert trainer.solo_blocks() == [1] and trainer._solo[0].steps_done == 2


def test_fleet_trains_toward_the_data():
    """Blocks of constant values: 150 steps bring every block's loss down
    by more than half (the fleet trains each block toward its own level)."""
    cc = tcfg.loads(CC)
    cc.lr_phi = 0.01
    blocks = _blocks(thres=(0.0, 0.0, 0.0))
    for b, level in zip(blocks, (0.2, 0.5, 0.8)):
        b["data_norm"][:] = level
    trainer = tbt.BlockFleetTrainer(seed=0, device="cpu")
    trainer.train(blocks, cc, 150, checkpoints=[1, 150])
    first = trainer._states[0].losses
    assert first.shape == (149, 3)
    assert (first[-1] < 0.5 * first[0]).all()


# --- stacked res / skip / encoder chains, and the solo path -----------------
STACKED_ZOO = [
    ("SIREN", {"res": True}), ("SIRENFT", {"res": True, "ratio": 1.5}),
    ("NeRF", {"frequencies": 3}), ("NeRF", {"frequencies": 2, "skip": False}),
    ("FFN", {"embsize": 6, "scale": 3}),
    ("FFN", {"embsize": 5, "skip": True}),
    ("SIREN_Pyramid", {"features_dis": 1}), ("SIREN_SIGMOID", {}),
]


def _zoo_models(init, name, extra, widths=WIDTHS):
    return [init({"name": name, **BASE, "features": f, **extra})
            for f in widths]


def _zoo_stacks(name, extra):
    """The JAX fleet's stacks of a family carried into the port."""
    spec, jlayers, jmasks, jenc = jbt.build_stacked(
        _zoo_models(jinit, name, extra), jax.random.PRNGKey(3))
    params, masks = tbt.stacked_from_numpy(
        [{k: np.asarray(v) for k, v in l.items()} for l in jlayers],
        [np.asarray(m) for m in jmasks])
    enc = {k: torch.from_numpy(np.asarray(v)) for k, v in jenc.items()}
    tmodels = _zoo_models(tinit, name, extra)
    tspec, tparams, tmasks = tbt.build_stacked(tmodels, 0)
    return (spec, jlayers, jmasks, jenc), (tspec, params, masks, enc), \
        (tmodels, tparams, tmasks)


@pytest.mark.parametrize("name,extra", STACKED_ZOO)
def test_stacked_zoo_matches_jax(name, extra):
    """build_stacked gives the JAX fleet's spec, dims and masks; the same
    stacks through both stacked_apply and decode_blocks agree at 2e-6;
    FFN's stacked bvals are the JAX fleet's, bit for bit."""
    (spec, jlayers, jmasks, jenc), (tspec, params, masks, enc), \
        (tmodels, tparams, tmasks) = _zoo_stacks(name, extra)
    assert (tspec.entries, tspec.dims, tspec.skip_entry, tspec.encoder,
            tuple(tspec.encoder_cfg)) == \
        (spec.entries, spec.dims, spec.skip_entry, spec.encoder,
         tuple(spec.encoder_cfg))
    for a, b in zip(tmasks, jmasks):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert [tuple(l["w"].shape) for l in tparams["layers"]] == \
        [tuple(l["w"].shape) for l in jlayers]
    if name == "FFN":
        np.testing.assert_array_equal(tparams["encoder"]["bvals"].numpy(),
                                      np.asarray(jenc["bvals"]))
    else:
        assert "encoder" not in tparams
    x = np.random.default_rng(0).uniform(-1, 1, (3, 50, 3)).astype(np.float32)
    ref = jax.vmap(lambda l, m, e, c: jbt.stacked_apply(l, m, c, spec, e))(
        jlayers, jmasks, jenc, jnp.asarray(x))
    out = tbt.stacked_apply(params["layers"], masks, torch.from_numpy(x),
                            tspec, enc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-6)
    shapes = np.array([[6, 7, 8], [5, 9, 4], [1, 11, 12]], np.int32)
    vmax = int(np.prod(shapes, axis=1).max())
    ref = jbt.decode_blocks(jlayers, jmasks, jenc, jnp.asarray(shapes),
                            spec=spec, slab=128, coords_mode="-1,1",
                            half=False, vmax=vmax)
    out = tbt.decode_blocks(params["layers"], masks,
                            torch.from_numpy(shapes).long(), tspec, slab=100,
                            coords_mode="-1,1", vmax=vmax, enc=enc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("name,extra", STACKED_ZOO)
def test_padded_zoo_decode_equals_unpadded_blocks(name, extra):
    """Each block of the padded, masked fleet decode equals its own
    unpadded network decoded alone, and padded units get zero gradient."""
    models = _zoo_models(tinit, name, extra)
    spec, params, masks = tbt.build_stacked(models, 2)
    enc = params.get("encoder")
    shapes = torch.tensor([[4, 5, 6], [3, 3, 3], [2, 7, 5]])
    vmax = int(shapes.prod(1).max())
    out = tbt.decode_blocks(params["layers"], masks, shapes, spec, slab=64,
                            coords_mode="-1,1", vmax=vmax, enc=enc)
    per_block = tbt.unstack_params(params["layers"], models, enc)
    for bi, (m, p) in enumerate(zip(models, per_block)):
        v = int(shapes[bi].prod())
        axes = tbt.flat_to_axes24(torch.arange(v), shapes[bi])
        coords = tbt.axes_to_coords(axes, shapes[bi], "-1,1")
        np.testing.assert_allclose(out[bi, :v].numpy(),
                                   m.apply(p, coords).numpy(), rtol=0,
                                   atol=1e-6)
        assert ("encoder" in p) == (name == "FFN")
    leaves = [t.requires_grad_(True) for l in params["layers"]
              for t in l.values()]
    x = torch.rand(3, 20, 3) * 2 - 1
    loss = (tbt.stacked_apply(params["layers"], masks, x, spec, enc)
            ** 2).sum()
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    for l, layer in enumerate(params["layers"]):
        gw, gb = next(it), next(it)
        for bi, m in enumerate(models):
            fi, fo = tbt._linear_dims(m.spec)[l]
            assert int(torch.count_nonzero(gw[bi, fi:, :])) == 0
            assert int(torch.count_nonzero(gw[bi, :, fo:])) == 0
            assert int(torch.count_nonzero(gb[bi, fo:])) == 0
    if enc is not None:
        assert not enc["bvals"].requires_grad


@pytest.mark.parametrize("name,extra", [("NeRF", {"frequencies": 3}),
                                        ("FFN", {"embsize": 6}),
                                        ("SIREN", {"res": True})])
def test_fleet_trains_stacked_zoo_through_autograd(name, extra, tmp_path):
    """A res / skip / encoder bucket is never a fused one; it trains through
    autograd, leaves FFN's stacked bvals untouched, decodes, and writes its
    state."""
    cc = tcfg.loads(CC)
    cc.lr_phi = 0.01
    blocks = _blocks(thres=(0.0, 0.0, 0.0))
    for b, f, level in zip(blocks, WIDTHS, (20.0, 50.0, 80.0)):
        b["model"] = tinit({"name": name, **BASE, "features": f, **extra})
        b["data_norm"][:] = level
    trainer = tbt.BlockFleetTrainer(seed=0, device="cpu")
    state = str(tmp_path / "state.npz")
    trainer.train(blocks, cc, 40, checkpoints=[1, 40], state_path=state)
    st = trainer._states[0]
    assert trainer.fused_paths() == [False] and trainer.solo_blocks() == []
    assert not tbt.fleet_fused_supported(st.spec, "datal2", "randompoint",
                                         False)
    assert (st.losses[-1] < st.losses[0]).all()
    if name == "FFN":
        fresh = tbt.build_stacked([b["model"] for b in blocks], 0)[1]
        assert torch.equal(st.params["encoder"]["bvals"],
                           fresh["encoder"]["bvals"])
        assert all("encoder" in b["params"] for b in blocks)
    dec = trainer.decode(blocks, cc)
    for b, d in zip(blocks, dec):
        assert d.shape == b["data_norm"].shape and np.isfinite(d).all()
        own = b["model"].apply(
            {k: v for k, v in b["params"].items()},
            tbt.axes_to_coords(tbt.flat_to_axes24(
                torch.arange(d.size), torch.tensor(d.shape[:-1])),
                torch.tensor(d.shape[:-1]), "-1,1"))
        np.testing.assert_allclose(d.reshape(-1, 1), own.detach().numpy(),
                                   atol=2e-5)
    with np.load(state) as z:
        n_leaves = len([k for k in z.files if k.startswith("b0p")])
        assert n_leaves == 2 * len(st.params["layers"]) + (name == "FFN")


@pytest.mark.parametrize("name", ["MFNFourier", "MFNGabor"])
@pytest.mark.parametrize("sampler", ["randompoint", "randomcube"])
def test_solo_path_trains_mfn_blocks(name, sampler, tmp_path):
    """MFN blocks do not stack: they train on the solo path in lockstep with
    the chain bucket, checkpoint with the fleet, decode through their own
    apply, and land in the fleet state as s{i}*."""
    cc = tcfg.loads(CC)
    cc.lr_phi = 0.01
    cc.sampler.name = sampler
    cc.sampler.cube_len = [3, 4, 4]
    blocks = _blocks(thres=(0.0, 30.0, 0.0))
    for i in (0, 2):
        blocks[i]["model"] = tinit({"name": name, **BASE, "features": 6,
                                    "input_scale": 4.0})
        blocks[i]["data_norm"][:] = 40.0 + 10 * i
    seen = []
    trainer = tbt.BlockFleetTrainer(seed=0, device="cpu")
    state = str(tmp_path / "state.npz")
    trainer.train(blocks, cc, 30, checkpoints=[10, 30], state_path=state,
                  checkpoint_cb=lambda s, b, p: seen.append(
                      (s, [sorted(x) for x in p])))
    assert trainer.solo_blocks() == [0, 2]
    assert [len(st.models) for st in trainer._states] == [1]
    mfn_keys = ["filters", "linear", "output"]
    assert seen == [(10, [mfn_keys, ["layers"], mfn_keys]),
                    (30, [mfn_keys, ["layers"], mfn_keys])]
    for ss in trainer._solo:
        assert ss.steps_done == 30 and ss.losses.shape == (20,)
        assert float(ss.losses[-1]) < float(ss.losses[0])
    assert len(trainer.last_losses) == 3
    dec = trainer.decode(blocks, cc)
    for b, d in zip(blocks, dec):
        assert d.shape == b["data_norm"].shape and np.isfinite(d).all()
    with np.load(state) as z:
        assert {"s0p0", "s0o0", "s0key", "s1done", "b0p0"} <= set(z.files)
        assert int(z["s1done"]) == 30
        import json
        fp = json.loads(bytes(z["fingerprint"].tobytes()))
        assert fp["solo"] == [0, 2] and fp["buckets"] == [[1]]
