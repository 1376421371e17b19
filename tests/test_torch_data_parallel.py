"""Data parallelism in the port (parallel/data_parallel.py): the batch
split over gloo ranks on the host, one all_reduce a step.

Against the JAX package: a DP step on 2 ranks with injected draws equals
the JAX package's step on the union batch; shard_volume's padded rows
and global_batch equal JAX DataParallelTrainer's.  Against the port's own
runs, case for case as tests/test_data_parallel.py does for JAX: loss
descent and bitwise replication, quality against one rank, the global
batch, unit weights, padding rows, NFGR through the CLI, and resume.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from brief_pytorch_tpu.core import config as jcfg
from brief_pytorch_tpu.core.coords import index_to_coords as jcoords
from brief_pytorch_tpu.models.phi import init_phi as jinit
from brief_pytorch_tpu.parallel.data_parallel import \
    DataParallelTrainer as JDP
from brief_pytorch_tpu.parallel.mesh import make_mesh
from brief_pytorch_tpu.train.loss import make_loss as jloss
from brief_pytorch_tpu.train.optim import make_optimizer as jopt
from brief_pytorch_tpu_torch.cli import main as cli
from brief_pytorch_tpu_torch.core import config as tcfg
from brief_pytorch_tpu_torch.io.image import save_img
from brief_pytorch_tpu_torch.models.phi import init_phi as tinit
from brief_pytorch_tpu_torch.parallel.data_parallel import \
    DataParallelTrainer as TDP
from brief_pytorch_tpu_torch.train.checkpoint import pack_tree

from torch_ranks import lines, run_ranks

PHI = {"name": "SIREN", "coords_channel": 3, "data_channel": 1,
       "features": 16, "layers": 4, "w0": 20}
# the tolerance of the port's DP step against the JAX package's on the
# union batch: float32 sums in another order (autograd vs XLA, the
# all_reduce's order)
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Training in this process beside the ranks' processes: one intra-op
    thread, so that they do not contend with each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cc(sample_size=512):
    return f"""
sampler: {{name: randompoint, sample_size: {sample_size},
           cube_count: 1, cube_len: [8,8,8], gpu_force: true}}
loss: {{name: datal2, beta: 0.01, weight: [none], weight_thres: 0}}
half: false
coords_mode: "-1,1"
optimizer_name_phi: Adamax
lr_phi: 0.003
lr_scheduler_phi: {{name: none}}
"""


@pytest.fixture(scope="module")
def volume():
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, 16)] * 3, indexing="ij")
    vol = np.sin(3 * z) * np.cos(2 * y) + x
    return vol[..., None].astype(np.float32)


def _save_tree(path, tree):
    arrs = {}
    pack_tree(arrs, "p", tree)
    np.savez(path, **arrs)


# the port's DP trainer on each rank, from the parameters and draws the
# parent wrote; writes its parameters after the steps
STEP_WORKER = """
    from brief_pytorch_tpu_torch.core import config as tcfg
    from brief_pytorch_tpu_torch.core.tree import tree_leaves_sorted
    from brief_pytorch_tpu_torch.models.phi import init_phi
    from brief_pytorch_tpu_torch.parallel.data_parallel import \\
        DataParallelTrainer
    import json
    tmp, n_steps = ARGS[0], int(ARGS[1])
    phi = json.load(open(f"{tmp}/phi.json"))
    model = init_phi(phi)
    params = model.init(torch.Generator().manual_seed(0))
    with np.load(f"{tmp}/params.npz") as z:
        for i, t in enumerate(tree_leaves_sorted(params)):
            t.copy_(torch.from_numpy(z[f"p{i}"]))
    vol = np.load(f"{tmp}/vol.npy")
    with np.load(f"{tmp}/draws.npz") as z:
        draws = [torch.from_numpy(z[f"r{RANK}s{s}"]) for s in range(n_steps)]
    cc = tcfg.loads(open(f"{tmp}/cc.yaml").read())
    dp = DataParallelTrainer(model, seed=0, device="cpu")
    params, _, losses = dp.fit(params, vol, np.ones_like(vol), cc, n_steps,
                               draws=draws)
    np.savez(f"{tmp}/rank{RANK}.npz", **{
        f"p{i}": t.numpy() for i, t in enumerate(tree_leaves_sorted(params))},
        losses=losses)
"""


@pytest.mark.parametrize("n_steps", [1, 3])
def test_dp_steps_equal_jax_on_the_union_batch(tmp_path, n_steps):
    """n_steps DP steps on 2 gloo ranks, each on injected rows of its
    shard (rank 1's last row a padding row), against the JAX package's
    model.apply + make_loss + value_and_grad + Adamax on the union batch
    from the same numpy weights: parameters bitwise equal across ranks and
    within RTOL of JAX's."""
    import json
    vol = np.random.default_rng(1).uniform(0, 1, (7, 5, 5, 1)) \
        .astype(np.float32)                      # 175 voxels: 1 padding row
    world, local_pop, local = 2, 88, 32
    rng = np.random.default_rng(2)
    draws = {}
    for s in range(n_steps):
        for r in range(world):
            idx = rng.integers(0, local_pop, local)
            if r == 1:
                idx[-1] = local_pop - 1          # the padding row
            draws[f"r{r}s{s}"] = idx.astype(np.int64)
    jmodel = jinit(PHI)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    _save_tree(tmp_path / "params.npz",
               jax.tree_util.tree_map(np.asarray, jparams))
    np.savez(tmp_path / "draws.npz", **draws)
    np.save(tmp_path / "vol.npy", vol)
    (tmp_path / "cc.yaml").write_text(_cc(sample_size=64))
    (tmp_path / "phi.json").write_text(json.dumps(PHI))
    run_ranks(STEP_WORKER, world, tmp_path, n_steps)

    # the JAX package's step on the union of the ranks' batches
    flat = np.concatenate([vol.reshape(-1, 1), vol.reshape(-1, 1)[:1]])
    cc = jcfg.loads(_cc(sample_size=64))
    tx = jopt(cc.optimizer_name_phi, float(cc.lr_phi), cc.lr_scheduler_phi)
    opt_state = tx.init(jparams)
    loss_fn = jloss("datal2")
    for s in range(n_steps):
        gidx = np.concatenate([r * local_pop + draws[f"r{r}s{s}"]
                               for r in range(world)])
        vals = jnp.asarray(flat[gidx])
        gidx = np.where(gidx < vol[..., 0].size, gidx, 0)
        coords = jcoords(jnp.asarray(gidx), vol.shape[:-1], "-1,1")

        def loss_f(p):
            return loss_fn(vals, jmodel.apply(p, coords), jnp.ones_like(vals),
                           0.0)
        _, grads = jax.value_and_grad(loss_f)(jparams)
        upd, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, upd)
    want = {}
    pack_tree(want, "p", jax.tree_util.tree_map(np.asarray, jparams))
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]
    for k, w in want.items():
        np.testing.assert_array_equal(got[0][k], got[1][k])
        np.testing.assert_allclose(got[0][k], w, rtol=RTOL, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("unit", [True, False])
def test_shard_volume_equals_jax(volume, unit):
    """The ranks' shards, concatenated, are JAX shard_volume's padded
    flat arrays on the 8-device CPU mesh (15^3 = 3375 rows -> 3376, the
    pad a copy of voxel 0); unit weights make no weight shard in both."""
    vol = volume[:15, :15, :15]
    w = np.ones_like(vol) if unit else \
        np.random.default_rng(0).uniform(1, 2, vol.shape).astype(np.float32)
    jd, jw, jspatial = JDP(make_mesh(n_block_shards=1, n_data_shards=8),
                           jinit(PHI)).shard_volume(vol, w)
    shards = [TDP(tinit(PHI), device="cpu", rank=r, world=8)
              .shard_volume(vol, w) for r in range(8)]
    assert all(s[2] == jspatial == (15, 15, 15) for s in shards)
    np.testing.assert_array_equal(
        torch.cat([s[0] for s in shards]).numpy(), np.asarray(jd))
    if unit:
        assert jw is None and all(s[1] is None for s in shards)
    else:
        np.testing.assert_array_equal(
            torch.cat([s[1] for s in shards]).numpy(), np.asarray(jw))


@pytest.mark.parametrize("sample_size,world", [(100000, 3), (64, 4), (7, 2)])
def test_global_batch_equals_jax(volume, sample_size, world):
    jm = jinit(PHI)
    jdp = JDP(make_mesh(n_block_shards=1, n_data_shards=world,
                        devices=jax.devices()[:world]), jm)
    jdp.prepare(volume, np.ones_like(volume),
                jcfg.loads(_cc(sample_size)), 0.0,
                jm.init(jax.random.PRNGKey(0)))
    tm = tinit(PHI)
    tdp = TDP(tm, device="cpu", rank=world - 1, world=world)
    tdp.prepare(volume, np.ones_like(volume), tcfg.loads(_cc(sample_size)),
                0.0, tm.init(torch.Generator().manual_seed(0)))
    assert tdp.global_batch == jdp.global_batch >= sample_size


# ---- the port against its own runs (tests/test_data_parallel.py) ----------
FIT_WORKER = """
    import hashlib
    from brief_pytorch_tpu_torch.core import config as tcfg
    from brief_pytorch_tpu_torch.core.tree import tree_leaves
    from brief_pytorch_tpu_torch.models.phi import init_phi
    from brief_pytorch_tpu_torch.parallel.data_parallel import \\
        DataParallelTrainer
    import json
    tmp, n_steps = ARGS[0], int(ARGS[1])
    model = init_phi(json.load(open(f"{tmp}/phi.json")))
    params = model.init(torch.Generator().manual_seed(0))
    vol = np.load(f"{tmp}/vol.npy")
    cc = tcfg.loads(open(f"{tmp}/cc.yaml").read())
    params, _, losses = DataParallelTrainer(model, seed=0, device="cpu").fit(
        params, vol, np.ones_like(vol), cc, n_steps)
    h = hashlib.sha256(b"".join(t.numpy().tobytes()
                                for t in tree_leaves(params)))
    print("HASH", h.hexdigest())
    print("LOSSES", ",".join(repr(float(x)) for x in losses))
"""


@pytest.fixture(scope="module")
def two_rank_fit(tmp_path_factory, volume):
    """300 DP steps of SIREN 4 x 24 on the 16^3 volume on 2 ranks, and the
    same on one rank in this process."""
    import json
    tmp = tmp_path_factory.mktemp("dp")
    phi = {**PHI, "features": 24}
    np.save(tmp / "vol.npy", volume)
    (tmp / "cc.yaml").write_text(_cc())
    (tmp / "phi.json").write_text(json.dumps(phi))
    outs = run_ranks(FIT_WORKER, 2, tmp, 300)
    model = tinit(phi)
    _, _, l1 = TDP(model, seed=0, device="cpu").fit(
        model.init(torch.Generator().manual_seed(0)), volume,
        np.ones_like(volume), tcfg.loads(_cc()), 300)
    return {"hash": [lines(o, "HASH")[0] for o in outs],
            "losses": [np.asarray([float(x) for x in
                                   lines(o, "LOSSES")[0].split(",")])
                       for o in outs], "one_rank": l1}


def test_loss_descends_and_params_replicated(two_rank_fit):
    losses = two_rank_fit["losses"][0]
    assert losses[-20:].mean() < losses[:20].mean() * 0.5
    # every rank took the same steps on the same reduced bits
    assert two_rank_fit["hash"][0] == two_rank_fit["hash"][1]
    np.testing.assert_array_equal(*two_rank_fit["losses"])


def test_matches_quality_of_single_rank(two_rank_fit):
    """2 ranks and 1 rank draw different batches: compare converged
    quality, not bits (JAX tests/test_data_parallel.py:65)."""
    l2, l1 = two_rank_fit["losses"][0], two_rank_fit["one_rank"]
    assert l2[-30:].mean() < 2.5 * l1[-30:].mean() + 1e-3


def test_global_batch_preserved_on_nondivisible_sample_size(volume):
    """ceil, never floor: 1001 over 8 ranks is 1008 a step, 1024 stays."""
    model = tinit(PHI)
    params = model.init(torch.Generator().manual_seed(0))
    tr = TDP(model, device="cpu", rank=3, world=8)
    tr.prepare(volume, np.ones_like(volume), tcfg.loads(_cc(1001)), 0.0,
               params)
    assert tr.global_batch == 1008 and tr.sampler.local_batch == 126
    tr.prepare(volume, np.ones_like(volume), tcfg.loads(_cc(1024)), 0.0,
               params)
    assert tr.global_batch == 1024


def test_unit_weight_skips_weight_shard(volume):
    """An all-ones weight volume makes no weight shard, and training still
    descends; a non-unit one ships its shard."""
    model = tinit(PHI)
    tr = TDP(model, seed=0, device="cpu", rank=0, world=2)
    params = model.init(torch.Generator().manual_seed(0))
    tr.prepare(volume, np.ones_like(volume), tcfg.loads(_cc()), 0.0, params)
    assert tr._weight is None
    _, _, losses = TDP(model, seed=0, device="cpu").fit(
        params, volume, np.ones_like(volume), tcfg.loads(_cc()), 100)
    assert losses[-10:].mean() < losses[:10].mean()
    w = np.ones_like(volume)
    w[0, 0, 0, 0] = 2.0
    tr.prepare(volume, w, tcfg.loads(_cc()), 0.0, params)
    assert tr._weight is not None and tr._weight.shape == tr._data.shape


def test_padding_rows_map_to_voxel_0(volume):
    """15^3 over 8 ranks pads one row onto rank 7's shard: its value and
    its coordinates are voxel 0's, not a point past the volume."""
    vol = volume[:15, :15, :15]
    model = tinit(PHI)
    tr = TDP(model, device="cpu", rank=7, world=8)
    tr.prepare(vol, None, tcfg.loads(_cc()), 0.0,
               model.init(torch.Generator().manual_seed(0)))
    last = torch.tensor([tr.sampler.local_pop - 1, 0])
    coords, vals, _ = tr.sampler.sample_at(last, tr._data, None)
    assert tr.sampler.local_pop * 8 == 3376
    assert coords[0].tolist() == [-1.0, -1.0, -1.0]
    assert float(vals[0]) == float(vol[0, 0, 0, 0])
    first = 7 * tr.sampler.local_pop      # rank 7's first row, in range
    z, rem = divmod(first, 225)
    assert float(vals[1]) == float(vol[z, rem // 15, rem % 15, 0])


# ---- NFGR with Compress.data_shards through the CLI -----------------------
def _opt_yaml(data_path, out, project, steps, checkpoints="none"):
    return f"""
Reproduc: {{seed: 42, benchmark: false, deterministic: true}}
Dataset: {{data_path: "{data_path}"}}
Log: {{outputs_dir: "{out}", project_name: {project}, stdlog: false,
      tensorboard: false, time: false}}
CompressFramework:
  Name: NFGR
  Compress:
    divide: {{divide_type: none, param_alloc: by_size, param_size_thres: 26,
             exception: none}}
    half: false
    data_shards: 2
    sampler: {{name: randompoint, cube_count: 1,
              cube_len: [10000000,10000000,10000000], sample_size: 1024,
              gpu_force: true}}
    coords_mode: "-1,1"
    preprocess:
      denoise: {{level: 0, close: [2,2,2]}}
      clip: [0, 65535]
    param: {{init_net_path: none, filesize_ratio: 0, given_size: 8000}}
    loss: {{name: datal2, beta: 0.01, weight: [none], weight_thres: 0}}
    gpu: true
    max_steps: {steps}
    checkpoints: {checkpoints}
    loss_log_freq: 20
    lr_phi: 0.003
    optimizer_name_phi: Adamax
    lr_scheduler_phi: {{name: none}}
    decompress: true
  Decompress:
    sample_size: 4096
    gpu: true
    postprocess:
      denoise: {{level: 0, close: [2,2,2]}}
      clip: [0, 65535]
    keep_decompressed: false
    mip: false
    mse: true
    psnr: true
    ssim: false
  Module:
    phi: {{name: SIREN, coords_channel: 3, data_channel: 1, layers: 4,
          w0: 20, output_act: false, res: false}}
  Normalize: {{name: minmaxany_0_100}}
"""


@pytest.fixture()
def vol_path(tmp_path):
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, 16)] * 3, indexing="ij")
    vol = 20000 + 15000 * (np.sin(3 * z) * np.cos(2 * y) + x) / 2
    path = str(tmp_path / "vol.tif")
    save_img(path, np.clip(vol, 0, 65535).astype(np.uint16)[..., None])
    return path


@pytest.fixture(autouse=True)
def _one_thread_ranks(monkeypatch):
    """The CLI's ranks in these tests take one thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _cli(tmp_path, vol_path, project, steps, checkpoints="none", *extra):
    y = tmp_path / f"{project}.yaml"
    y.write_text(_opt_yaml(vol_path, tmp_path / "out", project, steps,
                           checkpoints))
    return cli.main(["-p", str(y), "-g", "cpu", *extra])


def test_nfgr_with_data_shards_through_the_cli(tmp_path, vol_path):
    """Compress.data_shards: 2 with -g cpu: the CLI starts 2 gloo ranks;
    rank 0 writes the one run dir (its state holds both ranks'
    generators) and its summary comes back."""
    res = _cli(tmp_path, vol_path, "dp", 400)
    assert res["psnr"] > 15, res
    assert res["global_batch"] == 1024 and res["steps"] == 400
    assert os.listdir(tmp_path / "out") == ["dp"]
    with np.load(tmp_path / "out" / "dp" / "trainstate.npz") as z:
        assert z["key"].shape[0] == 2
        assert not np.array_equal(z["key"][0], z["key"][1])


def test_data_parallel_resume_is_byte_for_byte(tmp_path, vol_path):
    """2 ranks stopped at step 20 and resumed to 40 write the module bytes
    of the uninterrupted 40-step run; the state refuses a resume under
    another number of ranks (its fingerprint's data_shards)."""
    _cli(tmp_path, vol_path, "full", 40, "every_20")
    _cli(tmp_path, vol_path, "part", 20, "every_20")
    stopped = str(tmp_path / "out" / "part")
    _cli(tmp_path, vol_path, "part", 40, "every_20", "-resume", stopped)
    # the resumed run's logger takes the next free dir name, part-0
    mods = [tmp_path / "out" / p / "steps40" / "compressed" / "module"
            for p in ("full", "part-0")]
    names = sorted(os.listdir(mods[0]))
    assert names and names == sorted(os.listdir(mods[1]))
    for n in names:
        assert (mods[0] / n).read_bytes() == (mods[1] / n).read_bytes(), n
    y = tmp_path / "one.yaml"
    y.write_text(_opt_yaml(vol_path, tmp_path / "out", "one", 40,
                           "every_20").replace("data_shards: 2",
                                               "data_shards: 1"))
    with pytest.raises(ValueError, match="different"):
        cli.main(["-p", str(y), "-g", "cpu", "-resume", stopped])
