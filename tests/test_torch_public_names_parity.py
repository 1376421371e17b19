"""The port's counterparts of the JAX package's last public names, held
against the JAX package on the CPU (inputs made from a seed with numpy).

floordiv24 and create_coords_np are exact; create_coords and
create_flattened_coords are held to the four units in the last place of
max(|min|, |max|) that tests/test_torch_coords.py holds axis_linspace to;
fast_cos to the 1e-6 that tests/test_torch_fast_math.py holds fast_sin to.
The config helpers, copy_dir, param_count, the tree aliases and
ThroughputMeter's report are equal.  annotate's range is found by name in
a trace; the fleet's progress_cb gives every block's last loss in block
order at each checkpoint and leaves training unchanged.
"""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brief_pytorch_tpu.core import config as jcfg
from brief_pytorch_tpu.core import coords as jc
from brief_pytorch_tpu.io import modelsave as jms
from brief_pytorch_tpu.models import phi as jphi
from brief_pytorch_tpu.models.phi import init_phi as jinit
from brief_pytorch_tpu.ops import fast_math as jf
from brief_pytorch_tpu.parallel import block_trainer as jbt
from brief_pytorch_tpu.utils import profiling as jprof
from brief_pytorch_tpu_torch.core import config as tcfg
from brief_pytorch_tpu_torch.core import coords as tc
from brief_pytorch_tpu_torch.io import modelsave as tms
from brief_pytorch_tpu_torch.models import phi as tphi
from brief_pytorch_tpu_torch.models.phi import init_phi as tinit
from brief_pytorch_tpu_torch.ops import fast_math as tf
from brief_pytorch_tpu_torch.parallel import block_trainer as tbt
from brief_pytorch_tpu_torch.partition import tree as ttree
from brief_pytorch_tpu_torch.utils import profiling as tprof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [os.path.join(ROOT, "opt", "SingleTask", "default.yaml"),
           os.path.join(ROOT, "opt", "DivideTask", "hipct.yaml")]


# --- core/coords ------------------------------------------------------------
def _floordiv_pairs():
    """10,000 random pairs with a in [0, 2**24) and b in [1, 4096], and the
    edges b*k - 1, b*k (below 2**24) and 2**24 - 1."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 24, 10_000)
    b = rng.integers(1, 4097, 10_000)
    eb = np.concatenate([np.arange(1, 65), rng.integers(1, 4097, 400),
                         [4095, 4096]])
    k = np.maximum(1, rng.integers(0, 2 ** 24, eb.size) // eb)
    edges_a = np.concatenate([eb * k - 1, eb * k, np.full(eb.size, 2 ** 24 - 1),
                              np.zeros(eb.size, np.int64)])
    edges_b = np.tile(eb, 4)
    a, b = np.concatenate([a, edges_a]), np.concatenate([b, edges_b])
    assert a.max() < 2 ** 24 and a.min() >= 0 and b.min() >= 1
    return a.astype(np.int32), b.astype(np.int32)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_floordiv24_equals_jax(dtype):
    a, b = _floordiv_pairs()
    ref = np.asarray(jc.floordiv24(jnp.asarray(a), jnp.asarray(b)))
    out = tc.floordiv24(torch.from_numpy(a).to(dtype),
                        torch.from_numpy(b).to(dtype))
    assert out.dtype == dtype
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(ref, a // b)


def test_floordiv24_by_a_python_int():
    a, _ = _floordiv_pairs()
    for b in (1, 3, 7, 64, 4096):
        ref = np.asarray(jc.floordiv24(jnp.asarray(a), b))
        np.testing.assert_array_equal(
            tc.floordiv24(torch.from_numpy(a), b).numpy(), ref)


SHAPES = [(1,), (7,), (3, 5), (4, 1, 6), (16, 16, 16)]
GRID_MODES = ["n11", "0p1", "-2,3"]


def _tol(mode):
    lo, hi = jc.parse_coords_mode(mode)
    return 4 * np.spacing(np.float32(max(abs(lo), abs(hi))))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("mode", GRID_MODES)
def test_create_coords_within_four_ulp(shape, mode):
    ref = np.asarray(jc.create_coords(shape, mode))
    out = tc.create_coords(shape, mode).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=_tol(mode))
    flat_ref = np.asarray(jc.create_flattened_coords(shape, mode))
    flat = tc.create_flattened_coords(shape, mode).numpy()
    assert flat.shape == flat_ref.shape == (int(np.prod(shape)), len(shape))
    np.testing.assert_allclose(flat, flat_ref, rtol=0, atol=_tol(mode))
    np.testing.assert_array_equal(flat, out.reshape(-1, len(shape)))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("mode", GRID_MODES)
def test_create_coords_np_equals_jax(shape, mode):
    ref = jc.create_coords_np(shape, mode)
    out = tc.create_coords_np(shape, mode)
    assert isinstance(out, np.ndarray) and out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


def test_create_coords_dtype_and_device():
    """dtype and device go to every axis (axis_linspace's handling); the
    grid's axes are axis_linspace's values."""
    out = tc.create_coords((3, 4), "n11", torch.float64, device="cpu")
    assert out.dtype == torch.float64 and out.device.type == "cpu"
    assert torch.equal(out[:, 0, 0], tc.axis_linspace(3, "n11",
                                                      torch.float64))
    assert torch.equal(out[0, :, 1], tc.axis_linspace(4, "n11",
                                                      torch.float64))
    flat = tc.create_flattened_coords((3, 4), device=torch.device("cpu"))
    assert flat.shape == (12, 2) and flat.dtype == torch.float32


# --- ops/fast_math ------------------------------------------------------------
def _x(n=20001, lim=200.0, seed=3):
    rng = np.random.default_rng(seed)
    return np.concatenate([np.linspace(-lim, lim, n),
                           rng.uniform(-lim, lim, n)]).astype(np.float32)


def test_fast_cos_matches_jax():
    x = _x()
    ref = np.asarray(jf.fast_cos(jnp.asarray(x)))
    out = tf.fast_cos(torch.from_numpy(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    # fast_sin's budget over |x| <= 200 (ops/fast_math.py)
    assert np.abs(out.numpy() - np.cos(x.astype(np.float64))).max() <= 8e-6


def test_fast_cos_float64_and_exact_sine(monkeypatch):
    x = torch.from_numpy(_x(seed=4).astype(np.float64))
    assert torch.equal(tf.fast_cos(x), torch.cos(x))
    x32 = x.float()
    monkeypatch.setenv("BRIEF_TPU_EXACT_SINE", "1")
    assert torch.equal(tf.fast_cos(x32), torch.cos(x32))


# --- core/config ----------------------------------------------------------------
@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_helpers_equal_jax(path):
    j, t = jcfg.load(path), tcfg.load(path)
    assert tcfg.to_dict(t) == jcfg.to_dict(j)
    leaves = list(tcfg.iter_leaves(t))
    assert leaves == list(jcfg.iter_leaves(j)) and len(leaves) > 20
    keys = [k for k, _ in leaves]
    dotted = sorted({".".join(k.split(".")[:i]) for k in keys
                     for i in range(1, k.count(".") + 2)})
    for key in dotted:
        assert t.get_path(key) == j.get_path(key)
    for key, v in leaves:
        assert t.get_path(key) == v
    for missing in ("Nope", "CompressFramework.Nope",
                    "Dataset.data_path.deeper", keys[0] + ".x.y"):
        assert t.get_path(missing) is None
        assert t.get_path(missing, "dflt") == \
            j.get_path(missing, "dflt") == "dflt"


# --- io/modelsave ---------------------------------------------------------------
def test_copy_dir_equals_jax(tmp_path):
    rng = np.random.default_rng(5)
    src = tmp_path / "src"
    src.mkdir()
    for i in range(4):
        (src / f"weight-{i}-3-4").write_bytes(rng.bytes(48))
    (src / "sideinfos.yaml").write_text("a: 1\n")
    tms.copy_dir(str(src), str(tmp_path / "port" / "new"))
    jms.copy_dir(str(src), str(tmp_path / "jax" / "new"))
    names = sorted(os.listdir(src))
    assert sorted(os.listdir(tmp_path / "port" / "new")) == names
    for n in names:
        assert (tmp_path / "port" / "new" / n).read_bytes() == \
            (src / n).read_bytes() == (tmp_path / "jax" / "new" / n).read_bytes()
    # into an existing directory, as the JAX function
    tms.copy_dir(str(src), str(tmp_path / "port" / "new"))
    assert sorted(os.listdir(tmp_path / "port" / "new")) == names


# --- models/phi ------------------------------------------------------------------
@pytest.mark.parametrize("cfg", [
    {"name": "SIREN", "layers": 4, "features": 16},
    {"name": "SIREN", "layers": 3, "features": 8, "coords_channel": 2},
    {"name": "FFN", "layers": 4, "features": 16, "embsize": 12, "scale": 5},
], ids=["siren", "siren-2d", "ffn"])
def test_param_count_equals_jax(cfg):
    cfg = {"coords_channel": 3, "data_channel": 1, "w0": 20, **cfg}
    jmodel = jphi.init_phi(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = tphi.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                            jparams))
    want = jphi.PhiModel.param_count(jparams)
    assert tphi.PhiModel.param_count(tparams) == want
    assert tphi.init_phi(cfg).param_count(tparams) == want
    assert tphi.get_param_count(tparams) == want


# --- partition/tree ----------------------------------------------------------------
def test_tree_aliases():
    assert ttree.QuadTree is ttree.Tree and ttree.OctTree is ttree.Tree


# --- utils/profiling ----------------------------------------------------------------
def test_throughput_meter_report_equals_jax(monkeypatch):
    """The same segments under the same clock give the same report."""
    reports = []
    for prof in (jprof, tprof):
        ticks = iter([10.0, 10.5, 11.0, 13.25, 20.0, 20.125])
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        meter = prof.ThroughputMeter(n_chips=4)
        for coords in (262_144, 1_000_000, 7):
            with meter.measure(coords=coords):
                pass
        monkeypatch.undo()
        assert meter.segments == 3 and meter.total_coords == 1_262_151
        reports.append(meter.report())
    assert reports[1] == reports[0]
    assert set(reports[1]) == {"coords_per_sec", "coords_per_sec_per_chip",
                               "segments", "seconds"}
    assert reports[1]["seconds"] == 2.875


def test_throughput_meter_empty_and_default():
    j, t = jprof.ThroughputMeter(), tprof.ThroughputMeter()
    assert t.report() == j.report()
    assert t.coords_per_sec == 0.0 and t.n_chips == 1


def test_annotate_range_in_the_trace(tmp_path):
    """The range shows up by name in the port's trace.json, around the
    operations run inside it."""
    logdir = tmp_path / "profile"
    with tprof.trace(str(logdir)):
        with tprof.annotate("brief_annotated_range"):
            (torch.ones(256) * 3).sum()
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "brief_annotated_range"]
    assert spans and all(e.get("ph") == "X" for e in spans)
    t0, t1 = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    inside = [e for e in events if str(e.get("name", "")).startswith("aten::")
              and t0 <= e.get("ts", -1) <= t1]
    assert inside


# --- parallel/block_trainer: progress_cb -------------------------------------------------
FLEET_CC = """
sampler: {name: randompoint, cube_count: 1, cube_len: [1000,1000,1000],
          sample_size: 512, gpu_force: true}
loss: {name: datal2, beta: 0.01, weight: [none], weight_thres: 0}
half: false
coords_mode: "-1,1"
optimizer_name_phi: Adamax
lr_phi: 0.001
lr_scheduler_phi: {name: none}
max_steps: 60
"""
SOLO_CC = FLEET_CC.replace("lr_phi: 0.001", "lr_phi: 0.01").replace(
    "max_steps: 60", "max_steps: 30")
# the solo block (max_steps 30 of the fleet's 60) has taken round(1 / 2) = 0
# steps at checkpoint 1: NaN there
CHECKPOINTS = [1, 20, 60]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fleet(init, cfg):
    """Three 8^3 blocks of SIREN 4 x 12; the first trains solo under its
    own config, so that block order differs from last_losses' order
    (buckets first, then solo blocks)."""
    rng = np.random.default_rng(0)
    vols = [rng.uniform(0, 1, (8, 8, 8, 1)).astype(np.float32)
            for _ in range(3)]
    mk = lambda: init({"name": "SIREN", "coords_channel": 3,
                       "data_channel": 1, "features": 12, "layers": 4,
                       "w0": 20, "res": False})
    blocks = [{"name": f"b{i}", "data_norm": v, "weight": np.ones_like(v),
               "model": mk(), "sideinfos": {}, "weight_thres_norm": 0.0}
              for i, v in enumerate(vols)]
    blocks[0]["solo_cfg"] = cfg.loads(SOLO_CC)
    return blocks


def test_progress_cb_every_block_in_block_order(one_thread):
    trainer = tbt.BlockFleetTrainer(seed=7, device="cpu")
    calls = []

    def progress(step, losses):
        calls.append((step, np.array(losses),
                      [np.array(x) for x in trainer.last_losses]))

    got = trainer.train(_fleet(tinit, tcfg), tcfg.loads(FLEET_CC), 60,
                        checkpoints=CHECKPOINTS, progress_cb=progress)
    assert [c[0] for c in calls] == CHECKPOINTS
    (st,) = trainer._states
    assert st.block_idxs == [1, 2] and trainer.solo_blocks() == [0]
    for step, losses, last in calls:
        assert losses.shape == (3,) and losses.dtype.kind == "f"
        want = np.full(3, np.nan)
        want[st.block_idxs] = last[0]
        if step == 1:
            assert len(last) == 1          # the solo block has not started
        else:
            want[0] = last[1][0]
        np.testing.assert_array_equal(losses, want)
        assert np.isnan(losses[0]) == (step == 1)
        assert np.isfinite(losses[1:]).all()

    plain = tbt.BlockFleetTrainer(seed=7, device="cpu").train(
        _fleet(tinit, tcfg), tcfg.loads(FLEET_CC), 60,
        checkpoints=CHECKPOINTS)
    for a, b in zip(got, plain):
        for la, lb in zip(a["params"]["layers"], b["params"]["layers"]):
            for k in ("w", "b"):
                assert la[k].numpy().tobytes() == lb[k].numpy().tobytes()


def test_progress_cb_shape_and_gaps_equal_jax(one_thread):
    """The JAX package's hook on the same fleet: as many calls, at the same
    steps, of the same length, NaN at the same places."""
    seen = {}
    for name, bt, cfg, init in (("jax", jbt, jcfg, jinit),
                                ("torch", tbt, tcfg, tinit)):
        kw = {} if name == "jax" else {"device": "cpu"}
        calls = []
        bt.BlockFleetTrainer(seed=7, **kw).train(
            _fleet(init, cfg), cfg.loads(FLEET_CC), 60,
            checkpoints=CHECKPOINTS,
            progress_cb=lambda s, l: calls.append((s, np.isnan(l).tolist())))
        seen[name] = calls
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0] == (1, [True, False, False])
