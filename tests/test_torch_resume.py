"""Resume of the port (brief_pytorch_tpu_torch/train/checkpoint.py,
NFGR.compress, BlockFleetTrainer.train, the CLI's -resume) on the CPU.

The invariant is the JAX package's (tests/test_resume.py): a run stopped
at a checkpoint and resumed is bitwise equal to an uninterrupted run with
the same checkpoint grid: parameters, Adamax moments, the schedule's
count (a MultiStepLR milestone lies after the stop) and the sampler
generator all round-trip.  A state written under another config raises
ValueError.  The state file's p{i} leaves have the names and shapes that
the JAX package's pack_tree gives for the same config.

Sizes: a 16^3 volume, SIREN 3 x 16, 20 + 20 steps; the fleet of
tests/test_resume.py (two SIREN buckets widths 8 and 12, NeRF, MFNGabor
on the solo path) on 5^3 blocks, 4 + 4 steps.
"""
import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from brief_pytorch_tpu_torch.core import config as tcfg
from brief_pytorch_tpu_torch.io.image import save_img
from brief_pytorch_tpu_torch.models.phi import init_phi as tinit
from brief_pytorch_tpu_torch.parallel import block_trainer as tbt
from brief_pytorch_tpu_torch.train import checkpoint as ckpt
from brief_pytorch_tpu_torch.train.fit import NFGR
from brief_pytorch_tpu_torch.utils.logger import MyLogger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = 16
SAMPLERS = {
    "randompoint": {"name": "randompoint", "sample_size": 1024},
    "randomcube": {"name": "randomcube", "cube_len": [8, 8, 8]},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small CPU training steps: one intra-op thread, so that they do
    not contend with the other test processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    rng = np.random.default_rng(0)
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, 16)] * 3, indexing="ij")
    vol = 20000 + 15000 * np.sin(3 * x) * np.cos(2 * y) + 8000 * z \
        + rng.normal(0, 500, x.shape)
    path = str(tmp_path_factory.mktemp("resume") / "vol16.tif")
    save_img(path, np.clip(vol, 0, 65535).astype(np.uint16)[..., None])
    return path


def _opt(data_path, outdir, sampler="randompoint", max_steps=40,
         checkpoints="every_20", lr=0.001):
    opt = tcfg.load(os.path.join(ROOT, "opt", "SingleTask", "default.yaml"))
    opt.Dataset.data_path = data_path
    opt.Log.update(outputs_dir=str(outdir), project_name="r", stdlog=False,
                   tensorboard=False, time=False)
    c = opt.CompressFramework.Compress
    c.max_steps = max_steps
    c.checkpoints = checkpoints
    c.lr_phi = lr
    c.lr_scheduler_phi = {"name": "MultiStepLR", "milestones": [30],
                          "gamma": 0.2}
    for k, v in SAMPLERS[sampler].items():
        c.sampler[k] = v
    c.param.filesize_ratio = 0
    c.param.given_size = 4 * (3 * F + F + F * F + F + F + 1)
    opt.CompressFramework.Module.phi.layers = 3
    opt.CompressFramework.Decompress.mip = False
    return opt


def _single(opt, resume="none"):
    o = copy.deepcopy(opt)
    o.CompressFramework.Compress.resume = resume
    log = MyLogger(**o.Log.to_plain())
    cf = NFGR(o.CompressFramework, logger=log, seed=42, device="cpu")
    cf.compress(o.Dataset.data_path)
    return cf, log.logdir


def _module_bytes(logdir, step):
    module = os.path.join(logdir, f"steps{step}", "compressed", "module")
    return {name: open(os.path.join(module, name), "rb").read()
            for name in sorted(os.listdir(module))}


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_single_resume_is_bitwise(volume, tmp_path, sampler):
    # A: stopped at 20, its state in its run dir
    _, dir_a = _single(_opt(volume, tmp_path / "a", sampler, 20))
    assert os.path.isfile(os.path.join(dir_a, "trainstate.npz"))
    # B: the uninterrupted 40 steps on the same checkpoint grid
    cf_b, dir_b = _single(_opt(volume, tmp_path / "b", sampler))
    # C: A's run dir resumed to 40
    cf_c, dir_c = _single(_opt(volume, tmp_path / "c", sampler),
                          resume=dir_a)
    leaves_b = ckpt.tree_leaves_sorted(cf_b.params)
    leaves_c = ckpt.tree_leaves_sorted(cf_c.params)
    assert len(leaves_b) == len(leaves_c) == 6
    for b, c in zip(leaves_b, leaves_c):
        assert torch.equal(b, c)
    assert _module_bytes(dir_b, 40) == _module_bytes(dir_c, 40)
    # the resumed run wrote its own state and skipped A's checkpoint
    assert not os.path.isdir(os.path.join(dir_c, "steps20"))
    assert os.path.isdir(os.path.join(dir_c, "steps40"))
    with np.load(os.path.join(dir_c, "trainstate.npz")) as z:
        assert int(z["step"]) == 40 and int(z["o0"]) == 40


def test_single_resume_fingerprint_mismatch(volume, tmp_path):
    _, dir_a = _single(_opt(volume, tmp_path / "a", max_steps=20))
    with pytest.raises(ValueError, match="different"):
        _single(_opt(volume, tmp_path / "c", lr=5e-4), resume=dir_a)


def test_unpack_tree_names_a_leaf_of_another_shape():
    z = {"p0": np.zeros((3,), np.float32), "p1": np.zeros((2, 3), np.float32)}
    like = {"layers": [{"w": torch.zeros(2, 4), "b": torch.zeros(4)}]}
    with pytest.raises(ValueError, match="p0"):
        ckpt.unpack_tree(z, "p", like, "params")
    with pytest.raises(ValueError, match="no leaf p2"):
        ckpt.unpack_tree(z, "p", {"a": torch.zeros(3), "b": torch.zeros(2, 3),
                                  "c": torch.zeros(1)})


def test_generator_state_of_another_device_raises():
    """A CUDA generator's state (16 bytes) never goes into a CPU
    generator (5056), and the other way round."""
    gen = torch.Generator().manual_seed(1)
    with pytest.raises(ValueError, match="key"):
        ckpt.unpack_generator({"key": np.zeros(16, np.uint8)}, "key", gen)
    state = {"key": torch.Generator().manual_seed(7).get_state().numpy()}
    ckpt.unpack_generator(state, "key", gen)
    assert torch.equal(gen.get_state(), torch.from_numpy(state["key"]))


@pytest.mark.parametrize("cfg", [
    {"name": "SIREN", "features": 16, "layers": 3, "w0": 20},
    {"name": "FFN", "features": 16, "layers": 3, "embsize": 8, "scale": 10},
    {"name": "NeRF", "features": 8, "layers": 4, "frequencies": 3,
     "skip": True},
    {"name": "MFNGabor", "features": 8, "layers": 4},
], ids=lambda c: c["name"])
def test_state_leaves_are_jax_pack_tree_names(cfg):
    """The p{i} leaves of a trainstate written by the port have the names
    and shapes of the JAX package's pack_tree on the same config (its
    params tree is jax.tree_util order: dict keys sorted)."""
    import jax
    from brief_pytorch_tpu.models.phi import init_phi as jinit
    from brief_pytorch_tpu.train.checkpoint import pack_tree as jpack
    cfg = {"coords_channel": 3, "data_channel": 1, **cfg}
    want = {}
    jpack(want, "p", jinit(cfg).init(jax.random.PRNGKey(0)))
    got = {}
    ckpt.pack_tree(got, "p", tinit(cfg).init(torch.Generator().manual_seed(0)))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}


# ---------------------------------------------------------------- fleet --
_FLEET_CC = """
sampler: {name: randompoint, cube_count: 1, cube_len: [4,4,4],
          sample_size: 64, gpu_force: true}
loss: {name: datal2, beta: 0.01, weight: [none], weight_thres: 0}
half: false
coords_mode: "-1,1"
optimizer_name_phi: Adamax
lr_phi: 0.001
lr_scheduler_phi: {name: MultiStepLR, milestones: [6], gamma: 0.2}
"""


def _fleet_blocks():
    rng = np.random.default_rng(7)
    cfgs = [
        {"name": "SIREN", "features": 8, "layers": 4, "w0": 20},
        {"name": "SIREN", "features": 12, "layers": 4, "w0": 20},
        {"name": "NeRF", "features": 8, "layers": 4, "frequencies": 3,
         "skip": True},
        {"name": "MFNGabor", "features": 8, "layers": 4},   # the solo path
    ]
    blocks = []
    for i, cfg in enumerate(cfgs):
        vol = rng.uniform(0, 1, (5, 5, 5, 1)).astype(np.float32)
        blocks.append({"name": f"blk{i}", "data_norm": vol,
                       "weight": np.ones_like(vol),
                       "model": tinit({"coords_channel": 3,
                                       "data_channel": 1, **cfg}),
                       "weight_thres_norm": 0.0})
    return blocks


def _fleet(tmp_path, tag, checkpoints, resume=None, lr=None):
    cc = tcfg.loads(_FLEET_CC)
    if lr is not None:
        cc.lr_phi = lr
    trainer = tbt.BlockFleetTrainer(seed=0, device="cpu")
    state = str(tmp_path / f"state_{tag}.npz")
    blocks = trainer.train(_fleet_blocks(), cc, max_steps=8,
                           checkpoints=checkpoints, state_path=state,
                           resume_path=resume)
    return blocks, state, trainer


def test_fleet_resume_is_bitwise(tmp_path):
    _, state_a, trainer_a = _fleet(tmp_path, "a", [4])
    assert trainer_a.solo_blocks() == [3]
    blocks_b, _, _ = _fleet(tmp_path, "b", [4, 8])
    blocks_c, state_c, _ = _fleet(tmp_path, "c", [4, 8], resume=state_a)
    for bb, bc in zip(blocks_b, blocks_c):
        lb = ckpt.tree_leaves_sorted(bb["params"])
        lc = ckpt.tree_leaves_sorted(bc["params"])
        assert len(lb) == len(lc) > 0
        for x, y in zip(lb, lc):
            assert torch.equal(x, y)
    with np.load(state_c) as z:
        assert int(z["step"]) == 8 and int(z["s0done"]) == 8


def test_fleet_resume_fingerprint_mismatch(tmp_path):
    _, state_a, _ = _fleet(tmp_path, "a", [4])
    with pytest.raises(ValueError, match="different"):
        _fleet(tmp_path, "c", [4, 8], resume=state_a, lr=5e-4)


class Preempted(Exception):
    pass


def test_divide_resume_through_the_cli(tmp_path, monkeypatch):
    """A DivideTask run (opt/DivideTask/brain64.yaml cut to 24^3 of the
    fixture: 8 blocks) preempted right after its step-4 state is written,
    resumed through cli.main -resume <run dir>: its step-8 weight
    binaries equal an uninterrupted run's, byte for byte."""
    from brief_pytorch_tpu_torch.cli import main as cli
    from brief_pytorch_tpu_torch.io.image import read_img
    vol = read_img(os.path.join(ROOT, "dataset", "brain", "64x64x64",
                                "brain-64_128-64_128-192_256.tif"))
    data = str(tmp_path / "vol24.tif")
    save_img(data, np.ascontiguousarray(vol[:24, :24, :24]))
    opt = tcfg.load(os.path.join(ROOT, "opt", "DivideTask", "brain64.yaml"))
    opt.Dataset.data_path = data
    opt.Log.update(outputs_dir=str(tmp_path), stdlog=False,
                   tensorboard=False, time=False)
    c = opt.CompressFramework
    c.Compress.max_steps = 8
    c.Compress.checkpoints = "every_4"
    c.Decompress.mip = False
    paths = {}
    for tag in ("a", "b", "c"):
        opt.Log.project_name = tag
        paths[tag] = str(tmp_path / f"{tag}.yaml")
        tcfg.save(opt, paths[tag])

    save = tbt.BlockFleetTrainer._save_state

    def preempt_after_4(self, path, step, fingerprint):
        save(self, path, step, fingerprint)
        if step == 4:
            raise Preempted

    with monkeypatch.context() as m:
        m.setattr(tbt.BlockFleetTrainer, "_save_state", preempt_after_4)
        with pytest.raises(Preempted):
            cli.main(["-p", paths["a"], "-g", "cpu"])
    cli.main(["-p", paths["b"], "-g", "cpu"])
    cli.main(["-p", paths["c"], "-g", "cpu", "-resume",
              str(tmp_path / "a")])
    mb = _tree_bytes(tmp_path / "b" / "steps8" / "compressed" / "module")
    mc = _tree_bytes(tmp_path / "c" / "steps8" / "compressed" / "module")
    assert len({k.split(os.sep)[0] for k in mb}) == 8 and mb == mc
    assert not os.path.isdir(tmp_path / "c" / "steps4")


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_cli_resume_in_a_subprocess(volume, tmp_path):
    """python -m brief_pytorch_tpu_torch.cli.main -p <yaml> -g cpu
    -resume <run dir>: run A stops at 20, the same command plus -resume
    continues to 40 and its weight binaries equal the uninterrupted 40
    steps'."""
    def cli(yaml_path, *extra):
        p = subprocess.run(
            [sys.executable, "-m", "brief_pytorch_tpu_torch.cli.main", "-p",
             yaml_path, "-g", "cpu", *extra], capture_output=True,
            text=True, timeout=600, cwd=ROOT)
        assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]

    paths = {}
    for tag, steps in (("a", 20), ("b", 40), ("c", 40)):
        opt = _opt(volume, tmp_path, max_steps=steps)
        opt.Log.project_name = tag
        paths[tag] = str(tmp_path / f"{tag}.yaml")
        tcfg.save(opt, paths[tag])
    cli(paths["a"])
    cli(paths["b"])
    cli(paths["c"], "-resume", str(tmp_path / "a"))
    assert _module_bytes(tmp_path / "b", 40) == \
        _module_bytes(tmp_path / "c", 40)
