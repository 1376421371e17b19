"""DivideTask blocks whose `exception` overrides step-level parameters, in
the port (brief_pytorch_tpu_torch) against the JAX package, on the CPU.

Such a block carries its merged Compress node (`solo_cfg`) and trains on
the fleet's solo path with it (reference main.py:568-569).  Checked: the
per-chunk budgets and widths the exception gives equal JAX's (exact:
sizing is pure Python); the solo block's step at each checkpoint is the
proportional target round(fleet_step * its max_steps / the fleet's),
equal to JAX's; its trained weights equal, bit for bit, the port's own
single-volume step run standalone under the merged config with the
fleet's seeds (tests/test_divide_runner.py:132-240 is the oracle); a
fleet with a solo config resumes to the uninterrupted run's weights, bit
for bit, and refuses a state of another solo config.
"""
import os

import numpy as np
import pytest
import torch
import yaml

from brief_pytorch_tpu.core import config as jcfg
from brief_pytorch_tpu.models.phi import init_phi as jinit
from brief_pytorch_tpu.parallel import block_trainer as jbt
from brief_pytorch_tpu_torch.core import config as tcfg
from brief_pytorch_tpu_torch.models.phi import init_phi as tinit
from brief_pytorch_tpu_torch.parallel import block_trainer as tbt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BRAIN64 = os.path.join(ROOT, "opt", "DivideTask", "brain64.yaml")
BASE_CC = """
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
SOLO_CC = BASE_CC.replace("lr_phi: 0.001", "lr_phi: 0.01").replace(
    "max_steps: 60", "max_steps: 30")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small CPU training steps: one intra-op thread, so that they do
    not contend with the other test processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blocks(init, cfg, solo_text=SOLO_CC):
    """Two 8^3 blocks of SIREN 4 x 12, the second with its own config
    (the JAX oracle's fleet)."""
    rng = np.random.default_rng(0)
    vols = [rng.uniform(0, 1, (8, 8, 8, 1)).astype(np.float32)
            for _ in range(2)]
    mk = lambda: init({"name": "SIREN", "coords_channel": 3,
                       "data_channel": 1, "features": 12, "layers": 4,
                       "w0": 20, "res": False})
    return [{"name": "b0", "data_norm": vols[0],
             "weight": np.ones_like(vols[0]), "model": mk(), "sideinfos": {},
             "weight_thres_norm": 0.0},
            {"name": "b1", "data_norm": vols[1],
             "weight": np.ones_like(vols[1]), "model": mk(), "sideinfos": {},
             "weight_thres_norm": 0.0, "solo_cfg": cfg.loads(solo_text)}]


def test_solo_checkpoint_targets_equal_jax():
    """At fleet checkpoints 20, 45, 60 of 60 the solo block (max_steps 30)
    has taken round(step * 30 / 60) steps: 10, 22, 30, as in JAX."""
    seen = {}
    for name, bt, cfg, init in (("jax", jbt, jcfg, jinit),
                                ("torch", tbt, tcfg, tinit)):
        kw = {} if name == "jax" else {"device": "cpu"}
        trainer = bt.BlockFleetTrainer(seed=7, **kw)
        steps = []
        trainer.train(_blocks(init, cfg), cfg.loads(BASE_CC), 60,
                      checkpoints=[20, 45, 60],
                      checkpoint_cb=lambda s, b, p: steps.append(
                          trainer._solo[0].steps_done))
        seen[name] = steps
        assert len(trainer._solo) == 1 and len(trainer._states) == 1
    assert seen["torch"] == seen["jax"] == [10, 22, 30]


def test_solo_weights_equal_a_standalone_run():
    """The solo block's weights after the fleet's 60 steps equal, bit for
    bit, 30 steps of the single-volume trainer's step under its merged
    config (lr 0.01) with the fleet's seeds for block 1, and differ from
    the fleet-trained block's."""
    from brief_pytorch_tpu_torch.train.fit import NFGR
    from brief_pytorch_tpu_torch.train.optim import make_optimizer
    from brief_pytorch_tpu_torch.train.samplers import RandomPointSampler
    blocks = _blocks(tinit, tcfg)
    trainer = tbt.BlockFleetTrainer(seed=7, device="cpu")
    trainer.train(blocks, tcfg.loads(BASE_CC), 60, checkpoints=[60])
    assert trainer._solo[0].steps_done == 30
    assert not trainer._solo[0].fused

    solo = tcfg.loads(SOLO_CC)
    model = blocks[1]["model"]
    params = model.init(tbt._block_generator(7, 1))
    opt = make_optimizer("Adamax", 0.01, solo.lr_scheduler_phi)
    opt_state = opt.init(params)
    gen = torch.Generator().manual_seed((7 + 1) * 100003 + 1)
    sampler = RandomPointSampler((8, 8, 8), "-1,1", 512)
    data = torch.from_numpy(blocks[1]["data_norm"].reshape(-1, 1))
    for _ in range(30):
        _, grads = NFGR._autograd_step(
            params, gen, model=model, sampler=sampler, data=data,
            weight=None, loss_name="datal2", beta=0.01, weight_thres=0.0)
        opt.step(params, grads, opt_state)
    got = blocks[1]["params"]["layers"]
    for lw, lg in zip(params["layers"], got):
        for k in ("w", "b"):
            assert torch.equal(lw[k], lg[k])
    assert not torch.equal(got[0]["w"], blocks[0]["params"]["layers"][0]["w"])


def test_divide_exception_budgets_and_widths_equal_jax(tmp_path):
    """brain64.yaml with one chunk's exception overriding lr_phi,
    max_steps and its budget, 10 steps in both packages: the same chunk
    names and side information (features included), the exception's
    chunk on the solo path (trained to its own 5 steps)."""
    from brief_pytorch_tpu.parallel.divide_runner import compress_divide
    from brief_pytorch_tpu.utils.logger import MyLogger
    from brief_pytorch_tpu_torch.cli import main as tcli
    name = "d_0_31-h_0_31-w_32_63"
    runs = {}
    for pkg in ("torch", "jax"):
        with open(BRAIN64) as f:
            opt = yaml.safe_load(f)
        opt["Dataset"]["data_path"] = os.path.join(
            ROOT, opt["Dataset"]["data_path"])
        opt["Log"].update(outputs_dir=str(tmp_path), project_name=pkg,
                          tensorboard=False, time=False, stdlog=False)
        c = opt["CompressFramework"]
        c["Compress"].update(max_steps=10, checkpoints="none")
        c["Compress"]["sampler"]["sample_size"] = 2048
        c["Compress"]["divide"]["exception"] = {name: {"Compress": {
            "lr_phi": 0.0005, "max_steps": 5,
            "param": {"given_size": 6000, "filesize_ratio": 0}}}}
        c["Decompress"]["mip"] = False
        path = str(tmp_path / f"{pkg}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(opt, f)
        if pkg == "torch":
            runs[pkg] = tcli.main(["-p", path, "-g", "cpu"])
        else:
            o = jcfg.load(path)
            runs[pkg] = compress_divide(o, MyLogger(**o.Log.to_plain()))
    side = {}
    for pkg in runs:
        d = tmp_path / pkg / "steps10" / "compressed" / "sideinfos"
        side[pkg] = {n: yaml.safe_load(open(d / n / "sideinfos.yaml"))
                     for n in sorted(os.listdir(d))}
    assert side["torch"] == side["jax"] and len(side["torch"]) == 8
    others = [s["phi_features"] for n, s in side["torch"].items()
              if n != name]
    assert side["torch"][name]["phi_features"] > max(others)
    assert runs["torch"]["solo"] == [1]
    assert np.isfinite(runs["torch"]["psnr"])


def test_fleet_with_a_solo_config_resumes_bitwise(tmp_path):
    """Preempted right after its state at step 30 of 60, the fleet resumes
    to weights equal bit for bit to the uninterrupted run's, its solo
    block from its own step 15; a state whose solo config has another lr
    raises ValueError naming the difference."""
    state = str(tmp_path / "trainstate_fleet.npz")

    class Preempted(Exception):
        pass

    save = tbt.BlockFleetTrainer._save_state

    def preempting(self, path, step, fp):
        save(self, path, step, fp)
        if step == 30:
            raise Preempted

    tbt.BlockFleetTrainer._save_state = preempting
    try:
        with pytest.raises(Preempted):
            tbt.BlockFleetTrainer(seed=7, device="cpu").train(
                _blocks(tinit, tcfg), tcfg.loads(BASE_CC), 60,
                checkpoints=[30, 60], state_path=state)
    finally:
        tbt.BlockFleetTrainer._save_state = save
    with np.load(state) as z:
        assert int(z["step"]) == 30 and int(z["s0done"]) == 15
    resumed = tbt.BlockFleetTrainer(seed=7, device="cpu").train(
        _blocks(tinit, tcfg), tcfg.loads(BASE_CC), 60, checkpoints=[30, 60],
        resume_path=state)
    whole = tbt.BlockFleetTrainer(seed=7, device="cpu").train(
        _blocks(tinit, tcfg), tcfg.loads(BASE_CC), 60, checkpoints=[30, 60])
    for a, b in zip(resumed, whole):
        for la, lb in zip(a["params"]["layers"], b["params"]["layers"]):
            for k in ("w", "b"):
                assert torch.equal(la[k], lb[k])
    other = SOLO_CC.replace("lr_phi: 0.01", "lr_phi: 0.02")
    with pytest.raises(ValueError, match="different"):
        tbt.BlockFleetTrainer(seed=7, device="cpu").train(
            _blocks(tinit, tcfg, other), tcfg.loads(BASE_CC), 60,
            checkpoints=[30, 60], resume_path=state)
