"""The DivideTask fleet across ranks (parallel/mesh.py, block_trainer.py,
divide_runner.py, the CLI's -coordinator/-nprocs/-procid and its local
launcher): gloo ranks on the host, one interpreter each.

Case for case as tests/test_multihost.py does for the JAX package, with
its tolerances: the 2-rank fleet against the 1-rank fleet (losses atol
1e-5, parameter sums rtol 1e-5, decode sums rtol 1e-4), compress_divide
end to end (rank 0 writes, rank 1 does not), the CLI's flags and
launcher, fleet resume byte for byte on 2 and on 4 ranks with uneven
buckets.  Also the placement plan, the launcher's watch over its ranks,
and one build when several ranks start together.
"""
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from brief_pytorch_tpu_torch.cli import main as cli
from brief_pytorch_tpu_torch.core import config as tcfg
from brief_pytorch_tpu_torch.io.image import read_img
from brief_pytorch_tpu_torch.ops import build
from brief_pytorch_tpu_torch.parallel import mesh
from brief_pytorch_tpu_torch.parallel.block_trainer import BlockFleetTrainer
from brief_pytorch_tpu_torch.parallel.divide_runner import compress_divide
from brief_pytorch_tpu_torch.utils.logger import MyLogger

from torch_ranks import lines, run_ranks

CC = """
sampler: {name: randompoint, cube_count: 1, cube_len: [8,8,8],
          sample_size: 128, gpu_force: true, vector_len: 4}
loss: {name: datal2, beta: 0.01, weight: [none], weight_thres: 0}
half: false
coords_mode: "-1,1"
optimizer_name_phi: Adamax
lr_phi: 0.001
lr_scheduler_phi: {name: none}
"""

# the fleets of the tests, built alike on every rank and in this process
BLOCKS = '''
from brief_pytorch_tpu_torch.core.tree import tree_leaves
from brief_pytorch_tpu_torch.models.phi import init_phi


def siren(f, layers=4):
    return {"name": "SIREN", "coords_channel": 3, "data_channel": 1,
            "features": f, "layers": layers, "w0": 20, "res": False}


def build_blocks(kind):
    rng = np.random.default_rng(0)
    if kind == "two":           # one bucket of two widths
        cfgs = [siren(10), siren(14)]
    elif kind == "solo":        # + an MFN solo block
        cfgs = [siren(10), siren(14),
                {"name": "MFNGabor", "coords_channel": 3, "data_channel": 1,
                 "features": 8, "layers": 4}]
    else:                       # a 2-block bucket, a 5-block one, a solo
        cfgs = [siren(10), siren(14)] + \\
            [siren(10 + 2 * i, 5) for i in range(5)] + \\
            [{"name": "MFNGabor", "coords_channel": 3, "data_channel": 1,
              "features": 8, "layers": 4}]
    blocks = []
    for i, cfg in enumerate(cfgs):
        shp = (8, 6, 8, 1) if kind == "uneven" and i % 2 else (8, 8, 8, 1)
        vol = rng.uniform(0, 1, shp).astype(np.float32)
        blocks.append({"name": f"b{i}", "data_norm": vol,
                       "weight": np.ones_like(vol), "model": init_phi(cfg),
                       "sideinfos": {}, "weight_thres_norm": 0.0})
    return blocks


def sums(blocks):
    return [float(sum(np.abs(t.numpy()).sum()
                      for t in tree_leaves(b["params"]))) for b in blocks]
'''
exec(BLOCKS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Training in this process beside the ranks' processes: one intra-op
    thread, so that they do not contend with each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _floats(text):
    return np.asarray([float(x) for x in text.split(",")])


def _fleet(kind, steps=30, checkpoints=(30,)):
    trainer = BlockFleetTrainer(seed=3, device="cpu")
    blocks = trainer.train(build_blocks(kind), tcfg.loads(CC), steps,
                           checkpoints=list(checkpoints))
    return trainer, blocks


WORKER_FLEET = BLOCKS + """
from brief_pytorch_tpu_torch.core import config as tcfg
from brief_pytorch_tpu_torch.parallel.block_trainer import BlockFleetTrainer
cc = tcfg.loads(ARGS[0])
trainer = BlockFleetTrainer(seed=3, device="cpu")
blocks = trainer.train(build_blocks(ARGS[1]), cc, 30, checkpoints=[30])
print("LOSSES", ",".join(repr(x) for x in trainer.block_losses()))
print("SUMS", ",".join(repr(x) for x in sums(blocks)))
print("DEC", ",".join(repr(float(np.abs(d).sum()))
                      for d in trainer.decode(blocks, cc)))
print("OWN", [st.own_idxs for st in trainer._states],
      [ss.block_idx for ss in trainer._solo])
"""


@pytest.mark.parametrize("kind", ["two", "solo"])
def test_two_rank_fleet_matches_one_rank(kind):
    """The fleet on 2 ranks, one block of the bucket each (and the MFN
    block solo on rank 0): every rank's per-block last losses, parameter
    sums and decode sums equal the 1-rank fleet's within the JAX package's
    tolerances (tests/test_multihost.py:373-383)."""
    trainer, blocks = _fleet(kind)
    want_l = np.asarray(trainer.block_losses())
    want_s = np.asarray(sums(blocks))
    want_d = np.asarray([float(np.abs(d).sum())
                         for d in trainer.decode(blocks, tcfg.loads(CC))])
    outs = run_ranks(WORKER_FLEET, 2, CC, kind)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(_floats(lines(out, "LOSSES")[0]), want_l,
                                   atol=1e-5, err_msg=f"rank {r} losses")
        np.testing.assert_allclose(_floats(lines(out, "SUMS")[0]), want_s,
                                   rtol=1e-5, err_msg=f"rank {r} params")
        np.testing.assert_allclose(_floats(lines(out, "DEC")[0]), want_d,
                                   rtol=1e-4, err_msg=f"rank {r} decode")
    assert lines(outs[0], "OWN")[0].startswith("[[0]]")
    assert lines(outs[1], "OWN")[0] == "[[1]] []"


def _divide_yaml(data_path, out, project="mh"):
    return f"""
Reproduc: {{seed: 42, benchmark: false, deterministic: true}}
Dataset: {{data_path: "{data_path}"}}
Log: {{outputs_dir: "{out}", project_name: {project}, stdlog: false,
      tensorboard: false, time: false}}
CompressFramework:
  Name: NFGR
  Compress:
    divide: {{divide_type: total_2_2_2, param_alloc: by_size,
             param_size_thres: 26, exception: none}}
    half: false
    sampler: {{name: randompoint, cube_count: 1,
              cube_len: [10000000,10000000,10000000], sample_size: 1024,
              gpu_force: true}}
    coords_mode: "-1,1"
    preprocess:
      denoise: {{level: 0, close: [2,2,2]}}
      clip: [0, 65535]
    param: {{init_net_path: none, filesize_ratio: 80, given_size: 0}}
    loss: {{name: datal2, beta: 0.01, weight: [none], weight_thres: 0}}
    gpu: true
    max_steps: 40
    checkpoints: none
    loss_log_freq: 20
    lr_phi: 0.001
    optimizer_name_phi: Adamax
    lr_scheduler_phi: {{name: none}}
    decompress: true
  Decompress:
    sample_size: 4096
    gpu: true
    postprocess:
      denoise: {{level: 0, close: [2,2,2]}}
      clip: [0, 65535]
    keep_decompressed: true
    mip: false
    mse: true
    psnr: true
    ssim: false
  Module:
    phi: {{name: SIREN, coords_channel: 3, data_channel: 1, layers: 4,
          w0: 20, output_act: false, res: false}}
  Normalize: {{name: minmaxany_0_100}}
"""


def _decompressed(logdir, data_path):
    return read_img(os.path.join(
        logdir, "steps40", "decompressed",
        os.path.basename(data_path).replace(".tif", "_decompressed.tif")))


def _modules(logdir):
    return sorted(os.listdir(os.path.join(logdir, "steps40", "compressed",
                                          "module")))


@pytest.fixture(scope="module")
def one_rank_divide(tmp_path_factory, brain64_path):
    """compress_divide of brain64 (total_2_2_2, 40 steps) on one rank."""
    tmp = tmp_path_factory.mktemp("divide1")
    opt = tcfg.loads(_divide_yaml(brain64_path, tmp))
    log = MyLogger(**opt.Log.to_plain())
    summary = compress_divide(opt, log, device="cpu")
    return summary, _decompressed(log.logdir, brain64_path)


WORKER_DIVIDE = """
from brief_pytorch_tpu_torch.core import config as tcfg
from brief_pytorch_tpu_torch.parallel.divide_runner import compress_divide
from brief_pytorch_tpu_torch.utils.logger import MyLogger
opt = tcfg.load(ARGS[0])
opt.Log.outputs_dir = f"{ARGS[1]}/rank{RANK}"   # only rank 0 writes steps
log = MyLogger(**opt.Log.to_plain())
res = compress_divide(opt, log, device="cpu")
print("LOGDIR", log.logdir)
print("PSNR", res.get("psnr", -1))
print("LOSSES", ",".join(repr(x) for x in res["losses"]))
"""


def test_two_rank_compress_divide_end_to_end(tmp_path, brain64_path,
                                             one_rank_divide):
    """The whole DivideTask pipeline on 2 ranks: rank 0 writes the 8
    chunk dirs and the merged volume (within 1 LSB of the 1-rank run's),
    rank 1 writes none; both return every block's last loss."""
    y = tmp_path / "divide.yaml"
    y.write_text(_divide_yaml(brain64_path, tmp_path))
    outs = run_ranks(WORKER_DIVIDE, 2, y, tmp_path)
    logdir0 = lines(outs[0], "LOGDIR")[0]
    mods = _modules(logdir0)
    assert len(mods) == 8 and all(m.startswith("d_") for m in mods)
    got = _decompressed(logdir0, brain64_path)
    want = one_rank_divide[1]
    assert got.shape == want.shape
    assert np.max(np.abs(got.astype(np.int64) - want.astype(np.int64))) <= 1
    assert float(lines(outs[0], "PSNR")[0]) > 15
    logdir1 = lines(outs[1], "LOGDIR")[0]
    assert os.listdir(logdir1) == ["script"]      # the logger's own dir
    np.testing.assert_allclose(_floats(lines(outs[1], "LOSSES")[0]),
                               one_rank_divide[0]["losses"], atol=1e-5)


WORKER_CLI = """
from brief_pytorch_tpu_torch.cli.main import main
res = main(["-p", ARGS[RANK], "-coordinator", COORD, "-nprocs", str(WORLD),
            "-procid", str(RANK), "-g", "cpu"])
assert not mesh.world() > 1     # the CLI left the group it joined
print("PSNR", res.get("psnr", float("nan")))
"""


@pytest.mark.parametrize("how", ["flags", "launcher"])
def test_two_rank_cli_divide(tmp_path, brain64_path, how, monkeypatch):
    """DivideTask through the CLI on 2 ranks: each process with
    -coordinator -nprocs -procid (its own yaml and outputs dir), or the
    CLI's own launcher for `-g cpu,cpu`; rank 0 alone writes its run."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # the launcher's ranks'
    monkeypatch.setenv("PYTHONPATH", "")
    yamls = []
    for r in range(2):
        y = tmp_path / f"divide_p{r}.yaml"
        y.write_text(_divide_yaml(brain64_path, tmp_path / f"rank{r}",
                                  "clidist"))
        yamls.append(str(y))
    if how == "flags":
        outs = run_ranks(WORKER_CLI, 2, *yamls, join=False)
        psnr = float(lines(outs[0], "PSNR")[0])
    else:
        psnr = cli.main(["-p", yamls[0], "-g", "cpu,cpu"])["psnr"]
    assert psnr > 15.0, psnr
    assert len(_modules(tmp_path / "rank0" / "clidist")) == 8
    assert not (tmp_path / "rank1").exists() if how == "launcher" else \
        not (tmp_path / "rank1" / "clidist" / "steps40").exists()


WORKER_RESUME = BLOCKS + """
from brief_pytorch_tpu_torch.core import config as tcfg
from brief_pytorch_tpu_torch.parallel.block_trainer import BlockFleetTrainer
cc = tcfg.loads(ARGS[0])
kind, state = ARGS[1], f"{ARGS[2]}/fleet_state.npz"
# A: stopped at 15, its state written by rank 0
BlockFleetTrainer(seed=3, device="cpu").train(
    build_blocks(kind), cc, 30, checkpoints=[15], state_path=state)
# B: uninterrupted; C: resumed from A's state
bb = BlockFleetTrainer(seed=3, device="cpu").train(
    build_blocks(kind), cc, 30, checkpoints=[15, 30])
bc = BlockFleetTrainer(seed=3, device="cpu").train(
    build_blocks(kind), cc, 30, checkpoints=[15, 30], resume_path=state)
for b, c in zip(bb, bc):
    lb, lc = tree_leaves(b["params"]), tree_leaves(c["params"])
    assert len(lb) == len(lc) > 0
    for x, y in zip(lb, lc):
        assert torch.equal(x, y), b["name"]
print("SUMS", ",".join(repr(x) for x in sums(bb)))
"""


@pytest.mark.parametrize("kind,n", [("solo", 2), ("uneven", 4)])
def test_fleet_resume_across_ranks(tmp_path, kind, n):
    """Fleet checkpoint and resume across n ranks: the state gathers every
    rank's rows and solo blocks to rank 0, every rank reads its own back,
    and the resumed fleet is bit for bit the uninterrupted one.  The 4-rank
    case (a 2-block bucket smaller than the ranks, a 5-block bucket not
    divisible by them, an MFN solo block, blocks of two shapes) checks
    that every rank ends with the same parameters of every block, within
    the JAX tolerance of the 1-rank fleet."""
    outs = run_ranks(WORKER_RESUME, n, CC, kind, tmp_path)
    got = [lines(o, "SUMS")[0] for o in outs]
    assert len(set(got)) == 1, got
    _, blocks = _fleet(kind, 30, (15, 30))
    np.testing.assert_allclose(_floats(got[0]), sums(blocks), rtol=1e-5)
    with np.load(tmp_path / "fleet_state.npz") as z:
        assert int(z["step"]) == 15 and "s0done" in z.files


def test_plan_places_every_block_once():
    """plan_fleet: a bucket of at least as many blocks as ranks splits
    evenly in contiguous runs; smaller buckets take disjoint ranks, packed
    first-fit-decreasing, a new wave when none fits; solo blocks go
    round-robin; one rank takes everything."""
    buckets, solo = mesh.plan_fleet([5, 2, 1, 3, 2], 3, 4)
    assert buckets[0] == [0, 0, 1, 2, 3]
    assert buckets[3] == [0, 1, 2]           # the largest small bucket first
    assert buckets[2] == [3]                 # fills the first wave
    assert buckets[1] == [0, 1] and buckets[4] == [2, 3]   # a second wave
    assert solo == [0, 1, 2]
    for sizes, n in (([4], 2), ([7, 3], 3), ([2, 2, 2], 4)):
        plans, _ = mesh.plan_fleet(sizes, 0, n)
        for size, ranks in zip(sizes, plans):
            assert len(ranks) == size and all(0 <= r < n for r in ranks)
            if size >= n:
                counts = np.bincount(ranks, minlength=n)
                assert counts.max() - counts.min() <= 1
            else:
                assert len(set(ranks)) == size
    assert mesh.plan_fleet([3, 1], 2, 1) == ([[0, 0, 0], [0]], [0, 0])


def test_wait_ranks_stops_the_others_when_one_fails():
    """A rank that exits non-zero fails the run at once and the ranks
    still running are killed, instead of waiting on them."""
    procs = [subprocess.Popen([sys.executable, "-c",
                               "import time; time.sleep(60)"]),
             subprocess.Popen([sys.executable, "-c",
                               "import sys; sys.exit(3)"])]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 exited with code 3"):
        mesh.wait_ranks(procs, timeout=50)
    assert time.monotonic() - t0 < 30
    assert all(p.poll() is not None for p in procs)


def test_multihost_init_checks_its_flags(monkeypatch):
    """An explicit coordinator needs both other flags and a rank in range;
    without one and without torchrun's WORLD_SIZE there is no group."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="-nprocs"):
        mesh.multihost_init("127.0.0.1:1", None, 0)
    with pytest.raises(ValueError, match="-procid 2"):
        mesh.multihost_init("127.0.0.1:1", 2, 2)
    assert mesh.multihost_init() is False and mesh.world() == 1


def test_concurrent_builds_compile_once(tmp_path, monkeypatch):
    """Two build() calls at once on a stale library (ranks that start
    together): the build lock lets one compile, the other finds the fresh
    library; one valid file, no temporary left.  A stand-in compiler
    records its runs."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("// a source\n")
    runs = tmp_path / "runs.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n" + f"""
import sys, time
open({str(runs)!r}, "a").write("run\\n")
time.sleep(1.0)
with open(sys.argv[sys.argv.index("-o") + 1], "w") as f:
    f.write("library")
""")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD", out)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    errors = []

    def one():
        try:
            build.build(["fake"])
        except Exception as e:       # surfaced by the assert below
            errors.append(e)
    threads = [threading.Thread(target=one) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    assert runs.read_text() == "run\n"
    assert (out / "libfake.so").read_text() == "library"
    assert sorted(p.name for p in out.iterdir()
                  if not p.name.startswith(".")) == ["libfake.so"]


def test_free_port_is_below_the_ephemeral_range():
    """mesh.free_port draws coordinator ports below the kernel's ephemeral
    range, so that no other process's bind to port 0 or outgoing
    connection takes one between the draw and rank 0's bind (the cause of
    test_two_rank_fleet_matches_one_rank's failures under six test
    workers); each port it returns binds."""
    import socket
    low = mesh._ephemeral_low()
    ports = {mesh.free_port() for _ in range(20)}
    for port in ports:
        if low is not None:
            assert low - mesh.PORT_SPAN <= port < low
        with socket.socket() as s:
            s.bind(("127.0.0.1", port))
    assert len(ports) > 1
