"""The port's MultiTask (brief_pytorch_tpu_torch/sched/multitask.py,
cli/multitask.py) against the JAX package's on the CPU: the PRODUCT /
CONCAT combinators give the same dotlists, gen_task_list on
opt/MultiTask/default.yaml gives the same per-experiment configs, and an
end-to-end run of both experiments (DivideTask total_2_2_2 and SingleTask)
at a few steps writes the same tree of files as the JAX package's run.
temp_opt_<project>/ is removed afterwards, also when a task raises.

Size: the yaml's 64^3 fixture, 12 steps (checkpoints every 6) and 512
samples a step, as in the yaml otherwise.
"""
import logging
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from brief_pytorch_tpu.sched import multitask as jmt
from brief_pytorch_tpu_torch.core import config as tcfg
from brief_pytorch_tpu_torch.sched import multitask as tmt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT = os.path.join(ROOT, "opt", "MultiTask", "default.yaml")
FIXTURE = os.path.join(ROOT, "dataset", "brain", "64x64x64",
                       "brain-64_128-64_128-192_256.tif")
STEPS = 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small CPU training steps: one intra-op thread, so that they do
    not contend with the other test processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

COMBOS = [
    {"a.b": 1, "c": "x"},
    {"CONCAT": [{"a": 1}, {"a": 2, "b": 3}]},
    {"PRODUCT": [{"a": 1}, {"CONCAT": [{"b": 1}, {"b": 2}]}]},
    {"PRODUCT": [{"CONCAT": [{"x": 1}, {"x": 2}]},
                 {"CONCAT": [{"y": "u"}, {"y": "v"}]}]},
    {"PRODUCT": [{"CONCAT": [{"x": 1}, {"PRODUCT": [{"y": 2},
                                                    {"z": [1, 2]}]}]},
                 {"w": 0.001}]},
]


@pytest.mark.parametrize("tree", COMBOS, ids=range(len(COMBOS)))
def test_combinators_give_the_jax_dotlists(tree):
    assert tmt.dict2dotlist_list(tree) == jmt.dict2dotlist_list(tree)


def _copy_yaml(src, dst_dir, **edits):
    """The yaml copied into dst_dir (temp_opt_* lands beside it), Static
    keys set from `edits` ('Log.outputs_dir': ...)."""
    os.makedirs(dst_dir, exist_ok=True)
    opt = tcfg.load(src)
    for key, value in edits.items():
        opt.Static.set_path(key, value)
    path = os.path.join(dst_dir, os.path.basename(src))
    tcfg.save(opt, path)
    return path


def test_gen_task_list_matches_jax_on_the_default_yaml(tmp_path):
    tpath = _copy_yaml(DEFAULT, str(tmp_path / "port"))
    jpath = _copy_yaml(DEFAULT, str(tmp_path / "jax"))
    ttasks, tdir = tmt.gen_task_list(tpath, device="cpu")
    jtasks, jdir = jmt.gen_task_list(jpath)
    assert [t.name for t in ttasks] == [t.name for t in jtasks] == \
        ["exp_000", "exp_001"]
    assert [(t.gpucost, t.cpucost) for t in ttasks] == \
        [(t.gpucost, t.cpucost) for t in jtasks] == [(20000, 20000)] * 2
    assert os.path.basename(tdir) == os.path.basename(jdir) == \
        "temp_opt_multi"
    for name in ("exp_000.yaml", "exp_001.yaml"):
        got = tcfg.load(os.path.join(tdir, name)).to_plain()
        want = tcfg.load(os.path.join(jdir, name)).to_plain()
        assert got == want and "Source" not in got
    kinds = [tcfg.load(os.path.join(tdir, n)).CompressFramework.Compress
             for n in ("exp_000.yaml", "exp_001.yaml")]
    assert [k.divide.divide_type for k in kinds] == ["total_2_2_2", "none"]
    assert {k.max_steps for k in kinds} == {2000}
    assert all(callable(t.command) for t in ttasks)
    sub, _ = tmt.gen_task_list(tpath, use_subprocess=True)
    assert sub[0].command.startswith(
        f"{sys.executable} -m brief_pytorch_tpu_torch.cli.main -p ")


def _small_yaml(dst_dir):
    """The yaml with the fixture's absolute path, the outputs in dst_dir
    and STEPS steps."""
    path = _copy_yaml(DEFAULT, dst_dir, **{
        "Dataset.data_path": FIXTURE,
        "Log.outputs_dir": os.path.join(dst_dir, "outputs"),
        "Log.time": False,
        "CompressFramework.Compress.checkpoints": "every_6",
        "CompressFramework.Compress.sampler.sample_size": 512,
    })
    opt = tcfg.load(path)
    cat = opt.Dynamic[0].PRODUCT[0].CONCAT[0]
    cat["Dataset.data_path"] = FIXTURE
    cat["CompressFramework.Compress.max_steps"] = STEPS
    tcfg.save(opt, path)
    return path


def _tree(root):
    out = set()
    for d, _, files in os.walk(root):
        for f in files:
            out.add(os.path.relpath(os.path.join(d, f), root))
    return out


def test_end_to_end_writes_the_jax_tree(tmp_path):
    """Both experiments run in-process to `finish` in each package and
    write the same files (names relative to the outputs dir), each with a
    performance.csv row of a finite PSNR; temp_opt_multi/ is gone."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    runs = {}
    for tag, mt in (("port", tmt), ("jax", jmt)):
        path = _small_yaml(str(tmp_path / tag))
        kw = {"device": "cpu"} if tag == "port" else {}
        queue = mt.run_multitask(path, **kw)
        assert [t.status for t in queue.task_list] == ["finish"] * 2
        assert not os.path.exists(tmp_path / tag / "temp_opt_multi")
        runs[tag] = _tree(tmp_path / tag / "outputs")
    assert runs["port"] == runs["jax"]
    for project in ("multi_divided", "multi_single"):
        rows = open(tmp_path / "port" / "outputs" / project /
                    "performance.csv").read().strip().splitlines()
        assert len(rows) == 3 and rows[0].startswith("steps")
        psnr = float(rows[-1].split(",")[rows[0].split(",").index("psnr")])
        assert np.isfinite(psnr)


def test_temp_dir_removed_when_a_task_raises(tmp_path, caplog):
    path = _copy_yaml(DEFAULT, str(tmp_path), **{
        "Dataset.data_path": str(tmp_path / "missing.tif"),
        "Log.outputs_dir": str(tmp_path / "outputs")})
    opt = tcfg.load(path)
    opt.Dynamic[0].PRODUCT[0].CONCAT[0]["Dataset.data_path"] = \
        str(tmp_path / "missing.tif")
    tcfg.save(opt, path)
    with caplog.at_level(logging.WARNING):
        queue = tmt.run_multitask(path, max_task=2, device="cpu")
    assert "one at a time" in caplog.text
    assert len(queue.error_list) == 2 and not queue.finish_list
    assert all(t.ets == 4 for t in queue.error_list)   # 1 + 3 retries
    assert not os.path.exists(tmp_path / "temp_opt_multi")


def test_multitask_cli_in_a_subprocess(tmp_path):
    """python -m brief_pytorch_tpu_torch.cli.multitask -p <yaml> -g cpu
    prints the status table with both experiments finished."""
    path = _small_yaml(str(tmp_path))
    p = subprocess.run([sys.executable, "-m",
                        "brief_pytorch_tpu_torch.cli.multitask", "-p", path,
                        "-g", "cpu"], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    rows = [l.split() for l in p.stdout.strip().splitlines()[-2:]]
    assert rows == [["exp_000", "finish", "0"], ["exp_001", "finish", "0"]]
    assert sorted(os.listdir(tmp_path / "outputs")) == \
        ["multi_divided", "multi_single"]
    shutil.rmtree(tmp_path / "outputs")
