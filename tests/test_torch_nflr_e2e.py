"""The port's NFLR frameworks end to end on the CPU: train, compress,
decompress, eval_performance, the five serialization formats, resume.

  * every ALLCF framework trains through train() (its last step saves the
    module, evaluates and writes performance.csv with the JAX package's
    columns) and compresses two 16^3 volumes, whose decode from memory
    equals the decode from the file;
  * torchsave / torchsave_wo_new_zipfile written by either package load in
    the other to the same arrays; the port's numpysave / numpysave_7z /
    torchsave_7z round trip;
  * a run preempted right after its training state at step 2 and resumed
    ends byte for byte as the uninterrupted 4-step run: the trained
    module, every trainstate.npz leaf.

Sizes: tests/test_nflr.py's (SIREN 4 x 16, y_channel 8, ps 8, ol 2).
"""
import os
import shutil

import numpy as np
import pytest
import torch

from brief_pytorch_tpu_torch.nflr.framework import (PERFORMANCE_COLUMNS,
                                                    init_compressframework)
from torch_nflr_common import NAMES, opt_yaml, port_opt, write_volumes


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    return write_volumes(tmp_path_factory.mktemp("nflr_e2e"), 2)


def _dirs(tmp_path, volumes):
    train_dir, val_dir = tmp_path / "train", tmp_path / "val"
    train_dir.mkdir()
    val_dir.mkdir()
    for p in volumes:
        shutil.copy(p, train_dir)
    shutil.copy(volumes[0], val_dir)
    return str(train_dir), str(val_dir)


@pytest.mark.parametrize("name", NAMES)
def test_train_compress_decompress(name, volumes, tmp_path):
    opt = port_opt(name)
    opt.Train.train_data_dir, opt.Train.val_data_dir = _dirs(tmp_path,
                                                             volumes)
    opt.Train.max_steps = 2
    fw = init_compressframework(opt, device="cpu")
    fw.train(str(tmp_path / "run"))
    trained = os.listdir(tmp_path / "run" / "trained_module")
    assert any(f.endswith("step_2.pt") for f in trained)
    evald = tmp_path / "run" / "eval_results" / "epoch_0_step_2"
    with open(evald / "performance.csv") as f:
        header = f.readline().strip().split(",")
    assert header == [""] + PERFORMANCE_COLUMNS
    comp = str(tmp_path / "c.bin")
    compressed = fw.compress(volumes, comp)
    dec_mem = fw.decompress(compressed_data=compressed)
    dec_file = fw.decompress(compressed_data_path=comp)
    assert dec_mem.shape == (2, 1, 16, 16, 16) and dec_mem.dtype == np.uint16
    np.testing.assert_array_equal(dec_mem, dec_file)
    if "Coding" in name:
        assert all(isinstance(s, bytes) for s in compressed["y_strings"])
        assert 0 < os.path.getsize(comp) < 16 ** 3 * 2 * 2
    else:
        assert compressed["y"].shape == (2, 8, 3, 3, 3)


def test_eval_performance_rows(volumes, tmp_path):
    from brief_pytorch_tpu_torch.nflr.framework import eval_performance
    fw = init_compressframework(port_opt("NFLR_Coding_AutoDecoder"),
                                device="cpu")
    table = eval_performance([[volumes[0]], [volumes[1]]], fw,
                             str(tmp_path / "ev"), keep_data=False)
    psnr = np.asarray(table["psnr"], np.float64)
    ratio = np.asarray(table["compress_ratio"], np.float64)
    assert psnr.shape == (2,) and np.isfinite(psnr).all()
    assert (ratio > 1).all()
    assert sorted(os.listdir(tmp_path / "ev")) == ["performance.csv"]


@pytest.mark.parametrize("method", ["torchsave", "torchsave_wo_new_zipfile"])
def test_torchsave_crosses_the_packages(method, tmp_path):
    import jax
    from brief_pytorch_tpu.core import config as jcfg
    from brief_pytorch_tpu.nflr.framework import init_compressframework as J
    name = "NFLR_Coding_Hyper_AutoEncoder"
    jfw = J(jcfg.loads(opt_yaml(name)))
    pfw = init_compressframework(port_opt(name), device="cpu")
    jpath, ppath = str(tmp_path / "j.pt"), str(tmp_path / "p.pt")
    jfw.save_module(jpath, method)
    pfw.load_module(jpath, method)
    ref = jax.tree_util.tree_leaves(jfw._state_dict())
    from brief_pytorch_tpu_torch.core.tree import tree_leaves_sorted
    got = tree_leaves_sorted(pfw._state_dict())
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    pfw.save_module(ppath, method)
    jfw2 = J(jcfg.loads(opt_yaml(name)))
    jfw2.load_module(ppath, method)
    for a, b in zip(jax.tree_util.tree_leaves(jfw2._state_dict()), ref):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("method", ["torchsave", "torchsave_7z",
                                    "numpysave", "numpysave_7z"])
def test_save_load_round_trip(method, tmp_path):
    from brief_pytorch_tpu_torch.core.tree import tree_leaves_sorted
    fw = init_compressframework(port_opt("NFLR_Coding_AutoDecoder"),
                                device="cpu")
    path = str(tmp_path / f"m_{method}")
    assert fw.save_module(path, method) > 0
    fw2 = init_compressframework(port_opt("NFLR_Coding_AutoDecoder"),
                                 device="cpu")
    for p in tree_leaves_sorted(fw2.params):
        p.zero_()
    fw2.load_module(path, method)
    a, b = tree_leaves_sorted(fw.params), tree_leaves_sorted(fw2.params)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


class _Preempted(Exception):
    pass


def test_resume_is_bitwise(volumes, tmp_path, monkeypatch):
    """Hyper auto-decoder, 4 steps, a state every 2: preempted right after
    the state at step 2 and resumed = the uninterrupted run, byte for
    byte (the trained module at step 4 and every trainstate leaf)."""
    from brief_pytorch_tpu_torch.train import checkpoint as ckpt
    name = "NFLR_Coding_Hyper_AutoDecoder"
    train_dir, val_dir = _dirs(tmp_path, volumes)

    def opt():
        o = port_opt(name, sga_steps=2)
        o.Train.train_data_dir, o.Train.val_data_dir = train_dir, val_dir
        o.Train.max_steps = 4
        o.Train.state_every_n_step = 2
        return o

    init_compressframework(opt(), device="cpu").train(str(tmp_path / "B"))
    write = ckpt.atomic_savez

    def preempting(path, arrs):
        write(path, arrs)
        raise _Preempted

    monkeypatch.setattr(ckpt, "atomic_savez", preempting)
    with pytest.raises(_Preempted):
        init_compressframework(opt(), device="cpu").train(
            str(tmp_path / "A"))
    monkeypatch.setattr(ckpt, "atomic_savez", write)
    with np.load(tmp_path / "A" / "trainstate.npz") as z:
        assert int(z["step"]) == 2
    o = opt()
    o.Train.resume = str(tmp_path / "A")
    init_compressframework(o, device="cpu").train(str(tmp_path / "A"))
    mods = ["trained_module/epoch_0_step_4.pt"]
    for m in mods:
        with open(tmp_path / "A" / m, "rb") as f, \
                open(tmp_path / "B" / m, "rb") as g:
            assert f.read() == g.read()
    with np.load(tmp_path / "A" / "trainstate.npz") as za, \
            np.load(tmp_path / "B" / "trainstate.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k])
    # another config's state is refused
    o = opt()
    o.Train.lr_module = 0.5
    o.Train.resume = str(tmp_path / "A")
    with pytest.raises(ValueError, match="different"):
        init_compressframework(o, device="cpu").train(str(tmp_path / "C"))


def test_framework_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_compressframework(port_opt("NFLR_AutoDecoder"))


def test_rd_script_on_the_host(volumes, tmp_path):
    """scripts/nflr_rd_torch.py end to end on the CPU at a tiny width: an
    RD point whose two decodes are equal, with its speed and backend."""
    import json
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "scripts"))
    import nflr_rd_torch
    out = tmp_path / "rd"
    res = nflr_rd_torch.main([
        "--variant", "NFLR_Coding_Hyper_AutoDecoder", "--steps", "3",
        "--sga-steps", "2", "--features", "8", "--layers", "3",
        "--y-channel", "8", "--argmin-steps", "1", "--volume", volumes[0],
        "--device", "cpu", "--out", str(out)])
    assert res["bits_roundtrip_equal"] and res["platform"] == "cpu"
    assert res["rans_backend"] in ("native", "python")
    assert res["steps"] == 3 and res["steps_per_s"] > 0
    with open(out / "results.jsonl") as f:
        assert json.loads(f.readline())["file_bytes"] == res["file_bytes"]
