"""DivideTask end to end: the port's CLI (brief_pytorch_tpu_torch) against the
JAX package's on opt/DivideTask/brain64.yaml, cut to 40 steps, on the CPU.

The two trainers draw from different generators and initialise from
different seeds' streams, so the runs are held to a quality band, not to
bits: PSNR within 1 dB.  What must agree exactly: the artifact tree (chunk
names, files, weight shapes) and each chunk's side information.  The JAX
package's standalone decompress_divide reads the port's artifacts to
within 1 LSB of the port's own (the kernel route decodes with
axis_linspace coordinates, the slab route with affine ones; ROADMAP.md
Queue 3).
"""
import csv
import os

import numpy as np
import pytest
import torch
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BRAIN64 = os.path.join(ROOT, "opt", "DivideTask", "brain64.yaml")
STEPS = 40


def _config(tmp_path, out: str, config=BRAIN64, **compress):
    with open(config) as f:
        opt = yaml.safe_load(f)
    opt["Dataset"]["data_path"] = os.path.join(ROOT, opt["Dataset"]["data_path"])
    opt["Log"].update(outputs_dir=str(tmp_path / out), tensorboard=False,
                      time=False)
    opt["CompressFramework"]["Compress"].update(max_steps=STEPS,
                                                checkpoints="none", **compress)
    opt["CompressFramework"]["Decompress"]["mip"] = False
    path = str(tmp_path / f"{out}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return path, os.path.join(str(tmp_path / out), opt["Log"]["project_name"])


def _tree(run_dir):
    out = []
    for dirpath, _, files in os.walk(os.path.join(run_dir, f"steps{STEPS}")):
        rel = os.path.relpath(dirpath, run_dir)
        out += [os.path.join(rel, f) for f in files]
    return sorted(out)


def _psnr(run_dir):
    with open(os.path.join(run_dir, "performance.csv")) as f:
        return float(list(csv.DictReader(f))[-1]["psnr"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One port run and one JAX run of brain64.yaml at STEPS steps."""
    from brief_pytorch_tpu.cli import main as jcli
    from brief_pytorch_tpu_torch.cli import main as tcli
    tmp = tmp_path_factory.mktemp("divide")
    tpath, tdir = _config(tmp, "torch")
    jpath, jdir = _config(tmp, "jax")
    tsummary = tcli.main(["-p", tpath, "-g", "cpu"])
    jcli.main(["-p", jpath])
    return tpath, tdir, tsummary, jdir


def test_brain64_artifact_tree_matches_jax(runs):
    tpath, tdir, tsummary, jdir = runs
    tree = _tree(tdir)
    assert tree == _tree(jdir)
    modules = [p for p in tree if "/module/" in p and "weight-0-" in p]
    assert len(modules) == 8
    for rel in ("trainstate_fleet.npz", "divide.tif", "performance.csv",
                "brain-64_128-64_128-192_256_preprocessed.tif"):
        assert os.path.exists(os.path.join(tdir, rel)), rel
    side = os.path.join(f"steps{STEPS}", "compressed", "sideinfos")
    for name in os.listdir(os.path.join(tdir, side)):
        with open(os.path.join(tdir, side, name, "sideinfos.yaml")) as f:
            ts = yaml.safe_load(f)
        with open(os.path.join(jdir, side, name, "sideinfos.yaml")) as f:
            js = yaml.safe_load(f)
        assert ts == js, name
    assert tsummary["steps"] == STEPS and tsummary["fused"] == [False]
    assert tsummary["fleet"][0]["blocks"] == 8


def test_brain64_psnr_within_1db_of_jax(runs):
    _, tdir, tsummary, jdir = runs
    tp, jp = _psnr(tdir), _psnr(jdir)
    assert np.isfinite(tp) and abs(tp - jp) <= 1.0, (tp, jp)
    assert tsummary["psnr"] == tp


def test_jax_decompress_divide_reads_port_artifacts(runs):
    from brief_pytorch_tpu.train.fit import NFGR as JNFGR
    from brief_pytorch_tpu_torch.io.image import read_img
    from brief_pytorch_tpu_torch.train.fit import NFGR
    tpath, tdir, _, _ = runs
    comp = os.path.join(tdir, f"steps{STEPS}", "compressed")
    args = (os.path.join(comp, "sideinfos.yaml"), os.path.join(comp, "module"),
            os.path.join(comp, "sideinfos"))
    ours = NFGR.decompress_divide(tpath, *args, device="cpu")
    theirs = JNFGR.decompress_divide(tpath, *args)
    ck = read_img(os.path.join(tdir, f"steps{STEPS}", "decompressed",
                               "brain-64_128-64_128-192_256_decompressed.tif"))
    assert ours.shape == theirs.shape == ck.shape == (64, 64, 64, 1)
    assert ours.dtype == np.uint16
    for other in (theirs, ck):
        assert np.abs(ours.astype(np.int64) - other.astype(np.int64)).max() \
            <= 1


def test_decompress_divide_skips_stray_entries(runs, tmp_path):
    import shutil
    from brief_pytorch_tpu_torch.train.fit import NFGR
    tpath, tdir, _, _ = runs
    comp = os.path.join(tdir, f"steps{STEPS}", "compressed")
    mod = str(tmp_path / "module")
    shutil.copytree(os.path.join(comp, "module"), mod)
    open(os.path.join(mod, "notes.txt"), "w").close()
    os.makedirs(os.path.join(mod, "backup_old"))
    side = (os.path.join(comp, "sideinfos.yaml"), mod,
            os.path.join(comp, "sideinfos"))
    assert NFGR.decompress_divide(tpath, *side, device="cpu").shape == \
        (64, 64, 64, 1)
    with pytest.raises(FileNotFoundError):
        NFGR.decompress_divide(tpath, side[0], str(tmp_path),
                               side[2], device="cpu")


def test_divide_cli_targets_the_card(tmp_path, monkeypatch):
    from brief_pytorch_tpu_torch.cli import main as tcli
    path, _ = _config(tmp_path, "card")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["-p", path])


@pytest.mark.parametrize("compress,match", [
    ({"resume": "somewhere"}, "resume"),
    ({"raw_gather": True}, "raw_gather"),
    ({"divide": {"divide_type": "total_2_2_2", "param_alloc": "by_size",
                 "param_size_thres": 26,
                 "exception": {"d_0_31-h_0_31-w_0_31": {
                     "Compress": {"lr_phi": 0.01}}}}}, "solo path"),
])
def test_unported_divide_options_raise(tmp_path, compress, match):
    """A resume path that holds no training state raises FileNotFoundError
    before any training.  raw_gather and exceptions that override
    step-level parameters raised here until they were ported; now the run
    honours them: the fleet stacks the raw uint16 chunks, or the
    exception's block trains on the solo path."""
    from brief_pytorch_tpu_torch.cli import main as tcli
    path, _ = _config(tmp_path, "unported", **compress)
    if "resume" in compress:
        with pytest.raises(FileNotFoundError, match=match):
            tcli.main(["-p", path, "-g", "cpu"])
        return
    summary = tcli.main(["-p", path, "-g", "cpu"])
    assert summary["steps"] == STEPS and np.isfinite(summary["psnr"])
    if match == "raw_gather":
        assert [b["data_dtype"] for b in summary["fleet"]] == ["uint16"]
    else:
        assert summary["solo"] == [0] and summary["fleet"][0]["blocks"] == 7


def test_prep_only_exception_is_folded_into_the_block(tmp_path):
    """An exception that changes only a block's budget (not its step-level
    parameters) stays in the fleet, as in the JAX runner."""
    from brief_pytorch_tpu_torch.core import config as cfglib
    from brief_pytorch_tpu_torch.io.image import read_img
    from brief_pytorch_tpu_torch.parallel import divide_runner as dr
    from brief_pytorch_tpu_torch.partition.divide import alloc_param
    opt = cfglib.load(BRAIN64).CompressFramework
    opt.Compress.divide.exception = {
        "d_0_31-h_0_31-w_0_31": {"Compress": {"param": {"given_size": 4000}}}}
    vol = read_img(os.path.join(ROOT, "dataset", "brain", "64x64x64",
                                "brain-64_128-64_128-192_256.tif"))
    chunks, _ = dr.divide(opt, vol, 3e4)
    blocks = dr.prepare_blocks(opt, alloc_param(chunks, 3e4, "by_size", 26))
    feats = {b["name"]: b["sideinfos"]["phi_features"] for b in blocks}
    assert feats["d_0_31-h_0_31-w_0_31"] > feats["d_0_31-h_0_31-w_32_63"]
    assert not any("solo_cfg" in b for b in blocks)


# --- families beyond SIREN through the DivideTask CLI -----------------------
def _phi(opt_path, name, **keys):
    with open(opt_path) as f:
        opt = yaml.safe_load(f)
    opt["CompressFramework"]["Module"]["phi"].update(name=name, **keys)
    with open(opt_path, "w") as f:
        yaml.safe_dump(opt, f)


@pytest.mark.parametrize("name,keys,solo,files", [
    ("MFNFourier", {}, 8, ["params.npz"]),
    ("NeRF", {"frequencies": 2}, 0, None),
    ("FFN", {"embsize": 4}, 0, None),
])
def test_divide_families_archive_and_decode_in_both_packages(
        tmp_path, name, keys, solo, files):
    """brain64.yaml with another φ family, STEPS steps on the CPU: MFN chunks
    train on the solo path and archive as params.npz, NeRF / FFN chunks in
    one stacked autograd bucket as raw binaries (+ encoder.npz); the port's
    and the JAX package's decompress_divide read the archive to within 1
    LSB of each other and of the checkpoint's merged volume."""
    from brief_pytorch_tpu.train.fit import NFGR as JNFGR
    from brief_pytorch_tpu_torch.cli import main as tcli
    from brief_pytorch_tpu_torch.io.image import read_img
    from brief_pytorch_tpu_torch.train.fit import NFGR
    path, run_dir = _config(tmp_path, name)
    _phi(path, name, **keys)
    summary = tcli.main(["-p", path, "-g", "cpu"])
    assert summary["steps"] == STEPS and np.isfinite(summary["psnr"])
    assert len(summary["solo"]) == solo
    assert summary["fused"] == ([] if solo else [False])
    comp = os.path.join(run_dir, f"steps{STEPS}", "compressed")
    chunks = sorted(os.listdir(os.path.join(comp, "module")))
    assert len(chunks) == 8
    for chunk in chunks:
        got = sorted(os.listdir(os.path.join(comp, "module", chunk,
                                             "module")))
        if files is not None:
            assert got == files
        else:
            assert any(f.startswith("weight-0-") for f in got)
            assert ("encoder.npz" in got) == (name == "FFN")
    args = (os.path.join(comp, "sideinfos.yaml"), os.path.join(comp, "module"),
            os.path.join(comp, "sideinfos"))
    ours = NFGR.decompress_divide(path, *args, device="cpu")
    theirs = JNFGR.decompress_divide(path, *args)
    ck = read_img(os.path.join(run_dir, f"steps{STEPS}", "decompressed",
                               "brain-64_128-64_128-192_256_decompressed.tif"))
    assert ours.shape == theirs.shape == ck.shape == (64, 64, 64, 1)
    for other in (theirs, ck):
        assert np.abs(ours.astype(np.int64) - other.astype(np.int64)).max() \
            <= 1
    with np.load(os.path.join(run_dir, "trainstate_fleet.npz")) as z:
        assert ("s7done" in z.files) == bool(solo)
