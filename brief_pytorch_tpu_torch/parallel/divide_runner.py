"""DivideTask orchestration: partition a large volume into blocks, train one
INR per block — all blocks of a bucket at once on the card — then merge.

Torch port of brief_pytorch_tpu/parallel/divide_runner.py (reference
NFGR.compress_divide, main.py:509-651).  The reference writes every chunk
to disk and runs one child process per chunk; here the fleet trains in
this process (parallel/block_trainer.py), while every on-disk artifact
keeps the reference layout so the deblock tools, the merged-module readers
and the JAX package's NFGR.decompress_divide read it:

  <logdir>/steps{N}/compressed/sideinfos.yaml           (orig volume info)
  <logdir>/steps{N}/compressed/sideinfos/<chunk>/sideinfos.yaml
  <logdir>/steps{N}/compressed/module/<chunk>/module/{weight-*,bias-*}
      (+ encoder.npz for FFN chunks; params.npz alone for MFN chunks)
  <logdir>/steps{N}/decompressed/... , mip/..., performance.csv
  <logdir>/divide.<ext>                                  (boundary viz)
  <logdir>/trainstate_fleet.npz                          (training state)

Compress.resume (a state file or the stopped run's dir) continues a run.
A chunk whose `exception` overrides step-level parameters (sampler,
max_steps, lr, optimizer, schedule, loss, half, coords_mode) carries its
merged Compress node as `solo_cfg` and trains on the fleet's solo path
with it, as the reference's child process did (main.py:568-569).  Under
Compress.raw_gather each block of an integer volume keeps its raw chunk
(`data_raw`) and the affine (`dequant`) that gives its normalized values,
so the fleet stacks the raw dtype (JAX divide_runner.py:171-185).  2-D
images partition into h_*-w_* chunks.

On several ranks (a process group, parallel/mesh.py) every rank runs
compress_divide alike and trains its share of the fleet; every rank
reaches each checkpoint in lockstep (the fleet's parameters and decode
are gathered), and rank 0 alone touches the filesystem: the artifacts,
the merge, the metrics and the training state (JAX
divide_runner.py:219-240).
"""
from __future__ import annotations

import logging
import os
import time
from os.path import basename as opb
from os.path import join as opj
from os.path import splitext as ops
from typing import Dict, List

import numpy as np

from brief_pytorch_tpu_torch.core import config as cfglib
from brief_pytorch_tpu_torch.core.device import DeviceLike
from brief_pytorch_tpu_torch.core.normalize import (invnormalize_data,
                                                    normalize_data)
from brief_pytorch_tpu_torch.eval.metrics import eval_performance, mip_ops
from brief_pytorch_tpu_torch.io.image import (get_folder_size, read_img,
                                              save_img)
from brief_pytorch_tpu_torch.io.modelsave import load_model, save_phi_module
from brief_pytorch_tpu_torch.models import sizing
from brief_pytorch_tpu_torch.models.phi import init_phi
from brief_pytorch_tpu_torch.parallel import mesh
from brief_pytorch_tpu_torch.parallel.block_trainer import (
    BlockFleetTrainer, step_config)
from brief_pytorch_tpu_torch.partition.divide import (alloc_param,
                                                      cal_divide_num,
                                                      chunk_name,
                                                      divide_data,
                                                      merge_divided_data)
from brief_pytorch_tpu_torch.post.preprocess import (parse_checkpoints,
                                                     parse_weight, preprocess)
from brief_pytorch_tpu_torch.train.fit import raw_dequant


def divide(cf_opt, data: np.ndarray, param_size: float):
    """Dispatch on divide_type (reference NFGR.divide, main.py:484-507).
    Returns (chunks, boundary-drawn volume)."""
    shape = data.shape
    divide_type = cf_opt.Compress.divide.divide_type
    if "adaptive" in divide_type:
        Nb = int(divide_type.split("_")[-1])
        if Nb < 8:
            logging.warning("The number of blocks is less than 8!")
            divide_type = f"adaptotal_-1_-1_-1_{Nb}"
            cf_opt.Compress.divide.divide_type = divide_type
        else:
            return _adaptive_chunks(param_size, divide_type, data)
    if "adaptotal" in divide_type:
        _, d_num, h_num, w_num, Nb = divide_type.split("_")
        d_num, h_num, w_num, Nb = int(d_num), int(h_num), int(w_num), int(Nb)
        if len(shape) == 3:
            if h_num == -1 or w_num == -1:
                d_num, h_num, w_num = cal_divide_num(1, shape[0], shape[1],
                                                     Nb, param_size)
        elif len(shape) == 4:
            if -1 in (d_num, h_num, w_num):
                d_num, h_num, w_num = cal_divide_num(shape[0], shape[1],
                                                     shape[2], Nb, param_size)
        return divide_data(data, f"total_{d_num}_{h_num}_{w_num}")
    if "every" in divide_type or "total" in divide_type:
        return divide_data(data, divide_type)
    raise NotImplementedError(divide_type)


def _adaptive_chunks(param_size: float, divide_type: str, data: np.ndarray):
    """adaptive_maxl_minl_varthr_ethr_Nb (reference main.py:456-482)."""
    from brief_pytorch_tpu_torch.partition.tree import adaptive_cal_tree
    _, maxl, minl, var_thr, e_thr, Nb = divide_type.split("_")
    tree, save_data, dimension = adaptive_cal_tree(
        data, param_size, var_thr=int(var_thr), e_thr=int(e_thr),
        maxl=int(maxl), minl=int(minl), Nb=int(Nb))
    chunks = []
    for p in tree.get_active():
        if dimension == 3:
            info = {"data": data[p.z:p.z + p.d, p.y:p.y + p.h, p.x:p.x + p.w],
                    "d": [p.z, p.z + p.d - 1], "h": [p.y, p.y + p.h - 1],
                    "w": [p.x, p.x + p.w - 1]}
        else:
            info = {"data": data[p.y:p.y + p.h, p.x:p.x + p.w],
                    "h": [p.y, p.y + p.h - 1], "w": [p.x, p.x + p.w - 1]}
        info["name"] = chunk_name(info)
        info["total_size"] = data.size
        info["size"] = info["data"].size
        chunks.append(info)
    return chunks, save_data


def prepare_blocks(cf_opt, chunks: List[Dict]) -> List[Dict]:
    """What each reference child process did on its own chunk: loss
    weights, normalisation, network sizing, the normalized threshold."""
    exception_opt = cf_opt.Compress.divide.exception
    if exception_opt == "none" or exception_opt is None:
        exception_opt = {}
    blocks: List[Dict] = []
    for chunk in chunks:
        blk = dict(chunk)
        blk_opt = cf_opt
        if chunk["name"] in exception_opt:
            blk_opt = cfglib.merge(cf_opt, dict(exception_opt[chunk["name"]]))
            if step_config(blk_opt.Compress) != step_config(cf_opt.Compress):
                # the reference's child trains with its own merged config:
                # the block trains on the fleet's solo path with it
                blk["solo_cfg"] = blk_opt.Compress
        chunk_pre = chunk["data"]
        blk["weight"] = parse_weight(chunk_pre, blk_opt.Compress.loss.weight)
        data_norm, side = normalize_data(chunk_pre, **blk_opt.Normalize)
        blk["data_norm"] = data_norm
        if np.issubdtype(chunk_pre.dtype, np.integer) and \
                bool(blk_opt.Compress.get("raw_gather", False)):
            dequant = raw_dequant(str(blk_opt.Normalize.name), side)
            if dequant is not None:
                blk["dequant"] = dequant
                blk["data_raw"] = chunk_pre
        given = blk_opt.Compress.param.given_size
        budget = float(given) if chunk["name"] in exception_opt and given > 0 \
            else chunk["param_size"]
        phi_cfg = dict(blk_opt.Module.phi)
        features, _, theory = sizing.estimate_module_size(
            budget, phi_cfg, bool(blk_opt.Compress.half))
        phi_cfg["features"] = features
        blk["model"] = init_phi(phi_cfg)
        init_net = blk_opt.Compress.param.get("init_net_path", "none")
        if init_net and init_net != "none":  # per-block warm start
            blk["init_layers"] = load_model(init_net)
        blk["theory_module_size"] = theory
        blk["sideinfos"] = {**side, "data_shape": list(data_norm.shape),
                            "phi_features": features,
                            "phi_name": phi_cfg["name"]}
        tn, _ = normalize_data(
            np.array(blk_opt.Compress.loss.weight_thres, np.float32),
            **blk_opt.Normalize, min=side["min"], max=side["max"])
        blk["weight_thres_norm"] = float(tn)
        blocks.append(blk)
    return blocks


def param_budget(cc, data_path: str) -> float:
    """The byte budget: Compress.param.given_size, or the file's size over
    filesize_ratio (reference main.py:199-207)."""
    given = cc.param.given_size
    return float(given) if given > 0 else \
        os.path.getsize(data_path) / cc.param.filesize_ratio


def plan_blocks(cf_opt, data_pre: np.ndarray, param_size: float):
    """Partition the preprocessed volume, split the budget and prepare the
    blocks: (number of chunks before allocation, blocks, the boundary
    visualisation)."""
    chunks, divide_img = divide(cf_opt, data_pre, param_size)
    n_chunks = len(chunks)
    div = cf_opt.Compress.divide
    chunks = alloc_param(chunks, param_size, div.param_alloc,
                         div.param_size_thres)
    return n_chunks, prepare_blocks(cf_opt, chunks), divide_img


def compress_divide(opt, log, device: DeviceLike = None) -> Dict:
    """Full DivideTask pipeline.  opt: the SingleTask root config; log: the
    run's logger (None: write nothing); device: None (the CUDA card),
    'cpu', or a torch device.  Returns a summary of the last checkpoint
    with train_s / checkpoint_s (host seconds) and every block's last
    loss; on ranks other than 0 (which write nothing) without the
    checkpoint's files and metrics."""
    if not mesh.is_main():
        log = None
    cf_opt = opt.CompressFramework
    cc = cf_opt.Compress
    data_path = opt.Dataset.data_path
    data = read_img(data_path)
    phi = cf_opt.Module.phi
    if data.ndim != phi.coords_channel + 1 or \
            data.shape[-1] != phi.data_channel:
        raise ValueError(f"data shape {data.shape} inconsistent with the "
                         f"network's {phi.coords_channel} coordinates and "
                         f"{phi.data_channel} channels")
    orig_sideinfos = {"data_shape": list(data.shape)}

    pre = cc.preprocess
    data_pre = preprocess(data.copy(), pre.denoise.level, pre.denoise.close,
                          pre.clip)
    ext = ops(data_path)[-1]
    if log is not None:
        save_img(opj(log.logdir, opb(ops(data_path)[0]) + "_preprocessed"
                     + ext), data_pre)

    n_chunks, blocks, divide_img = plan_blocks(
        cf_opt, data_pre, param_budget(cc, data_path))
    if log is not None:
        save_img(opj(log.logdir, "divide" + ext), divide_img)
    orig_sideinfos["chunks_numbers"] = n_chunks

    max_steps = int(cc.max_steps)
    checkpoints = parse_checkpoints(cc.checkpoints, max_steps)
    orig_bytes = os.path.getsize(data_path)
    trainer = BlockFleetTrainer(seed=int(opt.Reproduc.seed), device=device)
    summary: Dict = {"checkpoint_s": 0.0}

    def on_checkpoint(step, blks, per_block_params):
        t0 = time.perf_counter()
        if log is None:     # another rank writes; the decode is collective
            if cc.decompress:
                trainer.decode(blks, cc)
            return
        step_dir = opj(log.logdir, f"steps{step}")
        compressed = opj(step_dir, "compressed")
        module_dir = opj(compressed, "module")
        side_dir = opj(compressed, "sideinfos")
        os.makedirs(compressed, exist_ok=True)
        cfglib.save(orig_sideinfos, opj(compressed, "sideinfos.yaml"))
        for blk, params in zip(blks, per_block_params):
            csd = opj(side_dir, blk["name"])
            os.makedirs(csd, exist_ok=True)
            cfglib.save(blk["sideinfos"], opj(csd, "sideinfos.yaml"))
            cmd = opj(module_dir, blk["name"], "module")
            os.makedirs(os.path.dirname(cmd), exist_ok=True)
            save_phi_module(blk["model"], params, cmd)
        actual = get_folder_size(compressed)
        theory = (get_folder_size(side_dir)
                  + sum(b["theory_module_size"] for b in blks))
        ratios = {"compress_ratio/theory": orig_bytes / theory,
                  "compress_ratio/actual": orig_bytes / actual}
        log.log_metrics(ratios, step)
        summary.update({"steps": step, **ratios})

        if cc.decompress:
            decoded = trainer.decode(blks, cc)
            merged_chunks = []
            post = cf_opt.Decompress.postprocess
            for blk, dec_norm in zip(blks, decoded):
                dec = invnormalize_data(dec_norm, blk["sideinfos"],
                                        **cf_opt.Normalize)
                dec = preprocess(dec, post.denoise.level, post.denoise.close,
                                 post.clip)
                mc = {"data": dec, "h": blk["h"], "w": blk["w"]}
                if "d" in blk:
                    mc["d"] = blk["d"]
                merged_chunks.append(mc)
            merged = merge_divided_data(merged_chunks, data.shape)
            if cf_opt.Decompress.keep_decompressed:
                dd = opj(step_dir, "decompressed")
                os.makedirs(dd, exist_ok=True)
                save_img(opj(dd, opb(ops(data_path)[0]) + "_decompressed"
                             + ops(data_path)[-1]), merged)
            if cf_opt.Decompress.mip and data.ndim == 4:
                md = opj(step_dir, "mip")
                os.makedirs(md, exist_ok=True)
                stem, ext = opb(ops(data_path)[0]), ops(data_path)[-1]
                mip_ops(data, md, stem, ext)
                mip_ops(merged, md, stem + "_decompressed", ext)
            perf = eval_performance(step, data, merged, log,
                                    cf_opt.Decompress.mse,
                                    cf_opt.Decompress.psnr,
                                    cf_opt.Decompress.ssim,
                                    device=trainer.device)
            log.append_csv_row(opj(log.logdir, "performance.csv"), perf)
            summary.update(perf)
        summary["checkpoint_s"] += time.perf_counter() - t0

    # the fleet's state lands beside the artifacts at every checkpoint, and
    # Compress.resume continues a stopped run from it (JAX
    # divide_runner.py:285-292)
    resume = str(cc.get("resume", "none") or "none")
    trainer.train(blocks, cc, max_steps, checkpoint_cb=on_checkpoint,
                  checkpoints=checkpoints,
                  state_path=None if log is None else
                  opj(log.logdir, "trainstate_fleet.npz"),
                  resume_path=None if resume == "none" else resume)
    summary.update(train_s=trainer.train_s, fused=trainer.fused_paths(),
                   fleet=trainer.fleet_stats(), solo=trainer.solo_blocks(),
                   losses=trainer.block_losses())
    if log is not None:
        log.close()
    return summary
