"""NFGR: overfit one φ-network to one volume — the core compression path.

Torch port of brief_pytorch_tpu/train/fit.py:129-468 (compress) and
533-575 (decompress), reference main.py:164-454.  The JAX package's
on-device scan of training steps becomes a Python loop of steps:

  * each step samples a batch (train/samplers.py), and on a CUDA device
    with a supported chain runs the fused train-step kernel
    (ops/fused_train.py), which returns the loss and the gradients
    directly; otherwise (res / skip / encoder chains, the MFNs, the CPU,
    `half`) autograd through the model's apply gives them.  The gate
    mirrors fit.py:331-336: Compress.fused_train (default true), the chain
    and loss supported, a CUDA device, not `half`.  `half` computes every
    product from bfloat16 inputs and weights with float32 sums and float32
    parameters (models/phi.py compute_dtype) and decodes in bfloat16
    slabs, as JAX fit.py:1-12 does;
  * the optimizer (train/optim.py, optax's rules) updates the parameters
    in place;
  * losses stay on the device until a checkpoint, so the loop never waits
    for the card between steps.

At each checkpoint it writes the reference's artifacts — the module (raw
weight binaries, encoder.npz for FFN, params.npz for the MFNs:
io/modelsave.py) and sideinfos.yaml under steps{N}/compressed/, the decoded
volume, performance.csv — decoding through the fused grid kernel on the
card where it supports the model (train/decode.py), and the atomic
trainstate.npz (train/checkpoint.py); Compress.resume continues a run from
such a state, bitwise equal to an uninterrupted run with the same
checkpoint grid.

The randompoint sampler takes Compress.sampler.vector_len (runs of
consecutive voxels) and Compress.raw_gather (an integer volume kept on
the device in its own dtype, dequantized after each gather; affine
Normalize modes only, JAX fit.py:222-262).  2-D images (coords_channel 2)
and videos (frames as the first axis, data_channel 3) run the same path;
the decompressed file keeps the input's extension.

Compress.data_shards: N > 1 trains one network on N ranks of a process
group (parallel/mesh.py; the CLI starts them), each drawing its part of
the batch from its shard of the volume, the gradients averaged by one
all_reduce a step (parallel/data_parallel.py, JAX fit.py:214-310).  Rank
0 alone writes the artifacts and trainstate.npz, which holds every
rank's generator state.
"""
from __future__ import annotations

import logging
import os
import shutil
import time
from os.path import basename as opb
from os.path import join as opj
from os.path import splitext as ops
from typing import Dict, Optional

import numpy as np
import torch

from brief_pytorch_tpu_torch.core import config as cfglib
from brief_pytorch_tpu_torch.core.device import DeviceLike, resolve_device
from brief_pytorch_tpu_torch.core.normalize import (get_type_max,
                                                    invnormalize_data,
                                                    normalize_data)
from brief_pytorch_tpu_torch.eval.metrics import eval_performance, mip_ops
from brief_pytorch_tpu_torch.io.image import (get_folder_size, read_img,
                                              save_img)
from brief_pytorch_tpu_torch.core.tree import tree_leaves, tree_unflatten
from brief_pytorch_tpu_torch.io.modelsave import (load_model, load_phi_module,
                                                  save_phi_module)
from brief_pytorch_tpu_torch.models import sizing
from brief_pytorch_tpu_torch.models.phi import (get_param_count, init_phi,
                                                params_from_numpy)
from brief_pytorch_tpu_torch.ops import fused_train
from brief_pytorch_tpu_torch.ops.chain import (chain_layer_specs,
                                               make_pre_encode)
from brief_pytorch_tpu_torch.parallel import mesh
from brief_pytorch_tpu_torch.parallel.data_parallel import \
    DataParallelTrainer
from brief_pytorch_tpu_torch.post.preprocess import (parse_checkpoints,
                                                     parse_weight, preprocess)
from brief_pytorch_tpu_torch.train.checkpoint import (load_trainstate,
                                                      resolve_trainstate,
                                                      save_trainstate)
from brief_pytorch_tpu_torch.train.decode import reconstruct_flattened
from brief_pytorch_tpu_torch.train.loss import make_loss
from brief_pytorch_tpu_torch.train.optim import make_optimizer
from brief_pytorch_tpu_torch.train.samplers import (RandomCubeSampler,
                                                    RandomPointSampler,
                                                    cube_size_guard,
                                                    device_raw)


def raw_dequant(normalize_name: str, sideinfos) -> Optional[tuple]:
    """(A, B) with normalized == raw * A + B for an affine Normalize mode
    (minmaxany_a_b, none), else None: Compress.raw_gather's dequantization
    (JAX fit.py:243-252, divide_runner.py:171-185)."""
    if "minmaxany" in normalize_name:
        a, b = (float(x) for x in normalize_name.split("_")[1:])
        A = (b - a) / (float(sideinfos["max"]) - float(sideinfos["min"]))
        return A, a - float(sideinfos["min"]) * A
    if normalize_name == "none":
        return 1.0, 0.0
    return None


class NFGR:
    """Neural-fields global representation compressor
    (reference main.py:164-651)."""

    def __init__(self, opt, logger=None, seed: int = 42,
                 device: DeviceLike = None):
        """opt: the CompressFramework config node (reference schema).
        device: None (the CUDA card), 'cpu', or a torch device."""
        self.opt = opt
        self.half = bool(opt.Compress.half)
        self.data_shards = int(opt.Compress.get("data_shards", 1) or 1)
        if self.data_shards > 1 and mesh.world() != self.data_shards:
            raise ValueError(
                f"Compress.data_shards={self.data_shards} needs a process "
                f"group of {self.data_shards} ranks, not {mesh.world()}: "
                "run the CLI (python -m brief_pytorch_tpu_torch.cli.main, "
                "which starts them), or -coordinator/-nprocs/-procid on "
                "each rank, or set the group up before NFGR")
        self.logger = logger
        self.seed = int(seed)
        self.device = resolve_device(device)

    # ------------------------------------------------------------- sizing --
    def parse_param_size(self, data_path: Optional[str] = None) -> float:
        """Byte budget from given_size XOR filesize_ratio
        (reference main.py:199-207)."""
        given = self.opt.Compress.param.given_size
        ratio = self.opt.Compress.param.filesize_ratio
        if (given > 0 and ratio > 0) or (given == 0 and ratio == 0):
            raise ValueError("There can only be one arg to be used")
        if given > 0:
            return float(given)
        return os.path.getsize(data_path) / ratio

    def prepare_module(self, ideal_module_size: float):
        """Size + build the φ network (reference main.py:248-264)."""
        phi_cfg = self.opt.Module.phi
        features, actual_count, theory_size = sizing.estimate_module_size(
            ideal_module_size, phi_cfg, self.half)
        err = (theory_size - ideal_module_size) / ideal_module_size
        if abs(err) > 0.05:
            logging.warning("Error_rate=%.3f>0.05! ideal=%s theory=%s",
                            err, ideal_module_size, theory_size)
        phi_cfg["features"] = features
        model = init_phi(dict(phi_cfg))
        params = model.init(torch.Generator().manual_seed(self.seed),
                            self.device)
        if get_param_count(params) != actual_count:
            raise RuntimeError("parameter count differs from the sizing")
        return model, params, features, theory_size

    # -------------------------------------------------------------- train --
    def compress(self, data_path: str, stepstore: bool = False) -> Dict:
        """Compress one volume; writes checkpoint artifacts under the logger
        dir.  Returns a summary dict of the last checkpoint."""
        sharded = self.data_shards > 1
        # the ranks of a data-parallel run share one output: rank 0 writes
        log = self.logger if not sharded or mesh.is_main() else None
        dev = self.device
        cfg = self.opt.Compress
        data = read_img(data_path)

        # sampler size guard (reference main.py:325-334)
        cube_len = list(cfg.sampler.cube_len)
        cube_voxels = int(np.prod([min(c, s) for c, s in
                                   zip(cube_len, data.shape[:-1])]))
        cfg.sampler.name = cube_size_guard(cfg.sampler.name, data.size,
                                           cube_voxels)

        # preprocess + per-voxel weights
        pre = cfg.preprocess
        data_pre = preprocess(data.copy(), pre.denoise.level,
                              pre.denoise.close, pre.clip)
        if log is not None:
            save_img(opj(log.logdir, opb(ops(data_path)[0]) + "_preprocessed"
                         + ops(data_path)[-1]), data_pre)
        weight = parse_weight(data_pre, cfg.loss.weight)
        data_norm, sideinfos = normalize_data(data_pre, **self.opt.Normalize)

        # module sizing (+ optional warm start, reference main.py:345-354)
        ideal = self.parse_param_size(data_path)
        model, params, features, theory_size = self.prepare_module(ideal)
        init_net = cfg.param.get("init_net_path", "none")
        if init_net and init_net != "none":
            params = {**params, **params_from_numpy(load_model(init_net),
                                                    dev)}
        sideinfos = {**sideinfos,
                     "data_shape": list(data_norm.shape),
                     "phi_features": features,
                     "phi_name": self.opt.Module.phi.name}

        # sampler; all-ones weight volumes (the default) skip the weight
        # upload and gather
        unit_weight = bool(np.all(weight == 1.0))
        spatial = tuple(int(s) for s in data_norm.shape[:-1])
        mode = cfg.coords_mode
        c = data_norm.shape[-1]
        if cfg.sampler.name == "randompoint":
            # Compress.raw_gather: the preprocessed integer volume stays on
            # the device in its own dtype and the affine normalization
            # follows each gather (JAX fit.py:222-262)
            dequant = None
            if not sharded and np.issubdtype(data_pre.dtype, np.integer) \
                    and bool(cfg.get("raw_gather", False)):
                dequant = raw_dequant(str(self.opt.Normalize.name),
                                      sideinfos)
            vector_len = int(cfg.sampler.get("vector_len", 1) or 1)
            if sharded and vector_len > 1:
                raise ValueError(
                    "Compress.sampler.vector_len is not supported with "
                    "Compress.data_shards > 1 (the data-parallel trainer "
                    "draws iid per-rank batches)")
            sampler = RandomPointSampler(
                spatial, mode, int(cfg.sampler.sample_size),
                min(vector_len, int(np.prod(spatial))),
                *(dequant or (1.0, 0.0)),
                raw_uint16=bool(dequant) and data_pre.dtype == np.uint16)
            # the data-parallel trainer keeps its own shard instead
            dev_data = dev_weight = None
            if not sharded:
                dev_data = device_raw(data_pre.reshape(-1, c), dev) \
                    if dequant else \
                    torch.from_numpy(data_norm.reshape(-1, c)).to(dev)
                dev_weight = None if unit_weight else \
                    torch.from_numpy(weight.reshape(-1, c)).to(dev)
        elif cfg.sampler.name == "randomcube":
            if sharded:
                raise ValueError(
                    "Compress.data_shards requires the randompoint sampler "
                    "(the volume is flattened and sharded over the ranks); "
                    "got randomcube")
            clipped = tuple(min(int(n), s) for n, s in zip(cube_len, spatial))
            sampler = RandomCubeSampler(spatial, mode,
                                        int(cfg.sampler.cube_count), clipped)
            dev_data = torch.from_numpy(data_norm).to(dev)
            dev_weight = None if unit_weight else \
                torch.from_numpy(weight).to(dev)
        else:
            raise NotImplementedError(cfg.sampler.name)

        # normalized weight threshold (reference main.py:380-383)
        thres = cfg.loss.weight_thres
        if thres > get_type_max(data_pre):
            raise ValueError(
                "The weight threshold should be less than the data maximum!")
        thres_norm, _ = normalize_data(np.array(thres, dtype=np.float32),
                                       **self.opt.Normalize,
                                       min=sideinfos["min"],
                                       max=sideinfos["max"])
        thres_norm = float(thres_norm)

        max_steps = int(cfg.max_steps)
        checkpoints = parse_checkpoints(cfg.checkpoints, max_steps)
        loss_log_freq = int(cfg.loss_log_freq)
        loss_name = cfg.loss.name
        beta = float(cfg.loss.get("beta", 0.01))

        if sharded:
            # one network, the batch split over the ranks, one all_reduce a
            # step (parallel/data_parallel.py)
            dp = DataParallelTrainer(model, self.seed, dev)
            opt_state = dp.prepare(data_norm, weight, cfg, thres_norm, params)
            fused, gen = dp.fused, dp.gen

            def train_step():
                return dp.step(params, opt_state)
        else:
            opt = make_optimizer(cfg.optimizer_name_phi, float(cfg.lr_phi),
                                 cfg.lr_scheduler_phi)
            opt_state = opt.init(params)
            # fused train kernel gate (fit.py:331-336 of the JAX package):
            # every plain chain, of any depth and width, takes the kernel
            fused = bool(cfg.get("fused_train", True)) \
                and dev.type == "cuda" and not self.half \
                and fused_train.supports_training(model, loss_name)
            step_fn = self._fused_step if fused else self._autograd_step
            step_args = dict(model=model, sampler=sampler, data=dev_data,
                             weight=dev_weight, loss_name=loss_name,
                             beta=beta, weight_thres=thres_norm)
            if not fused:
                step_args["half"] = self.half
            gen = torch.Generator(device=sampler.generator_device(dev))
            gen.manual_seed(self.seed)

            def train_step():
                loss, grads = step_fn(params, gen, **step_args)
                opt.step(params, grads, opt_state)
                return loss.detach()

        # the config axes a stored state is only meaningful under (JAX
        # fit.py:340-353); max_steps / checkpoints are left out, so a run
        # may be resumed to train longer (bitwise equality with an
        # uninterrupted run needs the same checkpoint grid)
        fingerprint = {
            "kind": "single", "phi_name": str(self.opt.Module.phi.name),
            "phi_features": int(features), "sampler": repr(sampler),
            "optimizer": str(cfg.optimizer_name_phi),
            "lr": float(cfg.lr_phi),
            "loss": f"{loss_name}/{beta}/{thres_norm}",
            "half": self.half, "data_shards": self.data_shards,
            "seed": self.seed,
            "fused": fused, "framework": "torch",
        }

        start_step = 0
        resume = str(cfg.get("resume", "none") or "none")
        if resume != "none":
            start_step = load_trainstate(resolve_trainstate(resume), params,
                                         opt_state, gen, fingerprint,
                                         rank=mesh.rank() if sharded else 0)

        step = start_step
        summary = {}
        orig_data = None
        last_loss = float("nan")   # checkpoints may start at 0 steps
        # host seconds in the training steps (ending in the one sync per
        # checkpoint interval that fetches the losses) and in checkpoints
        train_s = checkpoint_s = 0.0
        for ckpt in checkpoints:
            if ckpt <= start_step:
                continue   # the stopped run wrote these artifacts
            n = ckpt - step
            t0 = time.perf_counter()
            if n > 0:
                losses = torch.stack([train_step() for _ in range(n)]
                                     ).cpu().numpy()
                train_s += time.perf_counter() - t0
                t0 = time.perf_counter()
                if log is not None:
                    for i in range(n):
                        gstep = step + i + 1
                        if gstep % loss_log_freq == 0:
                            log.log_metrics({"loss": float(losses[i])}, gstep)
                last_loss = float(losses[-1])
            step = ckpt
            # every rank's generator state for rank 0's training state (a
            # collective, so before the ranks part ways below)
            key = np.stack(mesh.all_addressable(gen.get_state().numpy())) \
                if sharded else gen

            # ---- checkpoint artifacts (reference main.py:404-453) ----
            if log is None:
                continue
            step_dir = opj(log.logdir, f"steps{step}")
            compressed_dir = opj(step_dir, "compressed")
            os.makedirs(compressed_dir, exist_ok=True)
            module_path = opj(compressed_dir, "module")
            sideinfos_path = opj(compressed_dir, "sideinfos.yaml")
            cfglib.save(sideinfos, sideinfos_path)
            save_phi_module(model, params, module_path)
            actual_module_size = get_folder_size(module_path)
            side_bytes = os.path.getsize(sideinfos_path)
            orig_bytes = os.path.getsize(data_path)
            ratios = {
                "compress_ratio/theory": orig_bytes / (side_bytes + theory_size),
                "compress_ratio/actual":
                    orig_bytes / (side_bytes + actual_module_size),
            }
            log.log_metrics(ratios, step)
            summary = {"steps": step, "loss": last_loss, **ratios}

            if cfg.decompress:
                dec = self._decode(model, params, sideinfos)
                if self.opt.Decompress.keep_decompressed:
                    dd = opj(step_dir, "decompressed")
                    os.makedirs(dd, exist_ok=True)
                    save_img(opj(dd, opb(ops(data_path)[0]) + "_decompressed"
                                 + ops(data_path)[-1]), dec)
                if orig_data is None:
                    orig_data = read_img(data_path)
                if self.opt.Decompress.mip and orig_data.ndim == 4:
                    md = opj(step_dir, "mip")
                    os.makedirs(md, exist_ok=True)
                    stem = opb(ops(data_path)[0])
                    ext = ops(data_path)[-1]
                    mip_ops(orig_data, md, stem, ext)
                    mip_ops(dec, md, stem + "_decompressed", ext)
                    mip_ops(orig_data, md, stem, ".png")
                    mip_ops(dec, md, stem + "_decompressed", ".png")
                perf = eval_performance(step, orig_data, dec, log,
                                        self.opt.Decompress.mse,
                                        self.opt.Decompress.psnr,
                                        self.opt.Decompress.ssim,
                                        device=dev)
                perf["loss"] = last_loss
                log.append_csv_row(opj(log.logdir, "performance.csv"), perf)
                summary.update(perf)

            # the full training state, atomically, after the artifacts
            save_trainstate(opj(log.logdir, "trainstate.npz"), params,
                            opt_state, key, step, fingerprint)

            if stepstore and step < max_steps:
                shutil.rmtree(step_dir)
            checkpoint_s += time.perf_counter() - t0
        summary.update(train_s=train_s, checkpoint_s=checkpoint_s)
        if sharded:
            summary["global_batch"] = dp.global_batch
        if log is not None:
            log.close()
        self.model, self.params, self.sideinfos = model, params, sideinfos
        return summary

    # -------------------------------------------------------------- steps --
    @staticmethod
    def _fused_step(params, gen, *, sampler, data, weight, **kw):
        """(loss, grads) from the fused train-step kernel on a drawn batch."""
        return NFGR._fused_grads(params, *sampler.sample(gen, data, weight),
                                 **kw)

    @staticmethod
    def _autograd_step(params, gen, *, sampler, data, weight, **kw):
        """(loss, grads) by autograd on a drawn batch."""
        return NFGR._autograd_grads(params,
                                    *sampler.sample(gen, data, weight), **kw)

    @staticmethod
    def _fused_grads(params, coords, vals, wts, *, model, loss_name, beta,
                     weight_thres):
        """(loss, grads) of a batch from the fused train-step kernel."""
        coords = make_pre_encode(model.spec)(coords)
        return fused_train.fused_train_grads(
            params["layers"], coords.T.contiguous(), vals.T.contiguous(),
            wts.T.contiguous(), chain_layer_specs(model.spec),
            loss_name=loss_name, beta=beta, weight_thres=weight_thres or None)

    @staticmethod
    def _autograd_grads(params, coords, vals, wts, *, model, loss_name, beta,
                        weight_thres, half=False):
        """(loss, grads) of a batch by autograd through the model's apply,
        for any parameter tree (half: its products in bfloat16, JAX
        fit.py:102-106); a leaf the loss does not reach (FFN's frozen
        bvals) gets a zero gradient."""
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        try:
            pred = model.apply(params, coords, compute_dtype=torch.bfloat16
                               if half else None)
            loss = make_loss(loss_name, beta)(vals, pred, wts, weight_thres)
            flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        flat = [torch.zeros_like(t) if g is None else g
                for t, g in zip(leaves, flat)]
        return loss, tree_unflatten(params, flat)

    # -------------------------------------------------------------- utils --
    def _decode(self, model, params, sideinfos) -> np.ndarray:
        dec = reconstruct_flattened(
            model, params, sideinfos["data_shape"],
            int(self.opt.Decompress.sample_size), self.opt.Compress.coords_mode,
            self.half)
        dec = invnormalize_data(dec, sideinfos, **self.opt.Normalize)
        post = self.opt.Decompress.postprocess
        return preprocess(dec, post.denoise.level, post.denoise.close,
                          post.clip)

    # --------------------------------------------------------- decompress --
    @staticmethod
    def decompress_divide(opt, orig_sideinfos_path: str,
                          module_save_dir: str, sideinfos_save_dir: str,
                          device: DeviceLike = None) -> np.ndarray:
        """Standalone decode of a saved DivideTask archive (reference
        main.py:299-320, JAX fit.py:496-531): every chunk under
        <module_save_dir>/<chunk_name>/module is decoded through
        NFGR.decompress with its own sideinfos and merged by the extents
        in its name 'd_{z0}_{z1}-h_{y0}_{y1}-w_{x0}_{x1}'.

        opt: a CompressFramework config node or a path to a yaml.
        """
        from brief_pytorch_tpu_torch.partition.divide import (
            merge_divided_data, parse_chunk_name)
        dev = resolve_device(device)
        if isinstance(opt, str):
            opt = cfglib.load(opt).CompressFramework
        data_shape = list(cfglib.load(orig_sideinfos_path)["data_shape"])
        chunk_list = []
        for name in sorted(os.listdir(module_save_dir)):
            # chunk entries are directories named d_*-h_*-w_* / h_*-w_*
            if not os.path.isdir(opj(module_save_dir, name)):
                continue
            try:
                extents = parse_chunk_name(name)
            except (ValueError, IndexError):
                continue
            dec = NFGR.decompress(
                opt, opj(module_save_dir, name, "module"),
                opj(sideinfos_save_dir, name, "sideinfos.yaml"), device=dev)
            chunk_list.append({"data": dec, "name": name, **extents})
        if not chunk_list:
            raise FileNotFoundError(
                f"no chunk directories found in {module_save_dir}")
        return merge_divided_data(chunk_list, data_shape)

    @staticmethod
    def decompress(opt, module_path: str, sideinfos_path: str,
                   device: DeviceLike = None) -> np.ndarray:
        """Standalone decode from saved artifacts (reference main.py:270-297).

        opt: a CompressFramework config node or a path to a SingleTask yaml.
        device: None (the CUDA card), 'cpu', or a torch device.
        """
        dev = resolve_device(device)
        if isinstance(opt, str):
            opt = cfglib.load(opt).CompressFramework
        sideinfos = cfglib.load(sideinfos_path)
        phi_cfg = dict(opt.Module.phi)
        phi_cfg["features"] = sideinfos["phi_features"]
        phi_cfg["name"] = sideinfos["phi_name"]
        model = init_phi(phi_cfg)
        # the archive's kind decides: params.npz (MFN), or raw binaries
        # with encoder.npz beside them (FFN's frozen bvals)
        like = model.init(torch.Generator().manual_seed(0), "cpu")
        params = params_from_numpy(
            load_phi_module(model, module_path, like), dev)
        dec = reconstruct_flattened(model, params, sideinfos["data_shape"],
                                    int(opt.Decompress.sample_size),
                                    opt.Compress.coords_mode,
                                    bool(opt.Compress.half))
        dec = invnormalize_data(dec, dict(sideinfos), **opt.Normalize)
        post = opt.Decompress.postprocess
        return preprocess(dec, post.denoise.level, post.denoise.close,
                          post.clip)
