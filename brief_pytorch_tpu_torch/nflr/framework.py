"""NFLR compression frameworks: latent-modulated local INRs with optional
learned entropy coding.

Torch port of brief_pytorch_tpu/nflr/framework.py (reference
utils/CompressFramework.py: _BaseCompressFramerwork 20-145, the NFLR
skeleton 146-265, _NFLR 266-292, NFLR_AutoDecoder 294-313,
NFLR_AutoEncoder 315-333, _NFLR_Coding 334-394 (uniform noise + SGA rate
distortion), _NFLR_Coding_Hyper 441-532 (mean-scale hyperprior), the four
Coding variants 396-588, ALLCF 591-594, eval_performance 596-642; and
utils/misc.py loss_bpp_func 161-173, init_y/init_z 204-211,
annealed_temperature 212-232).

One code path: a training or SGA step is one Python call of torch ops on
the framework's device, and `training_segment` is a loop over
`training_step`, so N segment steps are N step calls.  Randomness comes
from the framework's torch.Generator (`self.gen`, seeded with opt.seed, on
the device); every step draws what it needs first (`draw_*`) and takes
the draws as tensors, so tests can feed it the JAX package's.  The
parameters are plain trees of tensors with the JAX package's keys
(`params_from_numpy` takes the JAX package's `_state_dict()`), updated in
place by train/optim.py's optax-rule optimisers.  Tables and bitstreams
(rANS) and the overlap merge run on the host.

Frameworks take `device=` (None: the CUDA card, raising without one;
"cpu" runs on the host).  The config's `gpu` keys are not read.
"""
from __future__ import annotations

import json
import math
import os
import pickle
import shutil
from os.path import basename as opb
from os.path import join as opj
from os.path import splitext as ops
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from brief_pytorch_tpu_torch.core.device import resolve_device
from brief_pytorch_tpu_torch.core.normalize import invnormalize_data
from brief_pytorch_tpu_torch.core.tree import (tree_leaves, tree_map,
                                               tree_unflatten)
from brief_pytorch_tpu_torch.io.archive import (extract_7z, read_7z,
                                                read_binary_yaml_zip,
                                                write_7z,
                                                write_binary_yaml_zip)
from brief_pytorch_tpu_torch.io.image import get_folder_size
from brief_pytorch_tpu_torch.models.phi import init_phi
from brief_pytorch_tpu_torch.nflr import entropy as em
from brief_pytorch_tpu_torch.nflr.crop import (CropDataset,
                                               gen_data_path_list_list,
                                               gen_pathlist_fromimgdir,
                                               read_data_batch,
                                               reconstruct_cropped,
                                               save_data_batch)
from brief_pytorch_tpu_torch.nflr.networks import (init_gmod, init_gy,
                                                   init_hy, init_hz,
                                                   siren_forward_syn)
from brief_pytorch_tpu_torch.train.optim import Optimizer, make_optimizer


# --------------------------------------------------------------------------
# parameters across the packages
# --------------------------------------------------------------------------
def params_from_numpy(state, device=None):
    """The JAX package's `_state_dict()` (a tree of numpy arrays) -> the
    port's parameter tree of float32 tensors on `device`, same keys."""
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32),
                                           device=device), state)


def params_to_numpy(params):
    """Inverse of params_from_numpy: the same tree of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)


def value_and_grad(fn: Callable, tree) -> Tuple[torch.Tensor, object]:
    """(fn(tree), d fn / d tree) for a tree of leaf tensors; leaves fn does
    not use get zero gradients, as under jax.grad.  cuDNN runs the
    forward and the backward with TF32 off and deterministic algorithms
    (its default backward algorithms sum a conv's weight gradient in an
    order that changes from run to run)."""
    leaves = tree_leaves(tree)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad(), torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=True,
                allow_tf32=False):
            loss = fn(tree)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(tree, grads)


# --------------------------------------------------------------------------
# shared math (reference utils/misc.py)
# --------------------------------------------------------------------------
def loss_bpp_func(likelihoods: torch.Tensor) -> torch.Tensor:
    """Bits per pixel (reference utils/misc.py:161-173): the channel axis is
    *not* part of num_pixels."""
    if likelihoods.ndim == 5:
        n, c, d, h, w = likelihoods.shape
        num_pixels = d * h * w * n
    elif likelihoods.ndim == 4:
        n, c, h, w = likelihoods.shape
        num_pixels = h * w * n
    else:
        raise NotImplementedError(likelihoods.shape)
    return torch.log(likelihoods).sum() / (-math.log(2) * num_pixels)


def latent_shape(batch_size: int, channels: int, pc_shape) -> tuple:
    return (int(batch_size), int(channels)) + tuple(int(p) for p in pc_shape)


def init_y(gen: torch.Generator, batch_size: int, y_channel: int,
           pc_shape: tuple, normal: torch.Tensor = None) -> torch.Tensor:
    """xavier_normal_(gain=10000) latent init (reference utils/misc.py:
    204-207; torch fan computation over (N, C, *pc)); `normal` holds the
    N(0, 1) draws, drawn from gen when not given."""
    shape = latent_shape(batch_size, y_channel, pc_shape)
    receptive = math.prod(shape[2:])
    fan_in = y_channel * receptive
    fan_out = batch_size * receptive
    std = 10000.0 * math.sqrt(2.0 / (fan_in + fan_out))
    if normal is None:
        normal = torch.randn(shape, generator=gen, device=gen.device)
    return std * normal


init_z = init_y  # same initializer, z_channel instead (misc.py:208-211)


def annealed_temperature(t: int, r: float, ub: float, lb: float = 1e-8,
                         scheme: str = "exp", t0: int = 700) -> float:
    """SGA temperature schedule (reference utils/misc.py:212-232)."""
    if scheme == "exp":
        tau = math.exp(-r * t)
    elif scheme == "exp0":
        tau = ub * math.exp(-r * (t - t0))
    elif scheme == "linear":
        tau = -r * (t - t0) + ub
    else:
        raise NotImplementedError(scheme)
    return min(max(tau, lb), ub)


def gumbel(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(U)) with U in [tiny, 1), the
    construction of jax.random.gumbel."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=gen.device)
    u = u * (1.0 - tiny) + tiny
    return -torch.log(-torch.log(u))


def sga_relax(gen: torch.Generator, y: torch.Tensor, tau: float,
              g: torch.Tensor = None) -> torch.Tensor:
    """Stochastic Gumbel Annealing relaxation (reference
    CompressFramework.py:341-351): a Concrete sample over {floor(y),
    ceil(y)}; g holds the Gumbel draws of shape y.shape + (2,)."""
    eps = 1e-5
    y_floor = torch.floor(y)
    y_ceil = torch.ceil(y)
    bds = torch.stack([y_floor, y_ceil], dim=-1)
    logits = torch.stack(
        [-torch.atanh(em.clip(y - y_floor, -1 + eps, 1 - eps)) / tau,
         -torch.atanh(em.clip(y_ceil - y, -1 + eps, 1 - eps)) / tau], dim=-1)
    if g is None:
        g = gumbel(gen, logits.shape)
    sample = torch.softmax((logits + g) / tau, dim=-1)
    return (bds * sample).sum(-1)


def _exp_scales(log_scales: torch.Tensor) -> torch.Tensor:
    """exp with the log clipped to +-20, as the JAX package makes scales
    positive (finite under the gain-10000 latent init)."""
    return torch.exp(em.clip(log_scales, -20.0, 20.0))


# --------------------------------------------------------------------------
# base framework
# --------------------------------------------------------------------------
class _BaseCompressFramework:
    """Module-dict lifecycle (reference CompressFramework.py:20-145).

    self.module maps name -> network object (init/apply pair);
    self.params maps name -> parameter tree.  The torch eval/train/grad
    toggles exist as no-ops for API compatibility."""

    def __init__(self, opt, device=None) -> None:
        self.opt = opt
        self.device = resolve_device(device)
        self.module: Dict[str, object] = {}
        self.params: Dict[str, object] = {}
        self.seed = int(opt.get("seed", 42))
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self._tx_cache: Dict[tuple, Optimizer] = {}

    def _opt_tx(self, name: str, lr: float) -> Optimizer:
        key = (str(name), float(lr))
        if key not in self._tx_cache:
            self._tx_cache[key] = make_optimizer(str(name), float(lr))
        return self._tx_cache[key]

    # -------------------------------------------------------- state dict --
    def _state_dict(self) -> Dict[str, object]:
        return params_to_numpy(self.params)

    def _load_state_dict(self, state: Dict[str, object]) -> None:
        self.params = params_from_numpy(state, self.device)

    def save_module(self, save_path: str,
                    serializing_method: str = "torchsave") -> int:
        """5 formats (reference CompressFramework.py:56-95).  'torchsave*'
        writes the JAX package's torch.save'd tree of tensors; 'numpysave*'
        one .npy per leaf beside treedef.json; *_7z recompress with the
        archive codec."""
        state = self._state_dict()
        if serializing_method in ("torchsave", "torchsave_wo_new_zipfile"):
            self._torch_save(state, save_path,
                             new_zip=serializing_method == "torchsave")
        elif serializing_method in ("torchsave_7z",
                                    "torchsave_wo_new_zipfile_7z"):
            self._torch_save(state, save_path,
                             new_zip="wo" not in serializing_method)
            write_7z([save_path], save_path + "_7z", [opb(save_path)])
            os.remove(save_path)
            os.rename(save_path + "_7z", save_path)
        elif serializing_method == "numpysave":
            self._numpy_save(state, save_path)
        elif serializing_method == "numpysave_7z":
            self._numpy_save(state, save_path + "_tmp")
            write_7z([save_path + "_tmp"], save_path, "0")
            shutil.rmtree(save_path + "_tmp")
        else:
            raise NotImplementedError(serializing_method)
        return get_folder_size(save_path)

    def load_module(self, module_path: str,
                    serializing_method: str = "torchsave") -> None:
        """(reference CompressFramework.py:29-55); reads the JAX package's
        torchsave files too."""
        if serializing_method in ("torchsave", "torchsave_wo_new_zipfile"):
            state = self._torch_load(module_path)
        elif serializing_method in ("torchsave_7z",
                                    "torchsave_wo_new_zipfile_7z"):
            buf = next(iter(read_7z(module_path).values()))
            state = self._torch_load(buf)
        elif serializing_method == "numpysave":
            state = self._numpy_load(module_path)
        elif serializing_method == "numpysave_7z":
            tmp = opj(os.path.dirname(module_path) or ".", "temp_extracted")
            extract_7z(module_path, tmp)
            state = self._numpy_load(opj(tmp, "0"))
            shutil.rmtree(tmp)
        else:
            raise NotImplementedError(serializing_method)
        self._load_state_dict(state)

    @staticmethod
    def _torch_save(state, path, new_zip=True):
        t_state = tree_map(lambda x: torch.from_numpy(np.array(x, copy=True)),
                           state)
        torch.save(t_state, path, _use_new_zipfile_serialization=new_zip)

    @staticmethod
    def _torch_load(path_or_buf):
        t_state = torch.load(path_or_buf, map_location="cpu",
                             weights_only=False)
        return tree_map(lambda t: t.numpy() if hasattr(t, "numpy") else t,
                        t_state)

    @staticmethod
    def _numpy_save(state, save_path):
        """One {i}.npy per leaf and treedef.json, the tree with each leaf
        replaced by its index."""
        os.makedirs(save_path)
        leaves = tree_leaves(state)
        skeleton = tree_unflatten(state, list(range(len(leaves))))
        with open(opj(save_path, "treedef.json"), "w") as f:
            json.dump(skeleton, f)
        for i, leaf in enumerate(leaves):
            np.save(opj(save_path, f"{i}.npy"), leaf)

    @staticmethod
    def _numpy_load(save_path):
        with open(opj(save_path, "treedef.json")) as f:
            skeleton = json.load(f)
        return tree_map(lambda i: np.load(opj(save_path, f"{i}.npy")),
                        skeleton)

    # ----------------------------------------------------- torch-API compat
    def move_module_to(self, device: str):
        return

    def set_module_eval(self):
        return

    def set_module_train(self):
        return

    def set_module_no_grad(self):
        return

    def set_module_grad(self):
        return

    def module_parameters(self):
        """(reference CompressFramework.py:121-127)"""
        return self.params


# --------------------------------------------------------------------------
# NFLR base: modulated local INR
# --------------------------------------------------------------------------
class _BaseNFLR(_BaseCompressFramework):
    """(reference CompressFramework.py:146-265)"""

    # names of params trained by the module optimizer
    MODULE_KEYS: Tuple[str, ...] = ("phi", "gmod")

    def __init__(self, opt, device=None) -> None:
        super().__init__(opt, device)
        self.y_channel = int(opt.Module.gmod.y_channel)
        self.data_channel = int(opt.Module.phi.data_channel)
        self.w0 = float(opt.Module.phi.get("w0", 30))

    # ------------------------------------------------------------ draws ---
    def _normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device)

    def _uniform(self, shape) -> torch.Tensor:
        return em.uniform(self.gen, shape)

    def _y_shape(self, sideinfos, pc_shape) -> tuple:
        return latent_shape(sideinfos["data_shape"][0], self.y_channel,
                            pc_shape)

    # ------------------------------------------------------------ modules --
    def _init_phi_gmod(self):
        self.module["phi"] = init_phi(dict(self.opt.Module.phi))
        self.params["phi"] = self.module["phi"].init(self.gen, self.device)
        self.module["gmod"] = init_gmod(
            dim_hidden=int(self.opt.Module.phi.features),
            layers=int(self.opt.Module.phi.layers) - 1,
            **dict(self.opt.Module.gmod))
        self.params["gmod"] = self.module["gmod"].init(self.gen, self.device)

    def _init_hy(self):
        crop = self.opt.Module.crop
        self.module["hy"] = init_hy(
            ps_d=crop.ps_d, ps_h=crop.ps_h, ps_w=crop.ps_w,
            y_channel=self.y_channel, data_channel=self.data_channel,
            **dict(self.opt.Module.hy))
        self.params["hy"] = self.module["hy"].init(self.gen, self.device)

    # ------------------------------------------------------------- synth --
    def sample_nf(self, coords: torch.Tensor, mods) -> torch.Tensor:
        """(reference CompressFramework.py:151-153)"""
        return siren_forward_syn(self.params["phi"]["layers"], coords, mods,
                                 w0=30.0, first_w0=self.w0)

    def _distortion(self, params: Dict, coords, y, data_gt) -> torch.Tensor:
        """(reference CompressFramework.py:154-158)"""
        mods = self.module["gmod"].apply(params["gmod"], y)
        pred = siren_forward_syn(params["phi"]["layers"], coords, mods,
                                 w0=30.0, first_w0=self.w0)
        return torch.mean((pred - data_gt) ** 2)

    # ------------------------------------------------------------ train ----
    def train(self, save_dir: str, Log=None) -> None:
        """Epoch loop over CropDataset (reference CompressFramework.py:
        160-221).

        Train.resume continues a preempted run bitwise: params, the module
        optimizer, the quantile optimizers and the generator's state
        round-trip through trainstate.npz (train/checkpoint.py), and the
        seeded data pipeline is replayed without any training math or
        draws up to the stored step.  Train.state_every_n_step writes the
        state every N steps (and always at the end)."""
        from brief_pytorch_tpu_torch.train import checkpoint as ckpt_lib
        os.makedirs(opj(save_dir, "trained_module"), exist_ok=True)
        t = self.opt.Train
        train_paths = gen_pathlist_fromimgdir(t.train_data_dir)
        val_lists = gen_data_path_list_list(t.val_data_dir,
                                            int(t.get("val_data_quanity", 1)))
        dataset = CropDataset(int(t.batch_size), int(t.sample_size),
                              self.opt.Normalize, t.get("transform"),
                              self.opt.Module.crop, True, True,
                              data_path_list=train_paths, seed=self.seed,
                              device=self.device)
        tx = make_optimizer(t.optimizer_name_module, float(t.lr_module))
        opt_state = tx.init(self._train_params())

        max_steps = int(t.max_steps)
        log_every = int(t.get("log_every_n_step", 100))
        val_every = int(t.get("val_every_n_step", max_steps))
        state_path = opj(save_dir, "trainstate.npz")
        state_every = int(t.get("state_every_n_step", 0) or 0)
        fingerprint = {
            "kind": "nflr", "variant": type(self).__name__,
            "y_channel": int(self.y_channel),
            "phi": f"{self.opt.Module.phi.features}/"
                   f"{self.opt.Module.phi.layers}",
            "optimizer": str(t.optimizer_name_module),
            "lr": float(t.lr_module), "seed": int(self.seed),
            "batch": f"{t.batch_size}/{t.sample_size}",
            "Lambda": float(t.get("Lambda", 0) or 0),
        }
        # the quantile optimizers' states, where the framework has them
        aux_names = [n for n in ("_emy_opt", "_emz_opt") if hasattr(self, n)]

        def _save_state(steps: int) -> None:
            arrs = {"step": np.asarray(int(steps)),
                    "fingerprint": ckpt_lib.fingerprint_bytes(fingerprint),
                    "key": self.gen.get_state().numpy()}
            ckpt_lib.pack_tree(arrs, "p", self.params)
            ckpt_lib.pack_opt(arrs, "o", opt_state)
            for n in aux_names:
                ckpt_lib.pack_opt(arrs, n, getattr(self, n))
            ckpt_lib.atomic_savez(state_path, arrs)

        start_step = 0
        resume = str(t.get("resume", "none") or "none")
        if resume != "none":
            path = ckpt_lib.resolve_trainstate(resume)
            with np.load(path) as z:
                ckpt_lib.check_fingerprint(z, fingerprint, path)
                ckpt_lib.unpack_tree(z, "p", self.params, "params")
                ckpt_lib.unpack_opt(z, "o", opt_state)
                for n in aux_names:
                    ckpt_lib.unpack_opt(z, n, getattr(self, n), n)
                ckpt_lib.unpack_generator(z, "key", self.gen)
                start_step = int(z["step"])
            if start_step >= max_steps:
                return

        steps = 0
        for epoch in range(int(1e8)):
            for (cropped, sampler, pc_shape, sideinfos) in dataset:
                for (coords, values) in sampler:
                    if steps < start_step:
                        # fast-forward: the restored generator and
                        # optimizer states already account for this step
                        steps += 1
                        continue
                    loss, opt_state = self.training_step(
                        cropped, pc_shape, sideinfos, coords, values,
                        tx, opt_state)
                    steps += 1
                    if Log is not None and steps % log_every == 0:
                        Log.log_metrics({"loss/train": float(loss)}, steps)
                    if steps % val_every == 0 or steps == max_steps:
                        # evaluation draws from self.gen: restore it after,
                        # so the training draws do not depend on the val
                        # cadence (nor on where a run was preempted)
                        train_gen = self.gen.get_state()
                        self.save_module(
                            opj(save_dir, "trained_module",
                                f"epoch_{epoch}_step_{steps}.pt"))
                        perf = eval_performance(
                            val_lists, self,
                            opj(save_dir, "eval_results",
                                f"epoch_{epoch}_step_{steps}"), True)
                        if Log is not None:
                            Log.log_metrics(
                                {"performance/mse": float(perf["mse"].mean()),
                                 "performance/psnr": float(perf["psnr"].mean()),
                                 "performance/compress_ratio":
                                     float(perf["compress_ratio"].mean())},
                                steps)
                        self.gen.set_state(train_gen)
                    if (state_every and steps % state_every == 0) \
                            or steps == max_steps:
                        _save_state(steps)
                    if steps == max_steps:
                        return

    def _module_params(self) -> Dict:
        return {k: self.params[k] for k in self.MODULE_KEYS}

    def _train_params(self) -> Dict:
        """The exact parameter tree training_step optimizes (its insertion
        order is the optimizer's moment order)."""
        return self._module_params()

    def draw_train(self, sideinfos, pc_shape) -> Dict:
        """The random draws of one training_step."""
        return {}

    def training_step(self, cropped, pc_shape, sideinfos, coords, values,
                      tx, opt_state, draws: Dict = None):
        raise NotImplementedError

    def training_segment(self, cropped, pc_shape, sideinfos, coords, values,
                         tx, opt_state, n_steps: int):
        """n_steps calls of training_step -> (losses (n_steps,), opt_state)."""
        losses = []
        for _ in range(int(n_steps)):
            loss, opt_state = self.training_step(
                cropped, pc_shape, sideinfos, coords, values, tx, opt_state)
            losses.append(loss)
        return torch.stack(losses), opt_state

    # ---------------------------------------------------------- compress ---
    def compress(self, data_path_list: List[str], save_path: str = None):
        """(reference CompressFramework.py:226-241)"""
        dataset = CropDataset(len(data_path_list),
                              int(self.opt.Compress.sample_size),
                              self.opt.Normalize, None, self.opt.Module.crop,
                              False, True, data_path_list=data_path_list,
                              seed=self.seed, device=self.device)
        cropped, sampler, pc_shape, sideinfos = next(iter(dataset))
        return self.compressing_data(cropped, sampler, pc_shape, sideinfos,
                                     save_path)

    def compressing_data(self, cropped, sampler, pc_shape, sideinfos,
                         save_path):
        raise NotImplementedError

    def _tau(self, epoch: int) -> float:
        c = self.opt.Compress
        return annealed_temperature(
            epoch, r=float(c.annealing_rate), ub=float(c.init_temperature),
            scheme=c.annealing_scheme, t0=int(c.t0))

    def _argmin_loop(self, sampler, step: Callable) -> None:
        """Compress.max_steps calls of step(coords, values, epoch), epoch
        by epoch over the sampler's batches."""
        steps, max_steps = 0, int(self.opt.Compress.max_steps)
        for epoch in range(int(1e8)):
            for (coords, values) in sampler:
                if steps == max_steps:
                    return
                step(coords, values, epoch)
                steps += 1
            if steps == max_steps:
                return

    # -------------------------------------------------------- decompress ---
    @torch.no_grad()
    def decompress(self, compressed_data_path: str = None,
                   compressed_data: Dict = None,
                   save_path_list: List[str] = None) -> np.ndarray:
        """(reference CompressFramework.py:246-261)"""
        y, sideinfos = self.decompressing_data(compressed_data_path,
                                               compressed_data)
        y = torch.as_tensor(np.asarray(y, np.float32), device=self.device)
        mods = self.module["gmod"].apply(self.params["gmod"], y)
        data = reconstruct_cropped(sideinfos["data_shape"],
                                   int(self.opt.Decompress.sample_size),
                                   mods, self.sample_nf,
                                   device=self.device,
                                   **dict(self.opt.Module.crop))
        data = invnormalize_data(data, sideinfos, **self.opt.Normalize)
        if save_path_list is not None:
            save_data_batch(data, save_path_list)
        return data

    def decompressing_data(self, compressed_data_path, compressed_data):
        raise NotImplementedError


# --------------------------------------------------------------------------
# distortion-only family
# --------------------------------------------------------------------------
class _NFLR(_BaseNFLR):
    """y optimised for distortion only; payload = raw float y
    (reference CompressFramework.py:266-292)."""

    def compressing_data(self, cropped, sampler, pc_shape, sideinfos,
                         save_path):
        y = self.init_compressing_y(cropped, sideinfos, pc_shape)
        tx_y = self._opt_tx(self.opt.Compress.optimizer_name_y,
                            self.opt.Compress.lr_y)
        lat = {"y": y}
        opt_y = tx_y.init(lat)
        self._argmin_loop(sampler, lambda coords, values, epoch: self.y_step(
            lat, opt_y, tx_y, coords, values))
        compressed = {"sideinfos": sideinfos, "y": y.cpu().numpy()}
        if save_path is not None:
            with open(save_path, "wb") as f:
                pickle.dump(compressed, f)
        return compressed

    def y_step(self, lat: Dict, opt_y, tx_y: Optimizer, coords, values
               ) -> torch.Tensor:
        """One distortion step of the latents {"y"} in place -> the loss."""
        params = self._module_params()
        loss, g = value_and_grad(
            lambda t: self._distortion(params, coords, t["y"], values), lat)
        tx_y.step(lat, g, opt_y)
        return loss

    def decompressing_data(self, compressed_data_path, compressed_data):
        if compressed_data_path is not None:
            with open(compressed_data_path, "rb") as f:
                compressed_data = pickle.load(f)
        return compressed_data["y"], compressed_data["sideinfos"]

    def init_compressing_y(self, cropped, sideinfos, pc_shape):
        raise NotImplementedError


def _inner_argmin(tx_y: Optimizer, lat: Dict, n: int, loss_fn: Callable
                  ) -> None:
    """n steps of tx_y on the latents `lat` ({"y"}), in place, from a
    fresh optimizer state; loss_fn(lat, i) is the i-th step's loss."""
    opt = tx_y.init(lat)
    for i in range(n):
        _, g = value_and_grad(lambda t: loss_fn(t, i), lat)
        tx_y.step(lat, g, opt)


def _module_step(params: Dict, opt_state, tx: Optimizer, loss_fn: Callable
                 ) -> torch.Tensor:
    """One optimizer step of params on loss_fn(params); returns the loss."""
    loss, grads = value_and_grad(loss_fn, params)
    tx.step(params, grads, opt_state)
    return loss


class NFLR_AutoDecoder(_NFLR):
    """Per-batch y found by an inner argmin (reference
    CompressFramework.py:294-313)."""

    def __init__(self, opt, device=None) -> None:
        super().__init__(opt, device)
        self._init_phi_gmod()

    def init_compressing_y(self, cropped, sideinfos, pc_shape):
        return init_y(self.gen, sideinfos["data_shape"][0], self.y_channel,
                      pc_shape)

    def draw_train(self, sideinfos, pc_shape) -> Dict:
        return {"y0": self._normal(self._y_shape(sideinfos, pc_shape))}

    def training_step(self, cropped, pc_shape, sideinfos, coords, values,
                      tx, opt_state, draws: Dict = None):
        draws = draws or self.draw_train(sideinfos, pc_shape)
        params = self._module_params()
        t = self.opt.Train
        lat = {"y": init_y(None, sideinfos["data_shape"][0], self.y_channel,
                           pc_shape, draws["y0"])}
        _inner_argmin(self._opt_tx(t.optimizer_name_y, t.lr_y), lat,
                      int(t.argmin_steps),
                      lambda l, i: self._distortion(params, coords, l["y"],
                                                    values))
        loss = _module_step(params, opt_state, tx, lambda p: self._distortion(
            p, coords, lat["y"], values))
        return loss, opt_state


class NFLR_AutoEncoder(_NFLR):
    """y produced by the conv encoder hy (reference CompressFramework.py:
    315-333)."""
    MODULE_KEYS = ("phi", "gmod", "hy")

    def __init__(self, opt, device=None) -> None:
        super().__init__(opt, device)
        self._init_phi_gmod()
        self._init_hy()

    @torch.no_grad()
    def init_compressing_y(self, cropped, sideinfos, pc_shape):
        return self.module["hy"].apply(self.params["hy"], cropped,
                                       int(self.opt.Compress.get("hy_bs", 0)))

    def _ae_loss(self, p, cropped, coords, values):
        y = self.module["hy"].apply(p["hy"], cropped)
        return self._distortion(p, coords, y, values)

    def training_step(self, cropped, pc_shape, sideinfos, coords, values,
                      tx, opt_state, draws: Dict = None):
        loss = _module_step(self._module_params(), opt_state, tx,
                            lambda p: self._ae_loss(p, cropped, coords,
                                                    values))
        return loss, opt_state


# --------------------------------------------------------------------------
# coding family (factorized entropy model on y)
# --------------------------------------------------------------------------
class _NFLR_Coding(_NFLR):
    """Rate-distortion training (uniform noise) + SGA compression + rANS
    bitstreams (reference CompressFramework.py:334-394)."""

    def _loss_rd_un(self, params, noise, coords, values, y, Lambda):
        """(reference CompressFramework.py:335-340); noise: U(-0.5, 0.5)
        of y's shape."""
        y_noisy, y_lik = em.factorized_forward(params["emy"], y,
                                               noise=noise)
        return (loss_bpp_func(y_lik)
                + Lambda * self._distortion(params, coords, y_noisy, values))

    def _loss_rd_sga(self, params, g, coords, values, y, Lambda, tau):
        """(reference CompressFramework.py:341-363); g: Gumbel draws of
        shape y.shape + (2,)."""
        y_tilde = sga_relax(None, y, tau, g)
        flat, shape, _ = em._to_c1n(y_tilde)
        y_lik = em._from_c1n(
            em.factorized_likelihood(params["emy"], flat), shape)
        return (loss_bpp_func(y_lik)
                + Lambda * self._distortion(params, coords, y_tilde, values))

    def _init_emy(self):
        cfg = dict(self.opt.Module.emy)
        cfg.pop("name", None)
        self._emy_tx = make_optimizer(cfg.pop("optimizer_name_quantiles",
                                              "Adam"),
                                      float(cfg.pop("lr_quantiles", 1e-3)))
        self.params["emy"] = em.factorized_init(
            self.gen, self.y_channel,
            filters=tuple(cfg.get("filters", (3, 3, 3, 3))),
            init_scale=float(cfg.get("init_scale", 10)), device=self.device)
        self._emy_opt = self._emy_tx.init(
            {"quantiles": self.params["emy"]["quantiles"]})
        self.module["emy"] = "factorized"   # marker for save/load

    def update_quantiles_once(self):
        """(reference Networks.py:1070-1074); returns the aux loss, a
        tensor on the device (no host sync)."""
        return _quantile_step(self.params["emy"], self._emy_opt,
                              self._emy_tx)

    def draw_sga(self, y: torch.Tensor) -> Dict:
        return {"g": gumbel(self.gen, tuple(y.shape) + (2,))}

    def sga_step(self, lat: Dict, opt_y, tx_y: Optimizer, coords, values,
                 tau: float, draws: Dict = None) -> torch.Tensor:
        """One SGA step of the latents {"y"} in place -> the loss."""
        draws = draws or self.draw_sga(lat["y"])
        params = self._coding_params()
        Lambda = float(self.opt.Train.Lambda)
        loss, g = value_and_grad(
            lambda t: self._loss_rd_sga(params, draws["g"], coords, values,
                                        t["y"], Lambda, tau), lat)
        tx_y.step(lat, g, opt_y)
        return loss

    def compressing_data(self, cropped, sampler, pc_shape, sideinfos,
                         save_path):
        c = self.opt.Compress
        lat = {"y": self.init_compressing_y(cropped, sideinfos, pc_shape)}
        tx_y = self._opt_tx(c.optimizer_name_y, c.lr_y)
        opt_y = tx_y.init(lat)
        self._argmin_loop(sampler, lambda coords, values, epoch: self.sga_step(
            lat, opt_y, tx_y, coords, values, self._tau(epoch)))
        tables = em.factorized_build_tables(self.params["emy"])
        y_np = lat["y"].cpu().numpy()
        y_strings = em.factorized_compress(self.params["emy"], tables, y_np)
        sideinfos["y_shape"] = [int(s) for s in y_np.shape[2:]]
        if save_path is not None:
            write_binary_yaml_zip({"y_strings": y_strings},
                                  dict(sideinfos), save_path)
        return {"y_strings": y_strings, "sideinfos": sideinfos}

    def _coding_params(self):
        return {**self._module_params(), "emy": self.params["emy"]}

    def decompressing_data(self, compressed_data_path, compressed_data):
        """(reference CompressFramework.py:385-394)"""
        if compressed_data_path is not None:
            blobs, sideinfos = read_binary_yaml_zip(["y_strings"],
                                                    compressed_data_path)
            compressed_data = {**blobs, "sideinfos": sideinfos}
        sideinfos = compressed_data["sideinfos"]
        tables = em.factorized_build_tables(self.params["emy"])
        y = em.factorized_decompress(self.params["emy"], tables,
                                     compressed_data["y_strings"],
                                     sideinfos["y_shape"])
        return y, sideinfos


def _quantile_step(em_params: Dict, opt_state, tx: Optimizer
                   ) -> torch.Tensor:
    """One step of the quantile optimizer on quantile_loss, in place."""
    q = {"quantiles": em_params["quantiles"]}
    loss, g = value_and_grad(
        lambda t: em.quantile_loss({**em_params, **t}), q)
    tx.step(q, g, opt_state)
    return loss


class NFLR_Coding_AutoDecoder(_NFLR_Coding):
    """(reference CompressFramework.py:396-417)"""
    MODULE_KEYS = ("phi", "gmod", "emy")

    def __init__(self, opt, device=None) -> None:
        super().__init__(opt, device)
        self._init_phi_gmod()
        self._init_emy()

    def init_compressing_y(self, cropped, sideinfos, pc_shape):
        return init_y(self.gen, sideinfos["data_shape"][0], self.y_channel,
                      pc_shape)

    def draw_train(self, sideinfos, pc_shape) -> Dict:
        shape = self._y_shape(sideinfos, pc_shape)
        return {"y0": self._normal(shape),
                "noise": [self._uniform(shape) for _ in
                          range(int(self.opt.Train.argmin_steps) + 1)]}

    def training_step(self, cropped, pc_shape, sideinfos, coords, values,
                      tx, opt_state, draws: Dict = None):
        draws = draws or self.draw_train(sideinfos, pc_shape)
        params = self._coding_params()
        t = self.opt.Train
        Lambda = float(t.Lambda)
        noise = draws["noise"]
        lat = {"y": init_y(None, sideinfos["data_shape"][0], self.y_channel,
                           pc_shape, draws["y0"])}
        _inner_argmin(self._opt_tx(t.optimizer_name_y, t.lr_y), lat,
                      int(t.argmin_steps),
                      lambda l, i: self._loss_rd_un(params, noise[i], coords,
                                                    values, l["y"], Lambda))
        loss = _module_step(params, opt_state, tx, lambda p: self._loss_rd_un(
            p, noise[-1], coords, values, lat["y"], Lambda))
        self.update_quantiles_once()
        return loss, opt_state


class NFLR_Coding_AutoEncoder(_NFLR_Coding):
    """(reference CompressFramework.py:419-439)"""
    MODULE_KEYS = ("phi", "gmod", "emy", "hy")

    def __init__(self, opt, device=None) -> None:
        super().__init__(opt, device)
        self._init_phi_gmod()
        self._init_emy()
        self._init_hy()

    @torch.no_grad()
    def init_compressing_y(self, cropped, sideinfos, pc_shape):
        return self.module["hy"].apply(self.params["hy"], cropped,
                                       int(self.opt.Compress.get("hy_bs", 0)))

    def draw_train(self, sideinfos, pc_shape) -> Dict:
        return {"noise": self._uniform(self._y_shape(sideinfos, pc_shape))}

    def _ae_rd_loss(self, p, noise, cropped, coords, values, Lambda):
        y = self.module["hy"].apply(p["hy"], cropped)
        return self._loss_rd_un(p, noise, coords, values, y, Lambda)

    def training_step(self, cropped, pc_shape, sideinfos, coords, values,
                      tx, opt_state, draws: Dict = None):
        draws = draws or self.draw_train(sideinfos, pc_shape)
        Lambda = float(self.opt.Train.Lambda)
        loss = _module_step(self._module_params(), opt_state, tx,
                            lambda p: self._ae_rd_loss(
                                p, draws["noise"], cropped, coords, values,
                                Lambda))
        self.update_quantiles_once()
        return loss, opt_state


# --------------------------------------------------------------------------
# hyperprior family
# --------------------------------------------------------------------------
class _NFLR_Coding_Hyper(_NFLR_Coding):
    """Mean-scale hyperprior on y (reference CompressFramework.py:441-532)."""

    def _init_hyper(self):
        self.z_channel = int(self.opt.Module.gy.z_channel)
        self.module["gy"] = init_gy(y_channel=self.y_channel,
                                    **dict(self.opt.Module.gy))
        self.params["gy"] = self.module["gy"].init(self.gen, self.device)
        cfg = dict(self.opt.Module.emz)
        cfg.pop("name", None)
        self._emz_tx = make_optimizer(cfg.pop("optimizer_name_quantiles",
                                              "Adam"),
                                      float(cfg.pop("lr_quantiles", 1e-3)))
        self.params["emz"] = em.factorized_init(
            self.gen, self.z_channel,
            filters=tuple(cfg.get("filters", (3, 3, 3, 3))),
            init_scale=float(cfg.get("init_scale", 10)), device=self.device)
        self._emz_opt = self._emz_tx.init(
            {"quantiles": self.params["emz"]["quantiles"]})
        self.module["emz"] = "factorized"
        self.module["emyz"] = "gaussian"
        self._gauss_tables = None
        self.scale_bound = float(self.opt.Module.emyz.get("scale_bound", 0.11))

    def _z_shape(self, sideinfos, pc_shape) -> tuple:
        return latent_shape(sideinfos["data_shape"][0], self.z_channel,
                            pc_shape)

    def _loss_rd_hyper_un(self, params, noise, coords, values, y, z, Lambda):
        """(reference CompressFramework.py:442-452); noise: (U(-0.5, 0.5)
        of z's shape, of y's shape)."""
        noise_z, noise_y = noise
        z_noisy, z_lik = em.factorized_forward(params["emz"], z,
                                               noise=noise_z)
        scales_hat, means_hat = self.module["gy"].apply(params["gy"], z_noisy)
        scales_hat = _exp_scales(scales_hat)
        y_noisy = y + noise_y
        y_lik = em.gaussian_likelihood(y_noisy, scales_hat, means_hat,
                                       self.scale_bound)
        return (loss_bpp_func(y_lik) + loss_bpp_func(z_lik)
                + Lambda * self._distortion(params, coords, y_noisy, values))

    def _loss_rd_hyper_sga(self, params, g, coords, values, y, z, Lambda,
                           tau):
        """(reference CompressFramework.py:453-489); g: (Gumbel draws for
        z, for y), each of shape latent.shape + (2,)."""
        g_z, g_y = g
        z_tilde = sga_relax(None, z, tau, g_z)
        flat, shape, _ = em._to_c1n(z_tilde)
        z_lik = em._from_c1n(
            em.factorized_likelihood(params["emz"], flat), shape)
        scales_hat, means_hat = self.module["gy"].apply(params["gy"], z_tilde)
        scales_hat = _exp_scales(scales_hat)
        y_tilde = sga_relax(None, y, tau, g_y)
        y_lik = em.gaussian_likelihood(y_tilde, scales_hat, means_hat,
                                       self.scale_bound)
        return (loss_bpp_func(y_lik) + loss_bpp_func(z_lik)
                + Lambda * self._distortion(params, coords, y_tilde, values))

    def _hyper_params(self):
        return {**self._module_params(), "emz": self.params["emz"],
                "gy": self.params["gy"]}

    def _module_params(self):
        return {k: self.params[k] for k in ("phi", "gmod")}

    def update_z_quantiles_once(self):
        return _quantile_step(self.params["emz"], self._emz_opt,
                              self._emz_tx)

    def _draw_un(self, y_shape, z_shape):
        return (self._uniform(z_shape), self._uniform(y_shape))

    def draw_sga(self, lat: Dict) -> Dict:
        return {"g": (gumbel(self.gen, tuple(lat["z"].shape) + (2,)),
                      gumbel(self.gen, tuple(lat["y"].shape) + (2,)))}

    def sga_step(self, lat: Dict, opt_yz, tx_yz, coords, values,
                 tau: float, draws: Dict = None) -> torch.Tensor:
        """One SGA step of the latents {"y", "z"} in place -> the loss.
        tx_yz: (y's optimizer, z's), opt_yz: their states."""
        draws = draws or self.draw_sga(lat)
        params = self._hyper_params()
        Lambda = float(self.opt.Train.Lambda)
        loss, g = value_and_grad(
            lambda t: self._loss_rd_hyper_sga(params, draws["g"], coords,
                                              values, t["y"], t["z"],
                                              Lambda, tau), lat)
        for key, tx_k, opt_k in zip(("y", "z"), tx_yz, opt_yz):
            tx_k.step({key: lat[key]}, {key: g[key]}, opt_k)
        return loss

    def compressing_data(self, cropped, sampler, pc_shape, sideinfos,
                         save_path):
        c = self.opt.Compress
        y, z = self.init_compressing_yz(cropped, sideinfos, pc_shape)
        lat = {"y": y, "z": z}
        tx_yz = (self._opt_tx(c.optimizer_name_y, c.lr_y),
                 self._opt_tx(c.optimizer_name_z, c.lr_z))
        opt_yz = (tx_yz[0].init({"y": y}), tx_yz[1].init({"z": z}))
        self._argmin_loop(sampler, lambda coords, values, epoch: self.sga_step(
            lat, opt_yz, tx_yz, coords, values, self._tau(epoch)))
        return self._encode_yz(lat["y"], lat["z"], sideinfos, save_path)

    @torch.no_grad()
    def _scales_means(self, z_np: np.ndarray):
        """gy on the decoded z, on the framework's device -> host arrays
        (scales, means): the same floats at encode and decode time."""
        scales, means = self.module["gy"].apply(
            self.params["gy"], torch.as_tensor(z_np, device=self.device))
        return (_exp_scales(scales).cpu().numpy(), means.cpu().numpy())

    def _encode_yz(self, y, z, sideinfos, save_path):
        """(reference CompressFramework.py:506-517)"""
        z_np, y_np = z.cpu().numpy(), y.cpu().numpy()
        z_tables = em.factorized_build_tables(self.params["emz"])
        z_strings = em.factorized_compress(self.params["emz"], z_tables, z_np)
        z_rec = em.factorized_decompress(self.params["emz"], z_tables,
                                         z_strings, z_np.shape[2:])
        scales, means = self._scales_means(z_rec)
        g_tables = self._gaussian_tables()
        indexes = em.build_indexes(scales, g_tables.scale_table)
        y_strings = em.gaussian_compress(g_tables, y_np, indexes, means)
        sideinfos["z_shape"] = [int(s) for s in z_np.shape[2:]]
        if save_path is not None:
            write_binary_yaml_zip(
                {"y_strings": y_strings, "z_strings": z_strings},
                dict(sideinfos), save_path)
        return {"y_strings": y_strings, "z_strings": z_strings,
                "sideinfos": sideinfos}

    def _gaussian_tables(self):
        if self._gauss_tables is None:
            self._gauss_tables = em.GaussianTables.build()
        return self._gauss_tables

    def decompressing_data(self, compressed_data_path, compressed_data):
        """(reference CompressFramework.py:518-532)"""
        if compressed_data_path is not None:
            blobs, sideinfos = read_binary_yaml_zip(
                ["y_strings", "z_strings"], compressed_data_path)
            compressed_data = {**blobs, "sideinfos": sideinfos}
        sideinfos = compressed_data["sideinfos"]
        z_tables = em.factorized_build_tables(self.params["emz"])
        z = em.factorized_decompress(self.params["emz"], z_tables,
                                     compressed_data["z_strings"],
                                     sideinfos["z_shape"])
        scales, means = self._scales_means(z)
        g_tables = self._gaussian_tables()
        indexes = em.build_indexes(scales, g_tables.scale_table)
        y = em.gaussian_decompress(g_tables, compressed_data["y_strings"],
                                   indexes, means)
        return y, sideinfos

    def init_compressing_yz(self, cropped, sideinfos, pc_shape):
        raise NotImplementedError


class NFLR_Coding_Hyper_AutoDecoder(_NFLR_Coding_Hyper):
    """(reference CompressFramework.py:533-560)"""
    MODULE_KEYS = ("phi", "gmod", "gy", "emz")

    def __init__(self, opt, device=None) -> None:
        super().__init__(opt, device)
        self._init_phi_gmod()
        self._init_hyper()

    def init_compressing_yz(self, cropped, sideinfos, pc_shape):
        n = sideinfos["data_shape"][0]
        return (init_y(self.gen, n, self.y_channel, pc_shape),
                init_z(self.gen, n, self.z_channel, pc_shape))

    def draw_train(self, sideinfos, pc_shape) -> Dict:
        ys = self._y_shape(sideinfos, pc_shape)
        zs = self._z_shape(sideinfos, pc_shape)
        return {"y0": self._normal(ys), "z0": self._normal(zs),
                "noise": [self._draw_un(ys, zs) for _ in
                          range(int(self.opt.Train.argmin_steps) + 1)]}

    def training_step(self, cropped, pc_shape, sideinfos, coords, values,
                      tx, opt_state, draws: Dict = None):
        draws = draws or self.draw_train(sideinfos, pc_shape)
        params = self._hyper_params()
        n = sideinfos["data_shape"][0]
        t = self.opt.Train
        Lambda = float(t.Lambda)
        noise = draws["noise"]
        lat = {"y": init_y(None, n, self.y_channel, pc_shape, draws["y0"]),
               "z": init_z(None, n, self.z_channel, pc_shape, draws["z0"])}
        tx_y = self._opt_tx(t.optimizer_name_y, t.lr_y)
        tx_z = self._opt_tx(t.optimizer_name_z, t.lr_z)
        opt_y, opt_z = tx_y.init({"y": lat["y"]}), tx_z.init({"z": lat["z"]})
        for i in range(int(t.argmin_steps)):
            _, g = value_and_grad(
                lambda l: self._loss_rd_hyper_un(params, noise[i], coords,
                                                 values, l["y"], l["z"],
                                                 Lambda), lat)
            tx_y.step({"y": lat["y"]}, {"y": g["y"]}, opt_y)
            tx_z.step({"z": lat["z"]}, {"z": g["z"]}, opt_z)
        loss = _module_step(params, opt_state, tx,
                            lambda p: self._loss_rd_hyper_un(
                                p, noise[-1], coords, values, lat["y"],
                                lat["z"], Lambda))
        self.update_z_quantiles_once()
        return loss, opt_state

    def _train_params(self):
        return self._hyper_params()


class NFLR_Coding_Hyper_AutoEncoder(_NFLR_Coding_Hyper):
    """(reference CompressFramework.py:561-588)"""
    TRAIN_KEYS = ("phi", "gmod", "gy", "emz", "hy", "hz")

    def __init__(self, opt, device=None) -> None:
        super().__init__(opt, device)
        self._init_phi_gmod()
        self._init_hyper()
        self._init_hy()
        self.module["hz"] = init_hz(y_channel=self.y_channel,
                                    z_channel=self.z_channel,
                                    layers=int(self.opt.Module.gy.layers),
                                    **dict(self.opt.Module.hz))
        self.params["hz"] = self.module["hz"].init(self.gen, self.device)

    @torch.no_grad()
    def init_compressing_yz(self, cropped, sideinfos, pc_shape):
        y = self.module["hy"].apply(self.params["hy"], cropped,
                                    int(self.opt.Compress.get("hy_bs", 0)))
        z = self.module["hz"].apply(self.params["hz"], y)
        return y, z

    def draw_train(self, sideinfos, pc_shape) -> Dict:
        return {"noise": self._draw_un(self._y_shape(sideinfos, pc_shape),
                                       self._z_shape(sideinfos, pc_shape))}

    def _ae_hyper_loss(self, p, noise, cropped, coords, values, Lambda):
        y = self.module["hy"].apply(p["hy"], cropped)
        z = self.module["hz"].apply(p["hz"], y)
        return self._loss_rd_hyper_un(p, noise, coords, values, y, z, Lambda)

    def training_step(self, cropped, pc_shape, sideinfos, coords, values,
                      tx, opt_state, draws: Dict = None):
        draws = draws or self.draw_train(sideinfos, pc_shape)
        Lambda = float(self.opt.Train.Lambda)
        loss = _module_step(self._train_params(), opt_state, tx,
                            lambda p: self._ae_hyper_loss(
                                p, draws["noise"], cropped, coords, values,
                                Lambda))
        self.update_z_quantiles_once()
        return loss, opt_state

    def _train_params(self):
        return {k: self.params[k] for k in self.TRAIN_KEYS}


# --------------------------------------------------------------------------
# registry + batch evaluator
# --------------------------------------------------------------------------
ALLCF = {
    "NFLR_AutoDecoder": NFLR_AutoDecoder,
    "NFLR_AutoEncoder": NFLR_AutoEncoder,
    "NFLR_Coding_AutoDecoder": NFLR_Coding_AutoDecoder,
    "NFLR_Coding_AutoEncoder": NFLR_Coding_AutoEncoder,
    "NFLR_Coding_Hyper_AutoDecoder": NFLR_Coding_Hyper_AutoDecoder,
    "NFLR_Coding_Hyper_AutoEncoder": NFLR_Coding_Hyper_AutoEncoder,
}


def init_compressframework(opt, device=None):
    """(reference CompressFramework.py:591-594)"""
    return ALLCF[opt.Name](opt, device)


PERFORMANCE_COLUMNS = ["data_path", "mse", "psnr", "ssim",
                       "compressed_data_Mbytes", "orig_data_Mbytes",
                       "compress_ratio"]


def _write_performance(rows: List[list], path: str):
    """performance.csv as DataFrame.to_csv writes it (index column first);
    returns the DataFrame, or a dict of column arrays without pandas."""
    try:
        import pandas as pd
    except ImportError:
        import csv
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow([""] + PERFORMANCE_COLUMNS)
            for i, row in enumerate(rows):
                w.writerow([i] + [repr(v) if isinstance(v, float) else v
                                  for v in row])
        return {k: np.asarray([r[j] for r in rows])
                for j, k in enumerate(PERFORMANCE_COLUMNS)}
    df = pd.DataFrame(rows, columns=PERFORMANCE_COLUMNS)
    df.to_csv(path)
    return df


def eval_performance(data_path_list_list: List[List[str]], compressframework,
                     save_dir: str, keep_data: bool = True, max=None):
    """Batch compress/decompress evaluator -> table + performance.csv
    (reference CompressFramework.py:596-642), the JAX package's columns."""
    from brief_pytorch_tpu_torch.eval.metrics import cal_ssim
    os.makedirs(save_dir, exist_ok=True)
    rows = []
    for data_path_list in data_path_list_list:
        comp_path = opj(save_dir, opb(ops(data_path_list[0])[0])
                        + "_compressed")
        dec_paths = [opj(save_dir, opb(ops(p)[0]) + "_decompressed"
                         + ops(p)[-1]) for p in data_path_list]
        compressed = compressframework.compress(data_path_list, comp_path)
        decompressed = compressframework.decompress(
            compressed_data=compressed, save_path_list=dec_paths)
        orig = read_data_batch(data_path_list)
        rng = max
        if rng is None:
            # 4098 for "uint12" replicates the reference's constant
            rng = {"uint8": 255, "uint12": 4098,
                   "uint16": 65535}[orig.dtype.name]
        mse = float(np.mean((orig / rng - decompressed / rng) ** 2))
        psnr = float(-10 * np.log10(mse))
        ssim_vals = [cal_ssim(np.moveaxis(orig[i], 0, -1),
                              np.moveaxis(np.asarray(decompressed[i]), 0, -1),
                              rng, device=compressframework.device)
                     for i in range(orig.shape[0])]
        # the PRODUCT of per-file megabytes, as the reference computes it
        # (CompressFramework.py:633): meaningless for multi-file batches
        orig_mb = float(np.prod([os.path.getsize(p) / 2 ** 20
                                 for p in data_path_list]))
        comp_mb = os.path.getsize(comp_path) / 2 ** 20
        rows.append([str(data_path_list), mse, psnr,
                     float(np.mean(ssim_vals)), comp_mb, orig_mb,
                     orig_mb / comp_mb])
        if not keep_data:
            os.remove(comp_path)
            for p in dec_paths:
                os.remove(p)
    return _write_performance(rows, opj(save_dir, "performance.csv"))
