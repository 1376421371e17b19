"""One NFLR rate-distortion point on a volume: the library side of
scripts/nflr_rd_torch.py (the port's twin of scripts/nflr_rd.py), which
chip_smoke.py's phase 18 drives too.

  opt = rd_opt(variant, features=48, layers=5, y_channel=24, ...)
  fw = init_compressframework(opt, device)
  timing, losses = train_on_volume(fw, volume, steps)
  result = rd_point(fw, volume, comp_path)

train_on_volume trains on one CropDataset draw: when the whole patch
population fits one sampler batch (ps^3 <= sample_size) every step sees
that batch (the batch-internal order does not change the loss), as the
JAX script's training_segment does; else it walks the dataset as
_BaseNFLR.train does.  rd_point compresses to the rANS container, decodes
from memory and from the file, and reports bits per voxel and PSNR on the
uint16 range.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from brief_pytorch_tpu_torch.core import config as cfglib


def rd_opt(variant: str, features: int = 48, layers: int = 5,
           y_channel: int = 24, ps: int = 8, ol: int = 2,
           sample_size: int = 4096, dec_sample_size: int = 32768,
           steps: int = 30000, sga_steps: int = 3000,
           argmin_steps: int = 3, lr: float = 2e-4, Lambda: float = 2000.0,
           seed: int = 0):
    """The RD script's config (scripts/nflr_rd.py build_opt), verbatim."""
    return cfglib.loads(f"""
Name: {variant}
seed: {seed}
Module:
  phi: {{name: SIREN, coords_channel: 3, data_channel: 1,
        features: {features}, layers: {layers}, w0: 30,
        res: false, output_act: false}}
  gmod: {{name: CropModulator, y_channel: {y_channel}}}
  crop: {{ps_d: {ps}, ps_h: {ps}, ps_w: {ps},
          ol_d: {ol}, ol_h: {ol}, ol_w: {ol}}}
  hy: {{name: CropConv3dStridedown}}
  hz: {{name: PlainConv3dChannelShrink}}
  gy: {{name: PlainConv3dMeanScale, z_channel: {max(4, y_channel // 4)}, layers: 2}}
  emy: {{name: UnivariateNonParametricEntropyModel, init_scale: 10,
        optimizer_name_quantiles: Adam, lr_quantiles: 0.001}}
  emz: {{name: UnivariateNonParametricEntropyModel, init_scale: 10,
        optimizer_name_quantiles: Adam, lr_quantiles: 0.001}}
  emyz: {{name: GaussianConditionalEntropyModel, scale_bound: 0.11,
         tail_mass: 1.0e-9}}
Train:
  gpu: true
  batch_size: 1
  sample_size: {sample_size}
  max_steps: {steps}
  log_every_n_step: 500
  val_every_n_step: 1000000000
  val_every_n_epoch: 1000000000
  val_data_quanity: 1
  optimizer_name_module: Adam
  lr_module: {lr}
  optimizer_name_y: Adam
  lr_y: 0.01
  optimizer_name_z: Adam
  lr_z: 0.01
  argmin_steps: {argmin_steps}
  Lambda: {Lambda}
Compress:
  gpu: true
  sample_size: {sample_size}
  max_steps: {sga_steps}
  optimizer_name_y: Adam
  lr_y: 0.01
  optimizer_name_z: Adam
  lr_z: 0.01
  hy_bs: 0
  annealing_rate: 0.001
  init_temperature: 0.5
  annealing_scheme: exp0
  t0: 700
Decompress:
  gpu: true
  sample_size: {dec_sample_size}
Normalize: {{name: minmaxany_0_100}}
""")


def train_on_volume(fw, volume: str, steps: int, log_every: int = 500,
                    log=print) -> Tuple[dict, List[Tuple[int, float]]]:
    """`steps` training steps of fw on one volume -> (timing, losses).

    timing is utils.profiling.timed_loop's (wall and device time per
    step, idle share, the top kernels); losses are (step, loss) every
    log_every steps and at the first and last step."""
    from brief_pytorch_tpu_torch.nflr.crop import CropDataset
    from brief_pytorch_tpu_torch.train.optim import make_optimizer
    from brief_pytorch_tpu_torch.utils.profiling import timed_loop
    t = fw.opt.Train
    ds = CropDataset(1, int(t.sample_size), fw.opt.Normalize, None,
                     fw.opt.Module.crop, True, True, data_path_list=[volume],
                     seed=0, device=fw.device)
    tx = make_optimizer(t.optimizer_name_module, float(t.lr_module))
    state = {"opt": tx.init(fw._train_params())}
    losses: List[Tuple[int, float]] = []
    cropped, sampler, pc_shape, side = next(iter(ds))
    if len(sampler) == 1:
        coords, values = next(iter(sampler))

        def batches():
            while True:
                yield cropped, pc_shape, side, coords, values
    else:
        def batches():
            while True:
                for (cr, smp, pc, sd) in ds:
                    for (c, v) in smp:
                        yield cr, pc, sd, c, v
    it = batches()

    def step(i):
        loss, state["opt"] = fw.training_step(*next(it), tx, state["opt"])
        k = i + 1
        if k == 1 or k % log_every == 0 or k == steps:
            losses.append((k, float(loss)))
            if log is not None:
                log(f"step {k}/{steps} loss {losses[-1][1]:.4f}")

    timing = timed_loop(step, steps, device=fw.device)
    return timing, losses


def rd_point(fw, volume: str, comp_path: str) -> dict:
    """Compress `volume` to comp_path, decode from memory and from the
    file; bits per voxel, PSNR (uint16 range) and the two decodes."""
    from brief_pytorch_tpu_torch.io.image import read_img
    compressed = fw.compress([volume], comp_path)
    dec_mem = fw.decompress(compressed_data=compressed)
    dec_file = fw.decompress(compressed_data_path=comp_path)
    orig = read_img(volume)                       # (d, h, w, 1) uint16
    dec = np.moveaxis(dec_file[0], 0, -1)         # (1, c, d, h, w)
    mse = float(np.mean((dec.astype(np.float64)
                         - orig.astype(np.float64)) ** 2))
    nbytes = os.path.getsize(comp_path)
    return {"file_bytes": nbytes,
            "ratio": os.path.getsize(volume) / nbytes,
            "bits_per_voxel": nbytes * 8 / orig.size,
            "psnr_uint16": float(-10.0 * np.log10(mse / 65535.0 ** 2)),
            "mse": mse,
            "bits_roundtrip_equal": bool(np.array_equal(dec_mem, dec_file)),
            "compressed": compressed, "decoded": dec_file, "orig": orig}
