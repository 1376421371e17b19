"""brief_pytorch_tpu_torch — the PyTorch/CUDA port of brief_pytorch_tpu.

Compresses a biomedical volume by overfitting a small coordinate network
(an implicit neural function) and decompresses it by evaluating that
network over the full voxel grid.  The layout mirrors brief_pytorch_tpu,
so each module sits at the same path as its JAX counterpart; the Pallas
TPU kernels become hand-written CUDA kernels for Hopper (sm_90a) under
ops/csrc/, each beside a plain PyTorch version of the same function.

Entry points run on the CUDA card unless the caller asks for the CPU
(device="cpu", or `-g cpu` on the CLI); with no card they raise.

Subpackages
  core/    device selection, coordinates, normalisation, config system
  models/  the φ chain (SIREN) and closed-form sizing
  ops/     fast sine, the fused train-step and grid-decode kernels
  train/   the fit loop, samplers, losses, optimisers, grid decode
  io/      TIFF I/O and the raw-binary weight interchange format
  eval/    PSNR/SSIM/MIP metrics
  post/    denoise/clip preprocessing, per-voxel weights, checkpoints
  cli/     command-line entry point accepting the reference YAML schema
"""

__version__ = "0.1.0"
