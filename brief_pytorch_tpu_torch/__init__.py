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
  core/      device selection, coordinates, normalisation, config system,
             parameter trees
  models/    the eleven φ families (SIREN and its variants, NeRF, FFN,
             MFNFourier, MFNGabor) and closed-form sizing
  ops/       fast sine, the three kernels and their plain versions, the
             build (ops/build.py, nvcc on ops/csrc/)
  train/     the fit loop (SingleTask), samplers, losses, optimisers,
             grid decode, training state (resume)
  parallel/  the DivideTask block fleet and its runner, ranks over
             torch.distributed, data parallelism
  partition/ the DivideTask block plans (regular divides, the adaptive
             quad/oct tree)
  nflr/      NFLR: cropped latents, modulated SIRENs, entropy models, rANS
  io/        TIFF/PNG/JPG/MP4/YUV I/O, the raw-binary weight format,
             archives
  eval/      PSNR/SSIM/MS-SSIM/MIP metrics
  post/      denoise/clip preprocessing, deblocking
  sched/     MultiTask experiments
  cli/       the command line (main, multitask), the reference YAML schema
  utils/     logging, profiling (trace, annotate, ThroughputMeter)

The kernels (ops/csrc/, one per pl.pallas_call of the JAX package)
  1. the fused train step, forward + loss + backward of a chain or a
     fleet of chains (fused_train.cu, fused_train_stream.cu;
     ops/fused_train.py, ops/stream.py);
  2. the full-grid decode, coordinates built in the kernel
     (fused_decode.cu, chain_tc.cuh, chain_stream.cuh;
     ops/fused_decode.py, ops/chain_stream.py);
  3. the batch-major chain forward over rows of an (N, C) input
     (fused_siren.cu on the same chains; ops/fused_siren.py).
"""

__version__ = "0.1.0"
