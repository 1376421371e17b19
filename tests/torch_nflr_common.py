"""Shared set-up of the tests/test_torch_nflr_*.py files: the NFLR config
of tests/test_nflr.py (SIREN 4 x 16, y_channel 8, ps 8, ol 2), tiny 16^3
volumes, and the two packages' frameworks on the same weights."""
import numpy as np
import torch

NAMES = ["NFLR_AutoDecoder", "NFLR_AutoEncoder", "NFLR_Coding_AutoDecoder",
         "NFLR_Coding_AutoEncoder", "NFLR_Coding_Hyper_AutoDecoder",
         "NFLR_Coding_Hyper_AutoEncoder"]


def opt_yaml(name: str, sample_size: int = 128, train_steps: int = 4,
             sga_steps: int = 6, argmin_steps: int = 2) -> str:
    return f"""
Name: {name}
seed: 0
Module:
  phi: {{name: SIREN, coords_channel: 3, data_channel: 1, features: 16,
        layers: 4, w0: 30, res: false, output_act: false}}
  gmod: {{name: CropModulator, y_channel: 8}}
  crop: {{ps_d: 8, ps_h: 8, ps_w: 8, ol_d: 2, ol_h: 2, ol_w: 2}}
  hy: {{name: CropConv3dStridedown}}
  hz: {{name: PlainConv3dChannelShrink}}
  gy: {{name: PlainConv3dMeanScale, z_channel: 4, layers: 2}}
  emy: {{name: UnivariateNonParametricEntropyModel, init_scale: 10,
        optimizer_name_quantiles: Adam, lr_quantiles: 0.001}}
  emz: {{name: UnivariateNonParametricEntropyModel, init_scale: 10,
        optimizer_name_quantiles: Adam, lr_quantiles: 0.001}}
  emyz: {{name: GaussianConditionalEntropyModel, scale_bound: 0.11,
         tail_mass: 1.0e-9}}
Train:
  batch_size: 1
  sample_size: {sample_size}
  max_steps: {train_steps}
  log_every_n_step: 2
  val_every_n_step: 1000000
  val_data_quanity: 1
  optimizer_name_module: Adam
  lr_module: 0.0001
  optimizer_name_y: Adam
  lr_y: 0.01
  optimizer_name_z: Adam
  lr_z: 0.01
  argmin_steps: {argmin_steps}
  Lambda: 100
Compress:
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
  sample_size: {sample_size}
Normalize: {{name: minmaxany_0_100}}
"""


def port_opt(name, **kw):
    from brief_pytorch_tpu_torch.core import config as cfglib
    return cfglib.loads(opt_yaml(name, **kw))


def write_volumes(directory, n: int = 2):
    """n smooth 16^3 uint16 volumes with noise -> their paths."""
    from brief_pytorch_tpu_torch.io.image import save_img
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        z, y, x = np.meshgrid(*[np.linspace(0, 1, 16)] * 3, indexing="ij")
        vol = (20000 + 20000 * np.sin(4 * z + i) * np.cos(3 * y) * x
               + rng.normal(0, 200, (16, 16, 16)))
        path = str(directory / f"vol{i}.tif")
        save_img(path, np.clip(vol, 0, 65535).astype(np.uint16)[..., None])
        paths.append(path)
    return paths


def t(a) -> torch.Tensor:
    """A JAX or numpy array -> a float32 CPU tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


def assert_tree_close(port_tree, jax_tree, rtol, atol, what=""):
    from brief_pytorch_tpu_torch.core.tree import tree_leaves_sorted
    import jax
    pl = tree_leaves_sorted(port_tree)
    jl = jax.tree_util.tree_leaves(jax_tree)
    assert len(pl) == len(jl), what
    for i, (p, j) in enumerate(zip(pl, jl)):
        np.testing.assert_allclose(p.detach().cpu().numpy(), np.asarray(j),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what} leaf {i}")
