"""Config schema as dataclass documentation.

Copy of brief_pytorch_tpu/core/typing.py (reference utils/Typing.py:
1-146): the reference uses these dataclasses for type hints only (never
instantiated or enforced); they document the YAML schema that both
packages read.  Field comments note semantics the YAML files rely on.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List


@dataclass
class DivideOpt:
    """Partitioning (reference Typing.py divideopt)."""
    divide_type: str = "none"   # none | total_nd_nh_nw | every_d_h_w |
    #                             adaptotal_dn_hn_wn_Nb |
    #                             adaptive_maxl_minl_varthr_ethr_Nb
    param_alloc: str = "by_dv"  # equal | by_size | by_var | by_d | by_dv
    param_size_thres: float = 26
    exception: Any = "none"     # per-chunk override dict merged at dispatch
    zslice: str = "none"
    module_7z: bool = False


@dataclass
class SamplerOpt:
    name: str = "randomcube"    # randomcube | randompoint
    cube_count: int = 1
    cube_len: List[int] = field(default_factory=lambda: [1e7, 1e7, 1e7])
    sample_size: int = 100000
    gpu_force: bool = True
    # randompoint only: draw sample_size/L contiguous L-voxel runs instead
    # of L=1 iid voxels (vectorised gather; see train/samplers.py)
    vector_len: int = 1


@dataclass
class DenoiseOpt:
    level: int = 0              # zero out values <= level
    close: Any = False          # False or [k, k, k] morphological opening


@dataclass
class PreprocessOpt:
    denoise: DenoiseOpt = field(default_factory=DenoiseOpt)
    clip: List[int] = field(default_factory=lambda: [0, 65535])


@dataclass
class ParamOpt:
    filesize_ratio: float = 0   # exactly one of filesize_ratio/given_size
    given_size: float = 0
    init_net_path: str = "none"  # warm start from a saved module dir


@dataclass
class LossOpt:
    name: str = "datal2"        # datal2 | datasmoothl1
    beta: float = 0.01
    weight: List[str] = field(default_factory=lambda: ["none"])
    weight_thres: float = 0


@dataclass
class CompressOpt:
    divide: DivideOpt = field(default_factory=DivideOpt)
    half: bool = False          # bf16 compute, 2-byte size accounting
    module_serializing_method: str = "rawbinary"
    sampler: SamplerOpt = field(default_factory=SamplerOpt)
    coords_mode: str = "-1,1"   # 'n11' | '0p1' | 'min,max'
    preprocess: PreprocessOpt = field(default_factory=PreprocessOpt)
    param: ParamOpt = field(default_factory=ParamOpt)
    loss: LossOpt = field(default_factory=LossOpt)
    gpu: bool = True
    max_steps: int = 20000
    checkpoints: str = "every_2000"  # none | every_n | int | 'a,b,c'
    loss_log_freq: int = 200
    lr_phi: float = 1e-3
    optimizer_name_phi: str = "Adamax"
    lr_scheduler_phi: Any = None
    decompress: bool = True
    # resume a preempted run from a trainstate.npz (params + optimizer
    # state + PRNG key + step, written to the run dir at every checkpoint;
    # train/checkpoint.py).  "none", a state file, or a run dir.  Beyond
    # the reference (its checkpoints are outputs only, no optimizer-state
    # resume — SURVEY.md §5); a resumed run is bit-identical to an
    # uninterrupted one (tested).
    resume: str = "none"


@dataclass
class DecompressOpt:
    gpu: bool = True
    sample_size: int = 10000    # grid-inference slab size
    postprocess: PreprocessOpt = field(default_factory=PreprocessOpt)
    keep_decompressed: bool = True
    mip: bool = True
    mse: bool = True
    psnr: bool = True
    ssim: bool = True


@dataclass
class CropOpt:
    """NFLR patch grid (reference Typing.py CropOpt); ps_* power of two."""
    ps_d: int = 8
    ps_h: int = 8
    ps_w: int = 8
    ol_d: int = 2
    ol_h: int = 2
    ol_w: int = 2


@dataclass
class ModuleOpt:
    phi: Any = None             # models.phi config (name + hyperparams)
    projector: Any = None
    gmod: Any = None            # Modulator | CropModulator
    gf: Any = None
    hy: Any = None              # CropConv3dStridedown | Conv3dStridedownPooling
    emy: Any = None             # UnivariateNonParametricEntropyModel
    gy: Any = None              # PlainConv3dMeanScale
    emz: Any = None
    emyz: Any = None            # GaussianConditionalEntropyModel
    hz: Any = None              # PlainConv3dChannelShrink
    crop: CropOpt = field(default_factory=CropOpt)


@dataclass
class NormalizeOpt:
    name: str = "minmaxany_0_100"


@dataclass
class DatasetOpt:
    data_path: str = ""


@dataclass
class TransformOpt:
    Crop3d: Any = None
    RandomCrop3d: Any = None
    Resize3d: Any = None
    RandomResize3d: Any = None
    FlipRoat3d: Any = None


@dataclass
class TrainOpt:
    """NFLR training (reference Typing.py TrainOpt)."""
    train_data_dir: str = ""
    val_data_dir: str = ""
    sample_size: int = 512
    batch_size: int = 1
    max_steps: int = 10000
    gpu: bool = True
    log_every_n_step: int = 100
    val_every_n_step: int = 1000
    val_every_n_epoch: int = 10
    val_data_quanity: int = 1
    optimizer_name_module: str = "Adam"
    lr_module: float = 1e-4
    argmin_steps: int = 16
    optimizer_name_y: str = "Adam"
    lr_y: float = 1e-2
    optimizer_name_z: str = "Adam"
    lr_z: float = 1e-2
    Lambda: float = 100.0       # loss = R + Lambda * D
    transform: TransformOpt = field(default_factory=TransformOpt)


@dataclass
class CompressFrameworkOpt:
    Name: str = "NFGR"          # NFGR or any nflr.ALLCF key
    Compress: CompressOpt = field(default_factory=CompressOpt)
    Decompress: DecompressOpt = field(default_factory=DecompressOpt)
    Module: ModuleOpt = field(default_factory=ModuleOpt)
    Normalize: NormalizeOpt = field(default_factory=NormalizeOpt)


@dataclass
class LogOpt:
    outputs_dir: str = "outputs"
    project_name: str = "run"
    stdlog: bool = False
    tensorboard: bool = True
    time: bool = False


@dataclass
class ReproducOpt:
    seed: int = 42
    benchmark: bool = False
    deterministic: bool = True


@dataclass
class SingleTaskOpt:
    Reproduc: ReproducOpt = field(default_factory=ReproducOpt)
    CompressFramework: CompressFrameworkOpt = field(
        default_factory=CompressFrameworkOpt)
    Log: LogOpt = field(default_factory=LogOpt)
    Dataset: DatasetOpt = field(default_factory=DatasetOpt)


@dataclass
class MultiTaskOpt:
    Dynamic: Any = None         # nested PRODUCT/CONCAT combinator tree
    Static: SingleTaskOpt = field(default_factory=SingleTaskOpt)
