"""NFLR network modules as init/apply pairs on plain parameter trees.

Torch port of brief_pytorch_tpu/nflr/networks.py (reference
utils/Networks.py: Modulator/CropModulator 929-981, Conv3dStridedownPooling
984-1013, CropConv3dStridedown 1014-1060, PlainConv3dChannelShrink (hz)
1097-1128, PlainConv3dMeanScale (gy) 1130-1162, Projector 803-856,
SIREN.forward_syn 272-290, the init registries).  Parameters are nested
dicts and lists of float32 tensors with the JAX package's keys: linear
weights (in, out) as in models/phi.py, convolution weights (out, in, kd,
kh, kw) in NCDHW/OIDHW layout, torch's own, so numpy weights carry across
unchanged (framework.params_from_numpy).

Every convolution runs through `conv3d`: F.conv3d with cuDNN's TF32 off,
deterministic algorithms and benchmark mode off, scoped to the call, so
that the hyperprior's scales and means come out the same at encode and at
decode time in any process.  Initialisation follows torch Conv/Linear
defaults (U(+-1/sqrt(fan_in))), drawn from a torch.Generator.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from brief_pytorch_tpu_torch.models.phi import _matmul, _uniform, init_linear
from brief_pytorch_tpu_torch.ops.fast_math import fast_sin_cached


# --------------------------------------------------------------------------
# small building blocks
# --------------------------------------------------------------------------
def init_conv3d(gen: torch.Generator, c_in: int, c_out: int,
                ksize: Tuple[int, int, int], device=None
                ) -> Dict[str, torch.Tensor]:
    """torch nn.Conv3d default init: U(+-1/sqrt(fan_in)), fan_in=c_in*prod(k)."""
    fan_in = c_in * math.prod(ksize)
    bound = 1.0 / math.sqrt(fan_in)
    w = _uniform(gen, (c_out, c_in) + tuple(ksize), bound, device)
    b = _uniform(gen, (c_out,), bound, device)
    return {"w": w, "b": b}


def conv3d(x: torch.Tensor, p: Dict, stride=(1, 1, 1), padding=(1, 1, 1)
           ) -> torch.Tensor:
    """NCDHW conv with symmetric padding; TF32 off, deterministic."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        out = F.conv3d(x, p["w"], stride=tuple(stride),
                       padding=tuple(int(q) for q in padding))
    return out + p["b"][None, :, None, None, None]


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """jax.nn.leaky_relu: where(x >= 0, x, slope * x) (gradient 1 at 0)."""
    return torch.where(x >= 0, x, slope * x)


def adaptive_pool3d(x: torch.Tensor, out_shape: Tuple[int, int, int],
                    mode: str) -> torch.Tensor:
    """torch AdaptiveAvg/MaxPool3d semantics: window i covers
    [floor(i*in/out), ceil((i+1)*in/out)); written as the JAX package
    writes it (amax spreads a tie's gradient evenly, as jnp.max does)."""
    for axis, out_n in enumerate(out_shape):
        dim = 2 + axis
        in_n = x.shape[dim]
        pieces = []
        for i in range(out_n):
            lo = (i * in_n) // out_n
            hi = -(-((i + 1) * in_n) // out_n)
            seg = x.narrow(dim, lo, hi - lo)
            pieces.append(seg.mean(dim, keepdim=True) if mode == "avg"
                          else seg.amax(dim, keepdim=True))
        x = torch.cat(pieces, dim=dim)
    return x


# --------------------------------------------------------------------------
# gmod: latent -> per-layer modulation vectors
# --------------------------------------------------------------------------
class Modulator:
    """ReLU MLP with skip-concat of y at every layer; one output per phi
    hidden layer (reference Networks.py:929-952)."""
    name = "Modulator"

    def __init__(self, y_channel: int, dim_hidden: int, layers: int, **_):
        self.y_channel = y_channel
        self.dim_hidden = dim_hidden
        self.layers = layers

    def init(self, gen: torch.Generator, device=None) -> Dict:
        net = []
        for i in range(self.layers):
            fan_in = self.y_channel if i == 0 else \
                self.dim_hidden + self.y_channel
            net.append(init_linear(gen, fan_in, self.dim_hidden, "default",
                                   device))
        return {"net": net}

    def apply(self, params: Dict, y: torch.Tensor, compute_dtype=None
              ) -> List[torch.Tensor]:
        """y: (..., y_channel) -> list of (..., dim_hidden) modulations."""
        mod = y
        mods = []
        for lin in params["net"]:
            mod = torch.relu(_matmul(mod, lin["w"], compute_dtype) + lin["b"])
            mods.append(mod)
            mod = torch.cat([mod, y], dim=-1)
        return mods


class CropModulator(Modulator):
    """Modulator over (n, c, pc_d, pc_h, pc_w) latent grids
    (reference Networks.py:953-979): returns mods shaped
    (n, dim_hidden, pc_d, pc_h, pc_w)."""
    name = "CropModulator"

    def apply(self, params: Dict, y: torch.Tensor, compute_dtype=None
              ) -> List[torch.Tensor]:
        n, c, *pc = y.shape
        flat = torch.movedim(y, 1, -1).reshape(-1, c)
        mods = super().apply(params, flat, compute_dtype)
        return [torch.movedim(m.reshape(n, *pc, self.dim_hidden), -1, 1)
                for m in mods]


ALLGMOD = {"Modulator": Modulator, "CropModulator": CropModulator}


def init_gmod(**kwargs):
    """(reference Networks.py:980-981)"""
    return ALLGMOD[kwargs.pop("name")](**kwargs)


# --------------------------------------------------------------------------
# modulated SIREN synthesis
# --------------------------------------------------------------------------
def siren_forward_syn(layers: Sequence[Dict], coords: torch.Tensor,
                      mods: Sequence[torch.Tensor], w0: float = 30.0,
                      first_w0: float = 30.0, compute_dtype=None
                      ) -> torch.Tensor:
    """Modulated SIREN forward for patch grids.

    coords: (n, *pc, pop, c); mods[l]: (n, dim_hidden, *pc).
    Per layer: h = sin(w0 * linear(h)) * sigmoid(mod_l); the output layer
    is unmodulated (reference SIREN.forward_syn, Networks.py:272-282).
    """
    h = coords
    for li, (lin, mod) in enumerate(zip(layers[:-1], mods)):
        z = _matmul(h, lin["w"], compute_dtype) + lin["b"]
        h = fast_sin_cached((first_w0 if li == 0 else w0) * z)
        m = torch.movedim(mod, 1, -1)          # (n, *pc, dim_hidden)
        h = (h * torch.sigmoid(m)[..., None, :]).to(coords.dtype)
    out = layers[-1]
    return _matmul(h, out["w"], compute_dtype) + out["b"]


def siren_forward_syn_wocrop(layers: Sequence[Dict], coords: torch.Tensor,
                             mods: Sequence[torch.Tensor], w0: float = 30.0,
                             first_w0: float = 30.0, compute_dtype=None
                             ) -> torch.Tensor:
    """Un-cropped variant (reference Networks.py:283-290):
    coords (n, pop, c); mods[l]: (n, dim_hidden)."""
    h = coords
    for li, (lin, mod) in enumerate(zip(layers[:-1], mods)):
        z = _matmul(h, lin["w"], compute_dtype) + lin["b"]
        h = fast_sin_cached((first_w0 if li == 0 else w0) * z)
        h = h * torch.sigmoid(mod)[:, None, :]
    out = layers[-1]
    return _matmul(h, out["w"], compute_dtype) + out["b"]


# --------------------------------------------------------------------------
# hy: data patches -> latent y (analysis transforms)
# --------------------------------------------------------------------------
class CropConv3dStridedown:
    """Stride-2 conv stack collapsing each (ps_d, ps_h, ps_w) patch to one
    y vector (reference Networks.py:1014-1058, Balle'18)."""
    name = "CropConv3dStridedown"

    def __init__(self, ps_d: int, ps_h: int, ps_w: int, data_channel: int,
                 y_channel: int, **_):
        self.n_layers = int(math.log2(min(ps_d, ps_h, ps_w)))
        self.data_channel = data_channel
        self.y_channel = y_channel

    def init(self, gen: torch.Generator, device=None) -> Dict:
        convs = []
        for i in range(self.n_layers):
            cin = self.data_channel if i == 0 else self.y_channel
            convs.append(init_conv3d(gen, cin, self.y_channel, (3, 3, 3),
                                     device))
        head = init_conv3d(gen, self.y_channel, self.y_channel, (1, 1, 1),
                           device)
        return {"convs": convs, "head": head}

    def apply(self, params: Dict, cropped: torch.Tensor, bs: int = 0
              ) -> torch.Tensor:
        """cropped: (n, pc_d, pc_h, pc_w, c, ps_d, ps_h, ps_w)
        -> y (n, y_channel, pc_d, pc_h, pc_w)."""
        n, pc_d, pc_h, pc_w, c, ps_d, ps_h, ps_w = cropped.shape
        x = cropped.reshape(-1, c, ps_d, ps_h, ps_w)
        for i, conv in enumerate(params["convs"]):
            x = conv3d(x, conv, stride=(2, 2, 2), padding=(1, 1, 1))
            if i < self.n_layers - 1:
                x = torch.relu(x)
            else:
                x = x.amax(dim=(2, 3, 4), keepdim=True)  # AdaptiveMaxPool(1)
                x = conv3d(x, params["head"], stride=(1, 1, 1),
                           padding=(0, 0, 0))
        y = x.reshape(n, pc_d, pc_h, pc_w, self.y_channel)
        return torch.movedim(y, -1, 1)


class Conv3dStridedownPooling:
    """Whole-volume encoder: strided convs + adaptive avg/max pooling to a
    (4,10,10) grid + 1x1 conv + flatten (reference Networks.py:984-1013)."""
    name = "Conv3dStridedownPooling"
    POOL = (4, 10, 10)

    def __init__(self, data_channel: int, y_channel: int,
                 stridedown_layers: int, **_):
        self.data_channel = data_channel
        self.y_channel = y_channel
        self.n_layers = stridedown_layers
        self.dim_hidden = y_channel // math.prod(self.POOL)

    def init(self, gen: torch.Generator, device=None) -> Dict:
        convs = []
        for i in range(self.n_layers):
            cin = self.data_channel if i == 0 else \
                self.dim_hidden // 2 ** (self.n_layers - i)
            cout = self.dim_hidden // 2 ** (self.n_layers - i - 1)
            convs.append(init_conv3d(gen, cin, cout, (5, 5, 5), device))
        tail = init_conv3d(gen, self.dim_hidden * 2, self.dim_hidden,
                           (1, 1, 1), device)
        return {"convs": convs, "tail": tail}

    def apply(self, params: Dict, data: torch.Tensor, bs: int = 0
              ) -> torch.Tensor:
        """data: (n, c, d, h, w) -> y (n, y_channel)."""
        x = data
        for conv in params["convs"]:
            x = torch.relu(conv3d(x, conv, stride=(2, 2, 2),
                                  padding=(2, 2, 2)))
        avg = adaptive_pool3d(x, self.POOL, "avg")
        mx = adaptive_pool3d(x, self.POOL, "max")
        y = conv3d(torch.cat([avg, mx], dim=1), params["tail"],
                   stride=(1, 1, 1), padding=(0, 0, 0))
        return y.reshape(y.shape[0], -1)


ALLHY = {"CropConv3dStridedown": CropConv3dStridedown,
         "Conv3dStridedownPooling": Conv3dStridedownPooling}


def init_hy(**kwargs):
    """(reference Networks.py:1059-1060)"""
    name = kwargs.pop("name")
    if name == "Conv3dStridedownPooling":
        kwargs = {k: v for k, v in kwargs.items()
                  if k in ("data_channel", "y_channel", "stridedown_layers")}
    return ALLHY[name](**kwargs)


# --------------------------------------------------------------------------
# hz / gy: hyperprior transforms
# --------------------------------------------------------------------------
class PlainConv3dChannelShrink:
    """y -> z hyper-analysis: stride-1 3x3x3 convs + LeakyReLU
    (reference Networks.py:1097-1126, Minnen'18)."""
    name = "PlainConv3dChannelShrink"

    def __init__(self, y_channel: int, z_channel: int, layers: int, **_):
        self.y_channel, self.z_channel, self.layers = (y_channel, z_channel,
                                                       layers)

    def init(self, gen: torch.Generator, device=None) -> Dict:
        convs = []
        for i in range(self.layers):
            cin = self.y_channel if i == 0 else self.z_channel
            convs.append(init_conv3d(gen, cin, self.z_channel, (3, 3, 3),
                                     device))
        return {"convs": convs}

    def apply(self, params: Dict, y: torch.Tensor) -> torch.Tensor:
        x = y
        for i, conv in enumerate(params["convs"]):
            x = conv3d(x, conv)
            if i < self.layers - 1:
                x = leaky_relu(x)
        return x


class PlainConv3dMeanScale:
    """z -> (scales_hat, means_hat) hyper-synthesis
    (reference Networks.py:1130-1161)."""
    name = "PlainConv3dMeanScale"

    def __init__(self, y_channel: int, z_channel: int, layers: int, **_):
        self.y_channel, self.z_channel, self.layers = (y_channel, z_channel,
                                                       layers)

    def init(self, gen: torch.Generator, device=None) -> Dict:
        convs = []
        for i in range(self.layers):
            cin = self.z_channel if i == 0 else self.y_channel
            cout = self.y_channel * 2 if i == self.layers - 1 \
                else self.y_channel
            convs.append(init_conv3d(gen, cin, cout, (3, 3, 3), device))
        return {"convs": convs}

    def apply(self, params: Dict, z: torch.Tensor):
        x = z
        for i, conv in enumerate(params["convs"]):
            x = conv3d(x, conv)
            if i < self.layers - 1:
                x = leaky_relu(x)
        scales_hat, means_hat = torch.chunk(x, 2, dim=1)
        return scales_hat, means_hat


ALLHZ = {"PlainConv3dChannelShrink": PlainConv3dChannelShrink}
ALLGY = {"PlainConv3dMeanScale": PlainConv3dMeanScale}


def init_hz(**kwargs):
    """(reference Networks.py:1126-1128)"""
    kwargs.pop("name")
    return PlainConv3dChannelShrink(**kwargs)


def init_gy(**kwargs):
    """(reference Networks.py:1161-1162)"""
    kwargs.pop("name")
    return PlainConv3dMeanScale(**kwargs)


# --------------------------------------------------------------------------
# Projector: conv3d head mapping phi features -> data channels
# --------------------------------------------------------------------------
class Projector:
    """1x1x1 conv head (reference Networks.py:803-856)."""
    name = "Projector"

    def __init__(self, features: int, data_channel: int, layers: int = 1,
                 **_):
        self.features, self.data_channel, self.layers = (features,
                                                         data_channel, layers)

    def init(self, gen: torch.Generator, device=None) -> Dict:
        convs = []
        for i in range(self.layers):
            cout = self.data_channel if i == self.layers - 1 \
                else self.features
            convs.append(init_conv3d(gen, self.features, cout, (1, 1, 1),
                                     device))
        return {"convs": convs}

    def apply(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(params["convs"]):
            x = conv3d(x, conv, padding=(0, 0, 0))
            if i < self.layers - 1:
                x = torch.relu(x)
        return x
