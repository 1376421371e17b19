"""The φ-network zoo: coordinate -> value networks as init/apply pairs on a
plain parameter tree.

Torch port of brief_pytorch_tpu/models/phi.py, all eleven families
(reference utils/Networks.py: SIREN 235-314, SIRENFT 316-369, SIREN_Pyramid
370-457, SIRENPS 458-552, SIREN_RELU 553-599, SIREN_SIGMOID 600-646,
SIRENPos 32-62, NeRF 84-136, FFN 156-207, MFNFourier 691-727, MFNGabor
750-794).  Parameters are nested dicts and lists of float32 tensors with
the JAX package's keys and weights stored (in, out):

  chains  {"layers": [{"w": (in, out), "b": (out,)}, ...]}
          (+ {"encoder": {"bvals": (embsize, c)}} for FFN, frozen)
  MFNs    {"linear": [...], "output": {...}, "filters": [...]}

so the raw weight binaries stay byte-compatible (io/modelsave.py) and numpy
arrays cross between the packages unchanged (params_from_numpy /
params_to_numpy).

Initialisation reproduces the reference's distributions (torch Linear
default U(±1/sqrt(fan_in)); SIREN first layer U(±1/fan_in), hidden
U(±sqrt(6/fan_in)/30)) drawn from a torch.Generator; the draws differ from
the JAX PRNG's, so parity tests load the same numpy weights into both
packages.  FFN's bvals are the reference's torch seed-0 draw, bit for bit.

Every `apply` takes `compute_dtype` (Compress.half: torch.bfloat16), as
JAX phi.py:88-92 does: each product's inputs and weights are rounded to
that dtype and the products summed in float32 (`_matmul`), while the
parameters stay float32; activations run in float32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from brief_pytorch_tpu_torch.core.tree import tree_leaves, tree_map


# --------------------------------------------------------------------------
# initialisers
# --------------------------------------------------------------------------
def _uniform(gen: torch.Generator, shape, bound: float, device
             ) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=gen.device)
    return ((u * 2.0 - 1.0) * bound).to(device)


def init_linear(gen: torch.Generator, fan_in: int, fan_out: int, w_init: str,
                device=None) -> Dict[str, torch.Tensor]:
    """One linear layer, weight stored (in, out).

    w_init: 'default' (torch nn.Linear: U(+-1/sqrt(fan_in)) for W and b),
            'siren'  (U(+-sqrt(6/fan_in)/30), ref Networks.py:215-220),
            'siren_first' (U(+-1/fan_in), ref Networks.py:221-226).
    Bias always uses the torch default (sine_init touches weights only).
    """
    if w_init == "default":
        w_bound = 1.0 / math.sqrt(fan_in)
    elif w_init == "siren":
        w_bound = math.sqrt(6.0 / fan_in) / 30.0
    elif w_init == "siren_first":
        w_bound = 1.0 / fan_in
    else:
        raise ValueError(w_init)
    w = _uniform(gen, (fan_in, fan_out), w_bound, device)
    b = _uniform(gen, (fan_out,), 1.0 / math.sqrt(fan_in), device)
    return {"w": w, "b": b}


def _matmul(x: torch.Tensor, w: torch.Tensor, compute_dtype=None
            ) -> torch.Tensor:
    """x @ w; with a compute_dtype, both rounded to it and the products
    summed in float32 (JAX phi.py:88-95, preferred_element_type float32).
    The rounded values are exact in float32, so a float32 matmul of them
    is that sum."""
    if compute_dtype is None:
        return x @ w
    f32 = torch.float32
    return x.to(compute_dtype).to(f32) @ w.to(compute_dtype).to(f32)


def _act(name: str, w0: float, z: torch.Tensor) -> torch.Tensor:
    if name == "sine":
        # fast sine whose gradient re-reads the cos of the shared range
        # reduction (ops/fast_math.py), as the JAX chain does
        from brief_pytorch_tpu_torch.ops.fast_math import fast_sin_cached
        return fast_sin_cached(w0 * z)
    if name == "relu":
        return torch.relu(z)
    if name == "sigmoid":
        return torch.sigmoid(z)
    if name == "none":
        return z
    raise ValueError(name)


# --------------------------------------------------------------------------
# chain spec — shared machinery for every non-MFN network
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class Entry:
    """One logical block of the chain.

    kind 'plain': one linear + activation.
    kind 'res'  : HalfResidual(Linear,Sine,Linear,Sine) consuming two linears
                  (reference Networks.py:209-214, 251-257).
    """
    kind: str
    fan_in: int
    fan_out: int
    act: str
    w0: float
    w_init: str


@dataclass(frozen=True)
class ChainSpec:
    entries: Tuple[Entry, ...]
    skip_entry: int = -1          # entry index receiving concat([encoding, h])
    encoder: str = "none"         # 'none' | 'sirenpos' | 'nerf' | 'ffn'
    encoder_cfg: Tuple = ()

    @property
    def num_linears(self) -> int:
        return sum(2 if e.kind == "res" else 1 for e in self.entries)


def chain_init(gen: torch.Generator, spec: ChainSpec, device=None
               ) -> List[Dict]:
    layers = []
    for e in spec.entries:
        layers.append(init_linear(gen, e.fan_in, e.fan_out, e.w_init, device))
        if e.kind == "res":
            layers.append(init_linear(gen, e.fan_out, e.fan_out, e.w_init,
                                      device))
    return layers


def encode(coords: torch.Tensor, spec, encoder_params: Optional[Dict] = None,
           compute_dtype=None) -> torch.Tensor:
    """The coordinate encoder of a ChainSpec (or of the fleet's stacked
    spec: coords may carry leading batch axes, bvals then (B, embsize, c))."""
    from brief_pytorch_tpu_torch.ops.fast_math import fast_sin, fast_sincos
    if spec.encoder == "none":
        return coords
    if spec.encoder == "sirenpos":
        # per-axis sin(2*pi/T_i * x_i), reference Networks.py:19-30
        t = torch.tensor(spec.encoder_cfg, dtype=coords.dtype,
                         device=coords.device)
        return fast_sin((2.0 * math.pi / t) * coords)
    if spec.encoder == "nerf":
        # [x, (sin(2^i pi x_j), cos(2^i pi x_j)) for i in freqs for j in chans]
        # — the column order of reference Networks.py:72-83
        (frequencies,) = spec.encoder_cfg
        parts = [coords]
        for i in range(frequencies):
            for j in range(coords.shape[-1]):
                c = (2.0 ** i) * math.pi * coords[..., j:j + 1]
                s, co = fast_sincos(c)      # one shared reduction for both
                parts.append(s)
                parts.append(co)
        return torch.cat(parts, dim=-1)
    if spec.encoder == "ffn":
        # [sin(2 pi x B^T), cos(2 pi x B^T)], reference Networks.py:150-155
        bvals = encoder_params["bvals"]     # (embsize, coords_channel)
        proj = _matmul(2.0 * math.pi * coords, bvals.transpose(-1, -2),
                       compute_dtype)
        s, co = fast_sincos(proj)
        return torch.cat([s, co], dim=-1)
    raise ValueError(spec.encoder)


def chain_apply(layers: Sequence[Dict], coords: torch.Tensor, spec: ChainSpec,
                encoder_params: Optional[Dict] = None, compute_dtype=None
                ) -> torch.Tensor:
    """(N, C) coords -> (N, Cout) through the chain (autograd-able)."""
    x = encode(coords, spec, encoder_params, compute_dtype)
    mm = lambda h, layer: _matmul(h, layer["w"], compute_dtype) + layer["b"]
    h = x
    li = 0
    for ei, e in enumerate(spec.entries):
        if ei == spec.skip_entry:
            h = torch.cat([x, h], dim=-1)
        if e.kind == "plain":
            h = _act(e.act, e.w0, mm(h, layers[li]))
            li += 1
        else:   # res: 0.5 * (sine(lin(sine(lin(h)))) + h)
            t = _act("sine", e.w0, mm(h, layers[li]))
            t = _act("sine", e.w0, mm(t, layers[li + 1]))
            h = 0.5 * (t + h)
            li += 2
    return h


# --------------------------------------------------------------------------
# network families
# --------------------------------------------------------------------------
class PhiModel:
    """A φ network: immutable architecture + init/apply on a params tree."""

    name: str = "base"
    serializable_chain: bool = False  # raw per-layer binary format eligible

    def __init__(self, cfg: Dict[str, Any]):
        self.cfg = dict(cfg)

    def init(self, gen: torch.Generator, device=None) -> Dict:
        raise NotImplementedError

    def apply(self, params: Dict, coords: torch.Tensor, compute_dtype=None
              ) -> torch.Tensor:
        raise NotImplementedError

    @staticmethod
    def param_count(params) -> int:
        return get_param_count(params)


class _ChainModel(PhiModel):
    """Common base for all chain (Sequential) networks."""
    serializable_chain = True

    def __init__(self, cfg):
        super().__init__(cfg)
        self.spec = self._build_spec(self.cfg)

    @staticmethod
    def _build_spec(cfg) -> ChainSpec:
        raise NotImplementedError

    def init(self, gen, device=None):
        return {"layers": chain_init(gen, self.spec, device)}

    def apply(self, params, coords, compute_dtype=None):
        return chain_apply(params["layers"], coords, self.spec,
                           params.get("encoder"), compute_dtype)


def _sine_chain(dims: List[Tuple[int, int]], first_w0: float, n_first: int = 1,
                res: bool = False, output_act: bool = False,
                first_init: str = "siren_first") -> Tuple[Entry, ...]:
    """Entries of a SIREN-style chain.

    dims: (in, out) per linear, output layer last.  The first n_first layers
    use Sine(first_w0); hidden layers use Sine(30) (reference Sine() default,
    Networks.py:228); the output layer has no act unless output_act (then
    Sine(30)).  sine_init applies to all linears, then the first is
    re-initialised (reference Networks.py:264-266).
    """
    entries = []
    n = len(dims)
    for i, (fi, fo) in enumerate(dims):
        is_out = i == n - 1
        if is_out:
            act, w0 = ("sine", 30.0) if output_act else ("none", 1.0)
        elif i < n_first:
            act, w0 = "sine", float(first_w0)
        else:
            act, w0 = "sine", 30.0
        kind = "res" if (res and not is_out and i >= n_first) else "plain"
        w_init = first_init if i == 0 else "siren"
        entries.append(Entry(kind, fi, fo, act, w0, w_init))
    return tuple(entries)


def _io(cfg) -> Tuple[int, int, int]:
    return (cfg.get("coords_channel", 3), cfg.get("data_channel", 1),
            cfg.get("layers", 5))


def _siren_dims(cfg) -> List[Tuple[int, int]]:
    c, o, l = _io(cfg)
    f = int(cfg["features"])
    return [(c, f)] + [(f, f)] * (l - 2) + [(f, o)]


class SIREN(_ChainModel):
    """Sinusoidal MLP (Sitzmann et al. 2020).  Reference Networks.py:235-314."""
    name = "SIREN"

    @staticmethod
    def _build_spec(cfg):
        return ChainSpec(_sine_chain(_siren_dims(cfg), cfg.get("w0", 30),
                                     res=cfg.get("res", False),
                                     output_act=cfg.get("output_act", False)))


class SIRENFT(_ChainModel):
    """SIREN with a wider first layer (ratio).  Reference Networks.py:316-369.
    The first two layers use Sine(w0)."""
    name = "SIRENFT"

    @staticmethod
    def _build_spec(cfg):
        c, o, l = _io(cfg)
        ff = int(cfg["features"] * cfg.get("ratio", 1))
        f = int(cfg["features"])
        dims = [(c, ff), (ff, f)] + [(f, f)] * (l - 3) + [(f, o)]
        return ChainSpec(_sine_chain(dims, cfg.get("w0", 30), n_first=2,
                                     res=cfg.get("res", False),
                                     output_act=cfg.get("output_act", False)))


class SIREN_Pyramid(_ChainModel):
    """SIREN with linearly shrinking widths.  Reference Networks.py:370-457."""
    name = "SIREN_Pyramid"

    @staticmethod
    def _build_spec(cfg):
        c, o, l = _io(cfg)
        f = int(cfg["features"])
        d = cfg.get("features_dis", 10)
        dims = [(c, f)]
        for i in range(l - 2):
            dims.append((f - i * d, f - (i + 1) * d))
        dims.append((f - (l - 2) * d, o))
        return ChainSpec(_sine_chain(dims, cfg.get("w0", 30),
                                     res=cfg.get("res", False),
                                     output_act=cfg.get("output_act", False)))


class SIRENPS(_ChainModel):
    """SIREN with geometric widths (ratio^k).  Reference Networks.py:458-552."""
    name = "SIRENPS"

    @staticmethod
    def _build_spec(cfg):
        c, o, l = _io(cfg)
        f = cfg["features"]
        r = cfg.get("ratio", 1)
        dims = [(c, int(f * r ** (l - 2)))]
        for i in range(l - 2):
            dims.append((int(f * r ** (l - 2 - i)),
                         int(f * r ** (l - 2 - i - 1))))
        dims.append((int(f), o))
        return ChainSpec(_sine_chain(dims, cfg.get("w0", 30),
                                     res=cfg.get("res", False),
                                     output_act=cfg.get("output_act", False)))


def _plain_chain_spec(cfg, act):
    out_act = act if cfg.get("output_act", False) else "none"
    dims = _siren_dims(cfg)
    entries = []
    for i, (fi, fo) in enumerate(dims):
        a = out_act if i == len(dims) - 1 else act
        entries.append(Entry("plain", fi, fo, a, 1.0, "default"))
    return ChainSpec(tuple(entries))


class SIREN_RELU(_ChainModel):
    """SIREN topology with ReLU acts, torch-default init.
    Reference Networks.py:553-599."""
    name = "SIREN_RELU"

    @staticmethod
    def _build_spec(cfg):
        return _plain_chain_spec(cfg, "relu")


class SIREN_SIGMOID(_ChainModel):
    """SIREN topology with Sigmoid acts.  Reference Networks.py:600-646."""
    name = "SIREN_SIGMOID"

    @staticmethod
    def _build_spec(cfg):
        return _plain_chain_spec(cfg, "sigmoid")


class SIRENPos(_ChainModel):
    """SIREN with per-axis sin(2*pi/T) input warp.  Reference Networks.py:32-62."""
    name = "SIRENPos"

    @staticmethod
    def _build_spec(cfg):
        return ChainSpec(_sine_chain(_siren_dims(cfg), cfg.get("w0", 30)),
                         encoder="sirenpos",
                         encoder_cfg=tuple(cfg.get("T", [2, 2])))


def _encoded_relu_spec(cfg, d: int, skip: bool, encoder: str,
                       encoder_cfg: Tuple = ()) -> ChainSpec:
    """ReLU MLP on a d-wide encoding, optionally re-reading the encoding at
    the middle entry (NeRF, FFN; reference Networks.py:84-136, 156-207)."""
    _, o, l = _io(cfg)
    f = int(cfg["features"])
    skip_entry = (l - 1) // 2 if skip else -1
    entries = [Entry("plain", d, f, "relu", 1.0, "default")]
    for i in range(l - 2):
        fi = d + f if skip_entry == i + 1 else f
        entries.append(Entry("plain", fi, f, "relu", 1.0, "default"))
    if skip_entry == l - 1:
        entries.append(Entry("plain", d + f, o, "sigmoid", 1.0, "default"))
    else:
        entries.append(Entry("plain", f, o, "none", 1.0, "default"))
    return ChainSpec(tuple(entries), skip_entry=skip_entry, encoder=encoder,
                     encoder_cfg=encoder_cfg)


class NeRF(_ChainModel):
    """Positional-encoding ReLU MLP with skip (Mildenhall et al. 2020).
    Reference Networks.py:84-136."""
    name = "NeRF"

    @staticmethod
    def _build_spec(cfg):
        c = cfg.get("coords_channel", 3)
        freq = cfg.get("frequencies", 10)
        return _encoded_relu_spec(cfg, c + 2 * c * freq,
                                  cfg.get("skip", True), "nerf", (freq,))


class FFN(_ChainModel):
    """Fourier-feature network (Tancik et al. 2020).
    Reference Networks.py:138-207.  bvals are frozen N(0,1)*scale drawn with
    torch seed 0 (the reference's own draw, Networks.py:141-148); they are
    part of the parameter tree and get no gradient."""
    name = "FFN"

    @staticmethod
    def _build_spec(cfg):
        return _encoded_relu_spec(cfg, 2 * cfg.get("embsize", 256),
                                  cfg.get("skip", False), "ffn")

    def init(self, gen, device=None):
        bvals = _ffn_bvals(self.cfg.get("embsize", 256),
                           self.cfg.get("coords_channel", 3),
                           self.cfg.get("scale", 10))
        return {"layers": chain_init(gen, self.spec, device),
                "encoder": {"bvals": bvals.to(device)}}

    def apply(self, params, coords, compute_dtype=None):
        enc = {"bvals": params["encoder"]["bvals"].detach()}
        return chain_apply(params["layers"], coords, self.spec, enc,
                           compute_dtype)


def _ffn_bvals(embsize, coords_channel, scale) -> torch.Tensor:
    """The reference's torch.manual_seed(0) draw, bit for bit."""
    g = torch.Generator().manual_seed(0)
    return torch.normal(0, 1, size=(embsize, coords_channel),
                        generator=g) * scale


class _MFN(PhiModel):
    """Multiplicative filter network base (Fathony et al. 2021).
    Reference Networks.py:648-794."""
    serializable_chain = False

    def __init__(self, cfg):
        super().__init__(cfg)
        self.c = cfg.get("coords_channel", 3)
        self.o = cfg.get("data_channel", 1)
        self.f = int(cfg["features"])
        self.l = cfg.get("layers", 5)
        self.input_scale = cfg.get("input_scale", 256.0)
        self.weight_scale = cfg.get("weight_scale", 1.0)
        self.output_act = cfg.get("output_act", False)

    def _init_common(self, gen, device):
        linear = []
        for _ in range(self.l - 2):
            w = _uniform(gen, (self.f, self.f),
                         math.sqrt(self.weight_scale / self.f), device)
            b = _uniform(gen, (self.f,), 1.0 / math.sqrt(self.f), device)
            linear.append({"w": w, "b": b})
        return linear, init_linear(gen, self.f, self.o, "default", device)

    def _apply_common(self, params, filters_out, compute_dtype=None):
        h = filters_out[0]
        for i in range(1, len(filters_out)):
            lin = params["linear"][i - 1]
            h = filters_out[i] * (_matmul(h, lin["w"], compute_dtype)
                                  + lin["b"])
        out = params["output"]
        y = _matmul(h, out["w"], compute_dtype) + out["b"]
        return torch.sin(y) if self.output_act else y


class MFNFourier(_MFN):
    name = "MFNFourier"

    def init(self, gen, device=None):
        linear, out = self._init_common(gen, device)
        fscale = self.input_scale / math.sqrt(self.l - 1)
        filters = []
        for _ in range(self.l - 1):
            # torch-default weight then *= fscale (ref Networks.py:682-687)
            w = _uniform(gen, (self.c, self.f), 1.0 / math.sqrt(self.c),
                         device) * fscale
            b = _uniform(gen, (self.f,), math.pi, device)
            filters.append({"w": w, "b": b})
        return {"linear": linear, "output": out, "filters": filters}

    def apply(self, params, coords, compute_dtype=None):
        # exact torch.sin here, not fast_sin: MFN filter arguments scale
        # with input_scale (reference default 256), which can exceed the
        # fast path's validated |x| <~ 2e3 reduction range
        filt = [torch.sin(_matmul(coords, f["w"], compute_dtype) + f["b"])
                for f in params["filters"]]
        return self._apply_common(params, filt, compute_dtype)


class MFNGabor(_MFN):
    name = "MFNGabor"

    def init(self, gen, device=None):
        alpha = self.cfg.get("alpha", 6.0) / (self.l - 1)
        beta = self.cfg.get("beta", 1.0)
        fscale = self.input_scale / math.sqrt(self.l - 1)
        linear, out = self._init_common(gen, device)
        filters = []
        for _ in range(self.l - 1):
            gamma = (torch._standard_gamma(
                torch.full((self.f,), float(alpha), device=gen.device),
                generator=gen) / beta).to(device)
            w = _uniform(gen, (self.c, self.f), 1.0 / math.sqrt(self.c),
                         device) * fscale * torch.sqrt(gamma)[None, :]
            b = _uniform(gen, (self.f,), math.pi, device)
            mu = _uniform(gen, (self.f, self.c), 1.0, device)
            filters.append({"w": w, "b": b, "mu": mu, "gamma": gamma})
        return {"linear": linear, "output": out, "filters": filters}

    def apply(self, params, coords, compute_dtype=None):
        filt = []
        for f in params["filters"]:
            # D = ||x||^2 + ||mu||^2 - 2 x mu^T  (ref Networks.py:743-749)
            D = ((coords ** 2).sum(-1, keepdim=True)
                 + (f["mu"] ** 2).sum(-1)[None, :]
                 - 2.0 * _matmul(coords, f["mu"].T, compute_dtype))
            z = _matmul(coords, f["w"], compute_dtype) + f["b"]
            filt.append(torch.sin(z) * torch.exp(-0.5 * D * f["gamma"]))
        return self._apply_common(params, filt, compute_dtype)


# --------------------------------------------------------------------------
# registry (mirrors reference ALLPHI, Networks.py:795)
# --------------------------------------------------------------------------
ALLPHI = {
    "SIREN": SIREN,
    "SIRENFT": SIRENFT,
    "SIREN_Pyramid": SIREN_Pyramid,
    "SIRENPS": SIRENPS,
    "SIREN_RELU": SIREN_RELU,
    "SIREN_SIGMOID": SIREN_SIGMOID,
    "SIRENPos": SIRENPos,
    "NeRF": NeRF,
    "FFN": FFN,
    "MFNFourier": MFNFourier,
    "MFNGabor": MFNGabor,
}


def init_phi(cfg: Dict[str, Any]) -> PhiModel:
    """Factory mirroring reference init_phi (Networks.py:800-802)."""
    cfg = dict(cfg)
    return ALLPHI[cfg["name"]](cfg)


def get_param_count(params) -> int:
    return sum(int(t.numel()) for t in tree_leaves(params))


def params_from_numpy(tree, device=None) -> Dict:
    """The JAX package's parameters as numpy arrays -> the port's tree of
    float32 tensors on `device`, same keys.  `tree` is any nested dict /
    list of arrays (a chain's {"layers": [...], "encoder": {...}}, an MFN's
    {"linear", "output", "filters"}); a bare list of layers
    (io.modelsave.load_model) becomes {"layers": [...]}."""
    if isinstance(tree, (list, tuple)):
        tree = {"layers": list(tree)}
    return tree_map(lambda a: torch.tensor(np.asarray(a, dtype=np.float32),
                                           device=device), tree)


def params_to_numpy(params: Dict) -> Dict:
    """Inverse of params_from_numpy: the same tree of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
