"""The φ network: coordinate -> value chains of linear + activation layers.

Torch port of brief_pytorch_tpu/models/phi.py:40-162, 266-280, 584-592,
for plain chains (SIREN, and SIRENPos whose encoder is a parameter-free
warp).  Parameters are a plain dict {"layers": [{"w": (in, out),
"b": (out,)}, ...]} of float32 tensors with weights stored (in, out), as in
the JAX package, so the raw weight binaries stay byte-compatible
(io/modelsave.py) and numpy arrays cross between the packages unchanged
(params_from_numpy / params_to_numpy).

Initialisation reproduces the reference's distributions (SIREN first
layer U(±1/fan_in), hidden U(±sqrt(6/fan_in)/30), bias U(±1/sqrt(fan_in)))
drawn from a torch.Generator; the draws differ from the JAX PRNG's, so
parity tests load the same numpy weights into both packages.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch


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
# chain spec
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class Entry:
    """One logical block of the chain.  Only kind 'plain' (one linear +
    activation) is built so far; `kind` and ChainSpec's `skip_entry` keep
    the JAX package's spec, which the kernels' gate reads."""
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
    encoder: str = "none"         # 'none' | 'sirenpos'
    encoder_cfg: Tuple = ()


def chain_init(gen: torch.Generator, spec: ChainSpec, device=None
               ) -> List[Dict]:
    return [init_linear(gen, e.fan_in, e.fan_out, e.w_init, device)
            for e in spec.entries]


def encode(coords: torch.Tensor, spec: ChainSpec) -> torch.Tensor:
    """The parameter-free coordinate encoder (identity, or the SIRENPos
    per-axis warp sin(2*pi/T_i * x_i), reference Networks.py:19-30)."""
    if spec.encoder != "sirenpos":
        return coords
    from brief_pytorch_tpu_torch.ops.fast_math import fast_sin
    t = torch.tensor(spec.encoder_cfg, dtype=coords.dtype,
                     device=coords.device)
    return fast_sin((2.0 * math.pi / t) * coords)


def chain_apply(layers: Sequence[Dict], coords: torch.Tensor, spec: ChainSpec
                ) -> torch.Tensor:
    """(N, C) coords -> (N, Cout) through the plain chain (autograd-able)."""
    h = encode(coords, spec)
    for layer, e in zip(layers, spec.entries):
        h = _act(e.act, e.w0, h @ layer["w"] + layer["b"])
    return h


# --------------------------------------------------------------------------
# network families
# --------------------------------------------------------------------------
class PhiModel:
    """A φ network: immutable architecture + init/apply on a params dict."""

    name: str = "base"

    def __init__(self, cfg: Dict[str, Any]):
        self.cfg = dict(cfg)
        self.spec = self._build_spec(self.cfg)

    @staticmethod
    def _build_spec(cfg) -> ChainSpec:
        raise NotImplementedError

    def init(self, gen: torch.Generator, device=None) -> Dict:
        return {"layers": chain_init(gen, self.spec, device)}

    def apply(self, params: Dict, coords: torch.Tensor) -> torch.Tensor:
        return chain_apply(params["layers"], coords, self.spec)


def _sine_chain(dims: List[Tuple[int, int]], first_w0: float,
                output_act: bool = False) -> Tuple[Entry, ...]:
    """Entries of a SIREN-style chain: the first layer uses Sine(first_w0),
    hidden layers Sine(30) (reference Sine() default, Networks.py:228), the
    output layer no activation unless output_act (then Sine(30))."""
    entries = []
    n = len(dims)
    for i, (fi, fo) in enumerate(dims):
        if i == n - 1:
            act, w0 = ("sine", 30.0) if output_act else ("none", 1.0)
        elif i == 0:
            act, w0 = "sine", float(first_w0)
        else:
            act, w0 = "sine", 30.0
        w_init = "siren_first" if i == 0 else "siren"
        entries.append(Entry("plain", fi, fo, act, w0, w_init))
    return tuple(entries)


def _siren_dims(cfg) -> List[Tuple[int, int]]:
    c = cfg.get("coords_channel", 3)
    o = cfg.get("data_channel", 1)
    f = int(cfg["features"])
    l = cfg.get("layers", 5)
    return [(c, f)] + [(f, f)] * (l - 2) + [(f, o)]


class SIREN(PhiModel):
    """Sinusoidal MLP (Sitzmann et al. 2020).  Reference Networks.py:235-314."""
    name = "SIREN"

    @staticmethod
    def _build_spec(cfg):
        if cfg.get("res", False):
            raise NotImplementedError(
                "res-SIREN is not ported yet (ROADMAP.md)")
        return ChainSpec(_sine_chain(_siren_dims(cfg), cfg.get("w0", 30),
                                     output_act=cfg.get("output_act", False)))


class SIRENPos(PhiModel):
    """SIREN with per-axis sin(2*pi/T) input warp.  Reference Networks.py:32-62."""
    name = "SIRENPos"

    @staticmethod
    def _build_spec(cfg):
        return ChainSpec(_sine_chain(_siren_dims(cfg), cfg.get("w0", 30)),
                         encoder="sirenpos",
                         encoder_cfg=tuple(cfg.get("T", [2, 2])))


ALLPHI = {"SIREN": SIREN, "SIRENPos": SIRENPos}


def init_phi(cfg: Dict[str, Any]) -> PhiModel:
    """Factory mirroring reference init_phi (Networks.py:800-802)."""
    cfg = dict(cfg)
    name = cfg["name"]
    if name not in ALLPHI:
        raise NotImplementedError(
            f"φ family {name!r} is not ported yet (ROADMAP.md)")
    return ALLPHI[name](cfg)


def get_param_count(params) -> int:
    return sum(int(t.numel()) for layer in params["layers"]
               for t in layer.values())


def params_from_numpy(layers, device=None) -> Dict:
    """The JAX package's params["layers"] as numpy arrays (w (in, out),
    b (out,)) -> the port's params dict of float32 tensors on `device`."""
    return {"layers": [
        {k: torch.tensor(np.asarray(v, dtype=np.float32), device=device)
         for k, v in layer.items()} for layer in layers]}


def params_to_numpy(params: Dict) -> List[Dict[str, np.ndarray]]:
    """Inverse of params_from_numpy: [{'w': (in, out), 'b': (out,)}]."""
    return [{k: v.detach().cpu().numpy() for k, v in layer.items()}
            for layer in params["layers"]]
