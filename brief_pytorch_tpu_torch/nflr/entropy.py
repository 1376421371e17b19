"""Learned entropy models for the NFLR coding family, in PyTorch.

Torch port of brief_pytorch_tpu/nflr/entropy.py (compressai's
EntropyBottleneck and GaussianConditional as the reference wraps them,
utils/Networks.py:1062-1086):
  * the factorized model: a per-channel univariate non-parametric density
    (Balle et al. 2018, appendix 6.1) with learnable quantiles, the
    uniform-noise relaxation for training and the quantile (aux) loss;
  * the Gaussian conditional model with Balle's scale table
    exp(linspace(log .11, log 256, 64)).

Likelihoods are torch ops on the parameters' device.  Tables and
bitstreams are host work: the factorized tables are evaluated in float32
on the CPU whatever device trained the model, so that an archive written
on the card decodes on the host and the other way round; the Gaussian
tables come from scipy.  The escape coding and the stream layout are the
JAX package's, byte for byte.

Stochastic functions take a torch.Generator and, optionally, the drawn
noise itself (`noise=`), so tests can feed them the JAX package's draws.
"""
from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from brief_pytorch_tpu_torch.nflr import rans

LIKELIHOOD_MIN = 1e-9

SCALES_MIN = 0.11
SCALES_MAX = 256.0
SCALES_LEVELS = 64


def get_scale_table(lo=SCALES_MIN, hi=SCALES_MAX, levels=SCALES_LEVELS
                    ) -> np.ndarray:
    """Balle's canonical scale table (reference utils/Networks.py:1078-1080)."""
    return np.exp(np.linspace(math.log(lo), math.log(hi), levels))


def uniform(gen: torch.Generator, shape, lo: float = -0.5, hi: float = 0.5
            ) -> torch.Tensor:
    """U(lo, hi) float32 draws on the generator's device."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=gen.device)
    return u * (hi - lo) + lo


def maximum(x: torch.Tensor, floor: float) -> torch.Tensor:
    """jnp.maximum(x, floor): at a tie the gradient is split in half, as
    jnp.maximum's is (torch.maximum with a tensor floor does the same)."""
    return torch.maximum(x, torch.full_like(x, floor))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi), with its
    half gradients at ties."""
    return torch.minimum(maximum(x, lo), torch.full_like(x, hi))


# ===========================================================================
# Factorized (univariate non-parametric) entropy model
# ===========================================================================
def factorized_init(gen: torch.Generator, channels: int,
                    filters: Tuple[int, ...] = (3, 3, 3, 3),
                    init_scale: float = 10.0, device=None) -> Dict:
    """Parameters of the per-channel density c(x) (Balle'18 appendix 6.1).

    matrices H_k: (C, f_k+1, f_k); biases b_k: (C, f_k+1, 1);
    factors a_k: (C, f_k+1, 1); quantiles: (C, 1, 3) init (-s, 0, s).
    """
    f = (1,) + tuple(int(x) for x in filters) + (1,)
    scale = init_scale ** (1.0 / (len(f) - 1))
    params = {"matrices": [], "biases": [], "factors": []}
    for i in range(len(f) - 1):
        init_m = math.log(math.expm1(1.0 / scale / f[i + 1]))
        params["matrices"].append(torch.full((channels, f[i + 1], f[i]),
                                             init_m, device=device))
        params["biases"].append(
            uniform(gen, (channels, f[i + 1], 1)).to(device))
        if i < len(f) - 2:
            params["factors"].append(torch.zeros((channels, f[i + 1], 1),
                                                 device=device))
    params["quantiles"] = torch.tensor(
        [-init_scale, 0.0, init_scale], dtype=torch.float32,
        device=device).reshape(1, 1, 3).repeat(channels, 1, 1)
    return params


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus = logaddexp(x, 0), without torch's threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _logits_cumulative(params: Dict, x: torch.Tensor, stop_gradient: bool
                       ) -> torch.Tensor:
    """x: (C, 1, N) -> logits of the cumulative at x, per channel."""
    logits = x
    n_layers = len(params["matrices"])
    for i in range(n_layers):
        m = params["matrices"][i]
        b = params["biases"][i]
        if stop_gradient:
            m, b = m.detach(), b.detach()
        logits = _softplus(m) @ logits + b
        if i < n_layers - 1:
            a = params["factors"][i]
            if stop_gradient:
                a = a.detach()
            logits = logits + torch.tanh(a) * torch.tanh(logits)
    return logits


def factorized_likelihood(params: Dict, x: torch.Tensor,
                          stop_gradient: bool = False) -> torch.Tensor:
    """P(round(x) = k) under the learned density.  x: (C, 1, N)."""
    lower = _logits_cumulative(params, x - 0.5, stop_gradient)
    upper = _logits_cumulative(params, x + 0.5, stop_gradient)
    sign = (-torch.sign(lower + upper)).detach()
    likelihood = torch.abs(torch.sigmoid(sign * upper)
                           - torch.sigmoid(sign * lower))
    return maximum(likelihood, LIKELIHOOD_MIN)


def _to_c1n(x: torch.Tensor) -> Tuple[torch.Tensor, tuple, int]:
    """(n, c, *spatial) -> (c, 1, n*prod(spatial)); returns restore info."""
    c = x.shape[1]
    perm = (1, 0) + tuple(range(2, x.ndim))
    flat = x.permute(perm).reshape(c, 1, -1)
    return flat, tuple(x.shape), c


def _from_c1n(flat: torch.Tensor, shape: tuple) -> torch.Tensor:
    n, c = shape[0], shape[1]
    x = flat.reshape((c, n) + tuple(shape[2:]))
    return x.permute((1, 0) + tuple(range(2, len(shape))))


def factorized_forward(params: Dict, x: torch.Tensor,
                       gen: torch.Generator = None, training: bool = True,
                       noise: torch.Tensor = None):
    """Uniform-noise relaxation + likelihoods (compressai
    EntropyBottleneck.forward, reference CompressFramework.py:337).
    x: (n, c, *spatial); noise: U(-0.5, 0.5) of x's shape, drawn from gen
    when not given."""
    if training:
        if noise is None:
            noise = uniform(gen, x.shape)
        x_tilde = x + noise
    else:
        medians = _medians_nd(params, x.ndim)
        x_tilde = torch.round(x - medians) + medians
    flat, shape, _ = _to_c1n(x_tilde)
    lik = factorized_likelihood(params, flat)
    return x_tilde, _from_c1n(lik, shape)


def _medians_nd(params: Dict, ndim: int) -> torch.Tensor:
    med = params["quantiles"][:, 0, 1]
    return med.reshape((1, -1) + (1,) * (ndim - 2))


def quantile_loss(params: Dict, tail_mass: float = 1e-9) -> torch.Tensor:
    """Aux loss pushing quantiles to (t/2, 1/2, 1-t/2) targets (compressai
    EntropyBottleneck.loss, driven by update_quantiles_once at reference
    Networks.py:1070-1074)."""
    logits = _logits_cumulative(params, params["quantiles"],
                                stop_gradient=True)
    # log(t/(1-t)) in Python float64: 1 - tail_mass/2 is 1.0 in float32
    edge = math.log(tail_mass / 2) - math.log1p(-tail_mass / 2)
    targets = torch.tensor([edge, 0.0, -edge], dtype=torch.float32,
                           device=logits.device)
    return torch.abs(logits - targets[None, None, :]).sum()


_ESCAPE_TAIL = 1e-4   # pmf mass reserved for the bypass/escape symbol


def _with_escape(pmf: np.ndarray) -> np.ndarray:
    """Append a bypass symbol to a pmf: symbols outside the table range
    encode as the escape symbol + their raw value."""
    pmf = np.asarray(pmf, np.float64)
    tail = max(_ESCAPE_TAIL, 1.0 - float(pmf.sum()))
    return np.concatenate([pmf, [tail]])


def _encode_with_escape(sym: np.ndarray, n_syms: np.ndarray,
                        cdfs, ch_idx: np.ndarray) -> bytes:
    """sym: table-relative ints (may be out of [0, n_syms)); n_syms: per
    ENTRY alphabet size (escape symbol == n_syms).  Layout:
    <u32 rans_len><rans blob><raw int32 escaped values in order>."""
    sym = np.asarray(sym, np.int64)
    esc = (sym < 0) | (sym >= n_syms)
    coded = np.where(esc, n_syms, sym)
    blob = rans.encode_per_channel(coded, cdfs, ch_idx)
    escaped = sym[esc]
    if escaped.size and (escaped.max() > np.iinfo(np.int32).max or
                         escaped.min() < np.iinfo(np.int32).min):
        raise OverflowError(
            "escaped symbol exceeds the int32 bypass range "
            f"[{escaped.min()}, {escaped.max()}]; latent magnitudes this "
            "large cannot be entropy-coded losslessly")
    raw = escaped.astype(np.int32).tobytes()
    return struct.pack("<I", len(blob)) + blob + raw


def _decode_with_escape(data: bytes, n_syms: np.ndarray, cdfs,
                        ch_idx: np.ndarray) -> np.ndarray:
    (blob_len,) = struct.unpack("<I", data[:4])
    blob = data[4:4 + blob_len]
    raw = np.frombuffer(data[4 + blob_len:], np.int32).astype(np.int64)
    sym = rans.decode_per_channel(blob, cdfs, ch_idx)
    esc = sym == n_syms
    if int(esc.sum()) != len(raw):
        raise ValueError(
            f"corrupt bitstream: {int(esc.sum())} escape symbols but "
            f"{len(raw)} raw values in the bypass payload")
    sym = np.where(esc, 0, sym)
    sym[esc] = raw
    return sym


@torch.no_grad()
def factorized_build_tables(params: Dict) -> Dict:
    """Per-channel quantized CDFs over [floor(q0 - median), ceil(q2 -
    median)] for the rANS codec (compressai EntropyBottleneck.update).

    The density is evaluated in float32 on the CPU, whatever device holds
    the parameters: encoder and decoder then build the same integer
    tables on any machine."""
    host = {k: ([t.detach().cpu().float() for t in v] if isinstance(v, list)
                else v.detach().cpu().float()) for k, v in params.items()}
    q = host["quantiles"].numpy()[:, 0, :]                # (C, 3)
    medians = q[:, 1]
    minima = np.maximum(np.ceil(medians - q[:, 0]).astype(int), 0)
    maxima = np.maximum(np.ceil(q[:, 2] - medians).astype(int), 0)
    C = q.shape[0]
    cdfs: List[np.ndarray] = []
    offsets = np.zeros(C, np.int64)
    for c in range(C):
        lo, hi = -int(minima[c]), int(maxima[c])
        xs = np.arange(lo, hi + 1, dtype=np.float32) + medians[c]
        flat = torch.from_numpy(xs).reshape(1, 1, -1)
        sub = {key: [t[c:c + 1] for t in host[key]]
               for key in ("matrices", "biases", "factors")}
        pmf = factorized_likelihood(sub, flat).numpy()[0, 0]
        cdfs.append(rans.quantize_pmf(_with_escape(pmf)))
        offsets[c] = lo
    return {"cdfs": cdfs, "offsets": offsets, "medians": medians}


def factorized_compress(params: Dict, tables: Dict, y: np.ndarray
                        ) -> List[bytes]:
    """y: (n, c, *spatial) -> one bitstring per batch element
    (compressai EntropyBottleneck.compress, reference
    CompressFramework.py:380)."""
    y = np.asarray(y)
    n, c = y.shape[0], y.shape[1]
    spatial = int(np.prod(y.shape[2:]))
    med = tables["medians"].reshape(1, c, *([1] * (y.ndim - 2)))
    q = np.round(np.nan_to_num(y - med)).astype(np.int64)
    strings = []
    ch_idx = np.repeat(np.arange(c), spatial)
    # the last CDF symbol is the escape (see _with_escape)
    n_syms = np.repeat(np.asarray([len(t) - 2 for t in tables["cdfs"]]),
                       spatial)
    for i in range(n):
        sym = (q[i].reshape(c, -1) - tables["offsets"][:, None]).ravel()
        strings.append(_encode_with_escape(sym, n_syms, tables["cdfs"],
                                           ch_idx))
    return strings


def factorized_decompress(params: Dict, tables: Dict, strings: List[bytes],
                          spatial_shape) -> np.ndarray:
    """Inverse of factorized_compress -> float32 (n, c, *spatial_shape)."""
    c = len(tables["cdfs"])
    spatial = int(np.prod(spatial_shape))
    ch_idx = np.repeat(np.arange(c), spatial)
    n_syms = np.repeat(np.asarray([len(t) - 2 for t in tables["cdfs"]]),
                       spatial)
    out = np.zeros((len(strings), c, spatial), np.float32)
    for i, s in enumerate(strings):
        sym = _decode_with_escape(s, n_syms, tables["cdfs"], ch_idx)
        sym = sym.reshape(c, spatial) + tables["offsets"][:, None]
        out[i] = sym + tables["medians"][:, None]
    return out.reshape((len(strings), c) + tuple(spatial_shape))


# ===========================================================================
# Gaussian conditional entropy model
# ===========================================================================
def gaussian_likelihood(y: torch.Tensor, scales: torch.Tensor,
                        means: torch.Tensor = None,
                        scale_bound: float = 0.11) -> torch.Tensor:
    """P(round(y) = k | mu, sigma) (compressai GaussianConditional)."""
    values = y - means if means is not None else y
    scales = maximum(scales, scale_bound)
    values = torch.abs(values)
    upper = _std_normal_cdf((0.5 - values) / scales)
    lower = _std_normal_cdf((-0.5 - values) / scales)
    return maximum(upper - lower, LIKELIHOOD_MIN)


def _std_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


@dataclass
class GaussianTables:
    """Quantized CDFs indexed by scale-table level."""
    cdfs: List[np.ndarray] = field(default_factory=list)
    offsets: np.ndarray = None
    scale_table: np.ndarray = None

    @staticmethod
    def build(scale_table: np.ndarray = None, tail_mass: float = 1e-9
              ) -> "GaussianTables":
        from scipy.stats import norm
        if scale_table is None:
            scale_table = get_scale_table()
        multiplier = -norm.ppf(tail_mass / 2)
        tails = np.ceil(scale_table * multiplier).astype(int)
        cdfs, offsets = [], np.zeros(len(scale_table), np.int64)
        for i, (s, t) in enumerate(zip(scale_table, tails)):
            xs = np.arange(-t, t + 1)
            up = norm.cdf((xs + 0.5) / s)
            lo = norm.cdf((xs - 0.5) / s)
            pmf = np.maximum(up - lo, LIKELIHOOD_MIN)
            cdfs.append(rans.quantize_pmf(_with_escape(pmf)))
            offsets[i] = -t
        return GaussianTables(cdfs, offsets, np.asarray(scale_table))


def build_indexes(scales: np.ndarray, scale_table: np.ndarray) -> np.ndarray:
    """Lowest table level covering each scale
    (compressai GaussianConditional.build_indexes)."""
    scales = np.maximum(np.asarray(scales), scale_table[0])
    idx = np.full(scales.shape, len(scale_table) - 1, np.int64)
    for s in scale_table[:-1][::-1]:
        idx -= (scales <= s).astype(np.int64)
    return idx


def gaussian_compress(tables: GaussianTables, y: np.ndarray,
                      indexes: np.ndarray, means: np.ndarray = None
                      ) -> List[bytes]:
    """One bitstring per batch element (compressai contract)."""
    y = np.asarray(y, np.float64)
    if means is not None:
        y = y - np.asarray(means, np.float64)
    q = np.round(np.nan_to_num(y)).astype(np.int64)
    strings = []
    n_syms = np.asarray([len(c) - 2 for c in tables.cdfs])
    for i in range(y.shape[0]):
        idx = indexes[i].ravel()
        sym = q[i].ravel() - tables.offsets[idx]
        strings.append(_encode_with_escape(sym, n_syms[idx], tables.cdfs,
                                           idx))
    return strings


def gaussian_decompress(tables: GaussianTables, strings: List[bytes],
                        indexes: np.ndarray, means: np.ndarray = None
                        ) -> np.ndarray:
    out = np.zeros(indexes.shape, np.float32)
    n_syms = np.asarray([len(c) - 2 for c in tables.cdfs])
    for i, s in enumerate(strings):
        idx = indexes[i].ravel()
        sym = _decode_with_escape(s, n_syms[idx], tables.cdfs, idx)
        out[i] = (sym + tables.offsets[idx]).reshape(indexes.shape[1:])
    if means is not None:
        out = out + np.asarray(means, np.float32)
    return out
