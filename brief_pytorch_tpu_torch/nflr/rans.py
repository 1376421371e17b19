"""rANS (range asymmetric numeral system) codec for the NFLR bitstreams.

Copy of brief_pytorch_tpu/nflr/rans.py, with the same PRECISION and RANS_L,
so either package decodes the other's streams.  Encoding uses per-symbol
(cum_freq, freq) from a quantized CDF with total 1 << PRECISION; symbols
are encoded in reverse and the byte stream is emitted little-end-first,
the standard rANS construction (Duda 2014).

The native backend is native/rans.cpp, compiled at first use into
build/librans.so by ops/build.host_library with the host compiler and
loaded through ctypes (never from native/bin/).  The per-symbol Python
loops below are the readable spec and give the same bytes; they run only
when the machine has no compiler.  `backend()` says which one a run used.
"""
from __future__ import annotations

import ctypes
import logging
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

PRECISION = 12                 # cdf total = 4096
RANS_L = 1 << 23               # renormalisation lower bound
_MASK = (1 << PRECISION) - 1

SOURCE = Path(__file__).resolve().parents[2] / "native" / "rans.cpp"

_NATIVE = None
_BACKEND: Optional[str] = None


def _bind(lib):
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    lib.rans_encode_indexed.restype = ctypes.c_int64
    lib.rans_encode_indexed.argtypes = [
        i32p, ctypes.c_int64, u32p, i64p, ctypes.c_void_p, u8p,
        ctypes.c_int64]
    lib.rans_decode_indexed.restype = ctypes.c_int64
    lib.rans_decode_indexed.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, u32p, i64p, ctypes.c_int64,
        ctypes.c_void_p, i32p]
    return lib


def native():
    """The native library, built at first use; None without a compiler."""
    global _NATIVE, _BACKEND
    if _BACKEND is None:
        from brief_pytorch_tpu_torch.ops import build
        path = build.host_library("rans", SOURCE)
        if path is not None:
            _NATIVE = _bind(ctypes.CDLL(str(path)))
        _BACKEND = "python" if _NATIVE is None else "native"
        logging.getLogger(__name__).info(
            "rANS backend: %s", path if path is not None else
            "pure Python (no host compiler found)")
    return _NATIVE


def backend() -> str:
    """'native' (build/librans.so) or 'python' (no compiler found)."""
    native()
    return _BACKEND


def _flatten_cdfs(cdfs: Sequence[np.ndarray]):
    flat = np.concatenate([np.asarray(c, np.uint32) for c in cdfs])
    off = np.zeros(len(cdfs) + 1, np.int64)
    off[1:] = np.cumsum([len(c) for c in cdfs])
    return np.ascontiguousarray(flat), off


def _native_encode(symbols, cdfs, channel_idx) -> bytes:
    symbols = np.ascontiguousarray(symbols, np.int32).ravel()
    flat, off = _flatten_cdfs(cdfs)
    n = len(symbols)
    out = np.empty(4 * n + 16, np.uint8)
    if channel_idx is None:
        idx_p = None
    else:
        channel_idx = np.ascontiguousarray(channel_idx, np.int32).ravel()
        idx_p = channel_idx.ctypes.data_as(ctypes.c_void_p)
    written = native().rans_encode_indexed(symbols, n, flat, off, idx_p,
                                          out, len(out))
    if written <= 0:   # not assert: must fire under python -O
        raise RuntimeError("native rans encode overflow")
    return out[:written].tobytes()


def _native_decode(data: bytes, n: int, cdfs, channel_idx) -> np.ndarray:
    buf = np.frombuffer(data, np.uint8)
    flat, off = _flatten_cdfs(cdfs)
    out = np.empty(n, np.int32)
    if channel_idx is None:
        idx_p = None
    else:
        channel_idx = np.ascontiguousarray(channel_idx, np.int32).ravel()
        idx_p = channel_idx.ctypes.data_as(ctypes.c_void_p)
    rc = native().rans_decode_indexed(np.ascontiguousarray(buf), len(buf), n,
                                     flat, off, len(cdfs), idx_p, out)
    if rc != 0:        # not assert: must fire under python -O
        raise ValueError("native rans decode failed (truncated stream?)")
    return out.astype(np.int64)


def encode(symbols: np.ndarray, cdf: np.ndarray) -> bytes:
    if native() is not None:
        return _native_encode(symbols, [cdf], None)
    return _encode_py(symbols, cdf)


def decode(data: bytes, n_symbols: int, cdf: np.ndarray) -> np.ndarray:
    if native() is not None:
        return _native_decode(data, n_symbols, [cdf], None)
    return _decode_py(data, n_symbols, cdf)


def encode_per_channel(symbols: np.ndarray, cdfs: Sequence[np.ndarray],
                       channel_idx: np.ndarray) -> bytes:
    """Encode symbols where symbol i uses cdfs[channel_idx[i]]."""
    if native() is not None:
        return _native_encode(symbols, cdfs, channel_idx)
    return _encode_per_channel_py(symbols, cdfs, channel_idx)


def decode_per_channel(data: bytes, cdfs: Sequence[np.ndarray],
                       channel_idx: np.ndarray) -> np.ndarray:
    """Inverse of encode_per_channel."""
    if native() is not None:
        n = len(np.asarray(channel_idx).ravel())
        return _native_decode(data, n, cdfs, channel_idx)
    return _decode_per_channel_py(data, cdfs, channel_idx)


def _encode_py(symbols: np.ndarray, cdf: np.ndarray) -> bytes:
    """Encode int symbols with one shared quantized CDF.

    cdf: (S+1,) uint32 cumulative frequencies, cdf[0]=0,
    cdf[-1]=1<<PRECISION, strictly increasing (every symbol has freq >= 1).
    """
    symbols = np.asarray(symbols, np.int64).ravel()
    freqs = (cdf[1:] - cdf[:-1]).astype(np.int64)
    starts = cdf[:-1].astype(np.int64)
    out = bytearray()
    x = RANS_L
    for s in symbols[::-1]:
        f = int(freqs[s])
        c = int(starts[s])
        # renormalise: keep x < (RANS_L >> PRECISION) << 8) * f after encode
        x_max = ((RANS_L >> PRECISION) << 8) * f
        while x >= x_max:
            out.append(x & 0xFF)
            x >>= 8
        x = ((x // f) << PRECISION) + (x % f) + c
    # flush 32-bit state, little-end-first like the renorm bytes
    for _ in range(4):
        out.append(x & 0xFF)
        x >>= 8
    return bytes(out[::-1])


def _decode_py(data: bytes, n_symbols: int, cdf: np.ndarray) -> np.ndarray:
    """Inverse of encode: recover n_symbols ints."""
    freqs = (cdf[1:] - cdf[:-1]).astype(np.int64)
    starts = cdf[:-1].astype(np.int64)
    # symbol lookup table: slot -> symbol
    slot2sym = np.zeros(1 << PRECISION, np.int64)
    for s in range(len(freqs)):
        slot2sym[starts[s]:starts[s] + freqs[s]] = s
    pos = 0
    x = 0
    for _ in range(4):
        x = (x << 8) | data[pos]
        pos += 1
    out = np.empty(n_symbols, np.int64)
    for i in range(n_symbols):
        slot = x & _MASK
        s = int(slot2sym[slot])
        out[i] = s
        x = int(freqs[s]) * (x >> PRECISION) + slot - int(starts[s])
        while x < RANS_L and pos < len(data):
            x = (x << 8) | data[pos]
            pos += 1
    return out


def _encode_per_channel_py(symbols: np.ndarray, cdfs: Sequence[np.ndarray],
                           channel_idx: np.ndarray) -> bytes:
    symbols = np.asarray(symbols, np.int64).ravel()
    channel_idx = np.asarray(channel_idx, np.int64).ravel()
    out = bytearray()
    x = RANS_L
    for i in range(len(symbols) - 1, -1, -1):
        cdf = cdfs[channel_idx[i]]
        s = int(symbols[i])
        f = int(cdf[s + 1] - cdf[s])
        c = int(cdf[s])
        x_max = ((RANS_L >> PRECISION) << 8) * f
        while x >= x_max:
            out.append(x & 0xFF)
            x >>= 8
        x = ((x // f) << PRECISION) + (x % f) + c
    for _ in range(4):
        out.append(x & 0xFF)
        x >>= 8
    return bytes(out[::-1])


def _decode_per_channel_py(data: bytes, cdfs: Sequence[np.ndarray],
                           channel_idx: np.ndarray) -> np.ndarray:
    channel_idx = np.asarray(channel_idx, np.int64).ravel()
    n = len(channel_idx)
    luts = []
    for cdf in cdfs:
        freqs = (cdf[1:] - cdf[:-1]).astype(np.int64)
        starts = cdf[:-1].astype(np.int64)
        lut = np.zeros(1 << PRECISION, np.int64)
        for s in range(len(freqs)):
            lut[starts[s]:starts[s] + freqs[s]] = s
        luts.append((lut, freqs, starts))
    pos = 0
    x = 0
    for _ in range(4):
        x = (x << 8) | data[pos]
        pos += 1
    out = np.empty(n, np.int64)
    for i in range(n):
        lut, freqs, starts = luts[channel_idx[i]]
        slot = x & _MASK
        s = int(lut[slot])
        out[i] = s
        x = int(freqs[s]) * (x >> PRECISION) + slot - int(starts[s])
        while x < RANS_L and pos < len(data):
            x = (x << 8) | data[pos]
            pos += 1
    return out


def quantize_pmf(pmf: np.ndarray) -> np.ndarray:
    """Quantize a pmf into a strictly-increasing CDF with total 1<<PRECISION.

    Every symbol gets freq >= 1 so it stays encodable (matching the
    range-coder convention the reference's backend uses).
    """
    pmf = np.asarray(pmf, np.float64).clip(0)
    n = len(pmf)
    total = 1 << PRECISION
    assert n <= total, "alphabet too large for CDF precision"
    if pmf.sum() <= 0:
        freqs = np.full(n, total // n, np.int64)
        freqs[: total - freqs.sum()] += 1
    else:
        freqs = np.maximum(1, np.round(pmf / pmf.sum() * total)).astype(np.int64)
        # fix the rounding drift, never dropping a freq below 1
        drift = int(freqs.sum()) - total
        while drift != 0:
            if drift > 0:
                i = int(np.argmax(freqs))
                take = min(drift, int(freqs[i]) - 1)
                if take == 0:
                    raise ValueError("cannot normalise pmf")
                freqs[i] -= take
                drift -= take
            else:
                i = int(np.argmax(freqs))
                freqs[i] += -drift
                drift = 0
    cdf = np.zeros(n + 1, np.uint32)
    cdf[1:] = np.cumsum(freqs)
    assert cdf[-1] == total
    return cdf
