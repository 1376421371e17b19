"""Chain helpers shared by the fused kernels.

Torch port of the helpers in brief_pytorch_tpu/ops/pallas_siren.py:48-62
and 205-217, which the train, grid-decode and batch-major forward kernels
(ops/fused_train.py, ops/fused_decode.py, ops/fused_siren.py) all gate on;
and the per-layer tables those kernels read from device memory
(`layer_table`, csrc/chain.cuh), so that a chain may have any number of
layers.
"""
from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import Callable, List, Tuple

import numpy as np
import torch

# (act, w0) per layer; act in {'sine', 'relu', 'sigmoid', 'none'}
LayerSpec = Tuple[Tuple[str, float], ...]

ACTS = ("none", "sine", "relu", "sigmoid")   # index = the kernels' act code


def chain_layer_specs(spec) -> LayerSpec:
    """The per-linear (act, w0) tuple of a models.phi ChainSpec; raises
    ValueError for structures the kernels do not support.

    'sirenpos' is allowed: its encoder is a parameter-free elementwise warp
    applied to the coordinates before the kernel."""
    if spec.skip_entry != -1 or spec.encoder not in ("none", "sirenpos"):
        raise ValueError("fused kernels support plain chains only")
    out = []
    for e in spec.entries:
        if e.kind != "plain":
            raise ValueError("res chains unsupported in fused kernels")
        out.append((e.act, float(e.w0)))
    return tuple(out)


def make_pre_encode(spec):
    """Coordinate pre-transform applied outside the kernel (identity for
    plain chains; the parameter-free SIRENPos warp otherwise)."""
    if spec.encoder == "sirenpos":
        from brief_pytorch_tpu_torch.models.phi import encode
        return lambda coords: encode(coords, spec)
    return lambda coords: coords


# --------------------------------------------------------------------------
# per-layer tables in device memory (csrc/chain.cuh ld_row)
# --------------------------------------------------------------------------
ROW_WORDS = 4                # int32 words of a 16-byte table word
TABLE_CACHE = 64             # tables kept per process, the newest


def f32_word(x: float) -> int:
    """The int32 word holding float32 x."""
    return int(np.float32(x).view(np.int32))


def i64_words(x: int) -> List[int]:
    """The two int32 words (little-endian) of a 64-bit integer or device
    pointer."""
    x &= (1 << 64) - 1
    return [_i32(x & 0xFFFFFFFF), _i32(x >> 32)]


def _i32(x: int) -> int:
    return x - (1 << 32) if x >= 1 << 31 else x


def pad_row(words: List[int], row_words: int) -> List[int]:
    """A table row: `words` zero-padded to row_words (a whole number of
    16-byte words, the size of the kernel's row struct)."""
    if len(words) > row_words or row_words % ROW_WORDS:
        raise ValueError(f"{len(words)} words do not make a row of "
                         f"{row_words}")
    return words + [0] * (row_words - len(words))


_TABLES: "OrderedDict[tuple, Tuple[torch.Tensor, ctypes.Array]]" = \
    OrderedDict()


def layer_table(key, words: Callable[[], List[int]], device: torch.device
                ) -> Tuple[torch.Tensor, "ctypes.Array"]:
    """A kernel's per-layer table: the int32 words that `words()` returns,
    on `device` and as a host array (the kernels copy its first rows into
    their launch parameters, csrc/chain.cuh kParamLayers), made once per
    `key` (a chain's widths, activations, offsets, and the weight pointers
    where the table holds them) and kept for the TABLE_CACHE newest keys,
    so a training run's steps launch with nothing copied from the host.  A
    new key's words go through pinned memory on the current stream, ahead
    of the launch that reads them."""
    full = (device, key)
    entry = _TABLES.get(full)
    if entry is None:
        w = words()
        host = torch.tensor(w, dtype=torch.int32).pin_memory()
        entry = (host.to(device, non_blocking=True),
                 (ctypes.c_int * len(w))(*w))
        _TABLES[full] = entry
        while len(_TABLES) > TABLE_CACHE:
            _TABLES.popitem(last=False)
    else:
        _TABLES.move_to_end(full)
    return entry
