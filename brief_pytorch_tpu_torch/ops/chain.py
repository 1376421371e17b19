"""Chain helpers shared by the fused kernels.

Torch port of the helpers in brief_pytorch_tpu/ops/pallas_siren.py:48-62
and 205-217, which the train, grid-decode and batch-major forward kernels
(ops/fused_train.py, ops/fused_decode.py, ops/fused_siren.py) all gate on.
"""
from __future__ import annotations

from typing import Tuple

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
