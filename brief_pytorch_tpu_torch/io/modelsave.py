"""Raw per-layer binary weight interchange format.

The compressed payload shared with the reference and its CUDA sibling: a
directory of files
    weight-{l}-{out}-{in}   packed little-endian float32, row-major (out, in)
    bias-{l}-{len}          packed little-endian float32
one pair per linear layer of the chain (reference utils/ModelSave.py:8-52).
Copy of brief_pytorch_tpu/io/modelsave.py for chains; the files are byte
for byte those of the JAX package, so either package decodes the other's
archives.  Weights are (in, out) in memory and transposed on the way out/in.
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, List

import numpy as np


def save_model(layers: List[Dict[str, np.ndarray]], save_path: str) -> None:
    """Write chain layers [{'w': (in,out), 'b': (out,)}] to a module dir."""
    if os.path.exists(save_path):
        shutil.rmtree(save_path)
    os.makedirs(save_path)
    for l, layer in enumerate(layers):
        w = np.asarray(layer["w"], dtype="<f4").T  # (out, in) on disk
        b = np.asarray(layer["b"], dtype="<f4")
        with open(os.path.join(save_path,
                               f"weight-{l}-{w.shape[0]}-{w.shape[1]}"),
                  "wb") as f:
            f.write(np.ascontiguousarray(w).tobytes())
        with open(os.path.join(save_path, f"bias-{l}-{b.shape[0]}"), "wb") as f:
            f.write(np.ascontiguousarray(b).tobytes())


def load_model(model_path: str) -> List[Dict[str, np.ndarray]]:
    """Read a module dir back into [{'w': (in,out), 'b': (out,)}]."""
    weights, biases = {}, {}
    for fname in os.listdir(model_path):
        path = os.path.join(model_path, fname)
        with open(path, "rb") as f:
            raw = f.read()
        if fname.startswith("weight"):
            _, l, s0, s1 = fname.split("-")
            l, s0, s1 = int(l), int(s0), int(s1)
            w = np.frombuffer(raw, dtype="<f4").reshape(s0, s1)
            weights[l] = np.ascontiguousarray(w.T)  # back to (in, out)
        elif fname.startswith("bias"):
            _, l, n = fname.split("-")
            biases[int(l)] = np.frombuffer(raw, dtype="<f4").copy()
    n_layers = max(weights) + 1
    return [{"w": weights[l], "b": biases[l]} for l in range(n_layers)]


def save_phi_module(model, params, module_path: str) -> None:
    """Serialize a chain φ's parameters into a module dir (raw binaries).
    Every ported family is a chain; the JAX package's npz container for
    MFN families is not ported yet (ROADMAP.md)."""
    save_model([{k: v.detach().cpu().numpy() for k, v in layer.items()}
                for layer in params["layers"]], module_path)
