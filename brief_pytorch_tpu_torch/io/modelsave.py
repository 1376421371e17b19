"""Raw per-layer binary weight interchange format.

The compressed payload shared with the reference and its CUDA sibling: a
directory of files
    weight-{l}-{out}-{in}   packed little-endian float32, row-major (out, in)
    bias-{l}-{len}          packed little-endian float32
one pair per linear layer of the chain (reference utils/ModelSave.py:8-52).
Copy of brief_pytorch_tpu/io/modelsave.py; the files are byte for byte
those of the JAX package, so either package decodes the other's archives.
Weights are (in, out) in memory and transposed on the way out/in.  FFN's
frozen encoder goes beside them as encoder.npz; the MFN families, which are
no chains, use the params.npz container (save_phi_module).
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, List

import numpy as np

from brief_pytorch_tpu_torch.core.tree import (tree_leaves_sorted,
                                               tree_unflatten)


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


def _np(x) -> np.ndarray:
    """A tensor or array as a host numpy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def save_phi_module(model, params, module_path: str) -> None:
    """Serialize any φ family's parameters into a module dir.

    Chain families use the raw per-layer binary format above, plus
    encoder.npz for FFN's frozen bvals (load_model ignores files that are
    not weight-* / bias-*).  MFN families (no chain structure) use the JAX
    package's npz container: params.npz with leaves keyed p{i} in
    jax.tree_util.tree_flatten order (dict keys sorted, lists in order;
    core/tree.py), which load_phi_module_npz restores into a structurally
    identical tree.  Either package reads the other's module dirs.
    """
    if model.serializable_chain:
        save_model([{k: _np(v) for k, v in layer.items()}
                    for layer in params["layers"]], module_path)
        if "encoder" in params:
            np.savez(os.path.join(module_path, "encoder.npz"),
                     **{k: _np(v) for k, v in params["encoder"].items()})
        return
    if os.path.exists(module_path):
        shutil.rmtree(module_path)
    os.makedirs(module_path)
    np.savez(os.path.join(module_path, "params.npz"),
             **{f"p{i}": _np(x)
                for i, x in enumerate(tree_leaves_sorted(params))})


def load_phi_module_npz(module_path: str, like_params):
    """Load a params.npz module into the structure of `like_params` (a
    freshly initialised tree of the same architecture); returns the same
    tree of numpy arrays."""
    with np.load(os.path.join(module_path, "params.npz")) as z:
        flat = tree_leaves_sorted(like_params)
        if len(z.files) != len(flat):
            raise ValueError(
                f"params.npz has {len(z.files)} leaves but the "
                f"architecture expects {len(flat)} — wrong phi config?")
        leaves = [np.asarray(z[f"p{i}"]) for i in range(len(flat))]
        for got, want in zip(leaves, flat):
            if got.shape != tuple(want.shape):
                raise ValueError(
                    f"params.npz leaf shape {got.shape} != expected "
                    f"{tuple(want.shape)} — wrong phi config?")
        return tree_unflatten(like_params, leaves, sort=True)


def load_phi_module(model, module_path: str, like_params=None):
    """A module dir of either kind back into the numpy parameter tree of
    `model`: params.npz (MFN; needs `like_params`, a freshly initialised
    tree), or the raw binaries with encoder.npz beside them where the
    family has frozen encoder parameters (FFN)."""
    if os.path.exists(os.path.join(module_path, "params.npz")):
        return load_phi_module_npz(module_path, like_params)
    params = {"layers": load_model(module_path)}
    enc_path = os.path.join(module_path, "encoder.npz")
    if os.path.exists(enc_path):
        with np.load(enc_path) as z:
            params["encoder"] = {k: np.asarray(z[k]) for k in z.files}
    elif like_params is not None and "encoder" in like_params:
        # an archive written without encoder.npz: the regenerated draw
        params["encoder"] = {k: _np(v)
                             for k, v in like_params["encoder"].items()}
    return params


def copy_dir(old_dir: str, new_dir: str) -> None:
    """Flat file copy (reference utils/ModelSave.py:54-61)."""
    os.makedirs(new_dir, exist_ok=True)
    for fname in os.listdir(old_dir):
        shutil.copy(os.path.join(old_dir, fname), os.path.join(new_dir, fname))
