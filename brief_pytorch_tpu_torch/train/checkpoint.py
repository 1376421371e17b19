"""Training-state checkpointing: true resume for preempted runs.

Torch port of brief_pytorch_tpu/train/checkpoint.py.  At every checkpoint
the trainers write their whole training state, atomically (a temporary
file renamed, so that a preemption mid-write leaves the previous state
intact): parameters, optimizer state (the step count the LR schedule
reads, then the moments), the sampler generator's state, the step and a
JSON fingerprint of the config.  `Compress.resume: <path>` (or the CLI's
`-resume`) loads it and continues the run where it stopped; a resumed run
is bitwise equal to an uninterrupted one with the same checkpoint grid
(tests/test_torch_resume.py).

Format: one .npz.  Parameter leaves are p{i} in jax.tree_util order (dict
keys sorted: a layer's b before its w), the names and shapes the JAX
package's `pack_tree` gives; optimizer leaves o{i} are the count, then
the first moments, then the second, each in the trainer's leaf order
(core/tree.py tree_leaves); `key` is the generator's state, or under
data parallelism (Compress.data_shards) one row per rank.  Leaves are
read back into templates rebuilt by the same init code, so no tree
structure is stored; a fingerprint, shape or generator mismatch raises
ValueError instead of training from a state that does not fit.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from brief_pytorch_tpu_torch.core.tree import tree_leaves_sorted


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def pack_tree(arrs: Dict[str, np.ndarray], prefix: str, tree) -> None:
    """tree's leaves into arrs as {prefix}{i} host arrays, in
    jax.tree_util order."""
    for i, leaf in enumerate(tree_leaves_sorted(tree)):
        arrs[f"{prefix}{i}"] = _host(leaf)


def _load_leaf(z, key: str, tmpl: torch.Tensor, what: str,
               rows=None) -> None:
    if key not in z:
        raise ValueError(f"training state {what} has no leaf {key}")
    arr = z[key] if rows is None else z[key][rows]
    if tuple(arr.shape) != tuple(tmpl.shape):
        raise ValueError(
            f"training state {what} leaf {key} has shape {arr.shape}, "
            f"expected {tuple(tmpl.shape)}")
    with torch.no_grad():
        tmpl.copy_(torch.from_numpy(np.array(arr)))


def unpack_tree(z, prefix: str, template, what: str = "tree", rows=None):
    """Copy the {prefix}{i} arrays of z into the leaves of `template` (a
    tree of tensors built by the same init code), in place, each on its
    leaf's device and dtype; returns template.  rows: only these rows of
    each stored leaf (a rank's blocks of a stacked bucket).  A missing
    leaf or a shape mismatch means the state was written under another
    config: it raises ValueError naming the leaf."""
    for i, tmpl in enumerate(tree_leaves_sorted(template)):
        _load_leaf(z, f"{prefix}{i}", tmpl, what, rows)
    return template


def pack_opt(arrs: Dict[str, np.ndarray], prefix: str, opt_state: Dict
             ) -> None:
    """The optimizer state (train/optim.py) into arrs as {prefix}{i} host
    arrays: the count, then the first and second moments."""
    arrs[f"{prefix}0"] = np.asarray(opt_state["count"], np.int32)
    for i, t in enumerate(opt_state["mu"] + opt_state["nu"]):
        arrs[f"{prefix}{i + 1}"] = _host(t)


def unpack_opt(z, prefix: str, opt_state: Dict, what: str = "opt_state",
               rows=None) -> None:
    """Restore pack_opt's leaves (only `rows` of each) into opt_state, in
    place."""
    key = f"{prefix}0"
    if key not in z:
        raise ValueError(f"training state {what} has no leaf {key}")
    for i, tmpl in enumerate(opt_state["mu"] + opt_state["nu"]):
        _load_leaf(z, f"{prefix}{i + 1}", tmpl, what, rows)
    opt_state["count"] = int(z[key])


def unpack_generator(z, key: str, gen: torch.Generator, row=None) -> None:
    """Restore a generator's state saved as gen.get_state() (row: the
    rank's row of a stack of them); a state of another kind of generator
    (CPU and CUDA states differ in size) raises ValueError naming the
    leaf."""
    state = np.asarray(z[key] if row is None else z[key][row], np.uint8)
    want = gen.get_state().numel()
    if state.size != want:
        raise ValueError(
            f"training state leaf {key} holds a generator state of "
            f"{state.size} bytes, expected {want} (a {gen.device.type} "
            "generator): the state was written on another device")
    gen.set_state(torch.from_numpy(state.copy()))


def fingerprint_bytes(fingerprint: Dict) -> np.ndarray:
    return np.frombuffer(
        json.dumps(fingerprint, sort_keys=True).encode(), np.uint8)


def check_fingerprint(z, fingerprint: Dict, path: str) -> None:
    stored = json.loads(bytes(z["fingerprint"].tobytes()).decode())
    if stored != fingerprint:
        raise ValueError(
            f"training state {path} was written under a different "
            f"config:\n  stored:  {stored}\n  current: {fingerprint}")


def atomic_savez(path: str, arrs: Dict[str, np.ndarray]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, path)


def resolve_trainstate(path: str, default_name: str = "trainstate.npz"
                       ) -> str:
    """Accept a state file or a run dir containing one."""
    if os.path.isdir(path):
        path = os.path.join(path, default_name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no training state to resume from at {path}")
    return path


def save_trainstate(path: str, params: Dict, opt_state: Dict, gen,
                    step: int, fingerprint: Dict) -> None:
    """Atomically write a single-trainer state (NFGR.compress).  gen: the
    generator, or every rank's generator state stacked (data
    parallelism)."""
    arrs: Dict[str, np.ndarray] = {}
    pack_tree(arrs, "p", params)
    pack_opt(arrs, "o", opt_state)
    arrs["key"] = gen.get_state().numpy() \
        if isinstance(gen, torch.Generator) else np.asarray(gen)
    arrs["step"] = np.asarray(int(step))
    arrs["fingerprint"] = fingerprint_bytes(fingerprint)
    atomic_savez(path, arrs)


def load_trainstate(path: str, params: Dict, opt_state: Dict,
                    gen: torch.Generator, fingerprint: Dict,
                    rank: int = 0) -> int:
    """Load a save_trainstate file into params, opt_state and gen (built
    by the same init code, so only values are swapped in), in place;
    returns the stored step.  The stored fingerprint must be the
    caller's; a state of every rank's generators gives gen rank `rank`'s
    (the fingerprint's data_shards fixes their number)."""
    with np.load(path) as z:
        check_fingerprint(z, fingerprint, path)
        unpack_tree(z, "p", params, "params")
        unpack_opt(z, "o", opt_state)
        unpack_generator(z, "key", gen,
                         rank if z["key"].ndim == 2 else None)
        return int(z["step"])
