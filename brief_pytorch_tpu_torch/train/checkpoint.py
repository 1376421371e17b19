"""Training-state checkpointing: the atomic trainstate.npz that
NFGR.compress writes at every checkpoint.

Torch port of the writer of brief_pytorch_tpu/train/checkpoint.py
(save_trainstate, atomic_savez, the JSON fingerprint): params leaves
p{i} of any parameter tree (core/tree.py's tree_leaves order), optimizer
leaves o{i} (the count, then the moments), the sampler
generator's state, the step and the fingerprint, written to a temporary
file and renamed so that a preemption mid-write leaves the previous state
intact.  Reading it back (`-resume`) is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from brief_pytorch_tpu_torch.core.tree import tree_leaves


def fingerprint_bytes(fingerprint: Dict) -> np.ndarray:
    return np.frombuffer(
        json.dumps(fingerprint, sort_keys=True).encode(), np.uint8)


def atomic_savez(path: str, arrs: Dict[str, np.ndarray]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, path)


def save_trainstate(path: str, params: Dict, opt_state: Dict,
                    gen: torch.Generator, step: int,
                    fingerprint: Dict) -> None:
    """Atomically write a single-trainer state (NFGR.compress)."""
    arrs: Dict[str, np.ndarray] = {}
    for i, t in enumerate(tree_leaves(params)):
        arrs[f"p{i}"] = t.detach().cpu().numpy()
    opt_leaves = [np.asarray(opt_state["count"], np.int32)] + \
        [t.detach().cpu().numpy() for t in opt_state["mu"] + opt_state["nu"]]
    for i, a in enumerate(opt_leaves):
        arrs[f"o{i}"] = a
    arrs["key"] = gen.get_state().numpy()
    arrs["step"] = np.asarray(int(step))
    arrs["fingerprint"] = fingerprint_bytes(fingerprint)
    atomic_savez(path, arrs)
