"""Adaptive blocking: quadtree/octree over the volume with optimal block
selection by an exact knapsack DP.

Copy of brief_pytorch_tpu/partition/tree.py (numpy only; the reference,
utils/adaptive_blocking.py:60-423, solves the same selection as a Gurobi
ILP).  The reference builds a full tree to max_level, prunes flat patches
(variance & mean thresholds), scores the rest with the FFT sharpness
feature and picks at most Nb blocks maximising

    sum_i  feature_i * x_i / (arity^level_i)

such that every deepest-level leaf's root-to-leaf path carries exactly one
selection (at most one where a member of the path is pruned), with no
selection above min_level.  Pruning cascades downward, so the problem
decomposes over the tree into the bottom-up knapsack

    A[v][k] = max( val(v)                      if v selectable, k >= 1
                 , knapsack over unpruned children of A[child][.] )

with A[leaf][k] = -inf when the unpruned leaf cannot be selected.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from brief_pytorch_tpu_torch.partition.divide import (BOUNDARY, bgr_to_gray,
                                                      cal_feature,
                                                      draw_rectangle)

NEG_INF = float("-inf")


@dataclass
class Patch:
    """One tree node: an axis-aligned sub-block of the volume
    (reference Patch2d/Patch3d, adaptive_blocking.py:25-58, 199-236)."""
    level: int
    order: Tuple[int, ...]           # per-axis order (z, y, x) or (y, x)
    parent: Optional["Patch"] = None
    children: List["Patch"] = field(default_factory=list)
    prune: bool = False
    feature: float = 0.0
    selected: bool = False
    x: int = 0
    y: int = 0
    z: int = 0
    w: int = 0
    h: int = 0
    d: int = 0
    data: Optional[np.ndarray] = None


class Tree:
    """Quadtree (ndim=2) / octree (ndim=3) with exact DP block selection."""

    def __init__(self, data: np.ndarray, max_level: int, var_thr: float,
                 e_thr: float):
        if data.ndim == 4 and data.shape[-1] == 1:
            data = data[..., 0]
        if data.ndim not in (2, 3):
            raise ValueError("data must be 2d or 3d (single channel)")
        for s in data.shape:
            if s % (2 ** max_level):
                raise ValueError(f"image size {data.shape} is not a multiple "
                                 f"of 2**{max_level}")
        self.data = data
        self.ndim = data.ndim
        self.arity = 2 ** self.ndim
        self.max_level = max_level
        self.root = Patch(level=0, order=(0,) * self.ndim)
        self._build(self.root)
        self.patch_list: List[Patch] = []
        self._collect(self.root)
        self._init_data()
        self._prune(var_thr, e_thr)
        self._score()

    def _build(self, parent: Patch):
        if parent.level >= self.max_level:
            return
        for combo in itertools.product(*[range(2)] * self.ndim):
            order = tuple(2 * o + c for o, c in zip(parent.order, combo))
            child = Patch(level=parent.level + 1, order=order, parent=parent)
            parent.children.append(child)
            self._build(child)

    def _collect(self, patch: Patch):
        self.patch_list.append(patch)
        for c in patch.children:
            self._collect(c)

    def _init_data(self):
        shape = self.data.shape
        for p in self.patch_list:
            sizes = [s // (2 ** p.level) for s in shape]
            starts = [sz * o for sz, o in zip(sizes, p.order)]
            if self.ndim == 3:
                p.d, p.h, p.w = sizes
                p.z, p.y, p.x = starts
                p.data = self.data[p.z:p.z + p.d, p.y:p.y + p.h,
                                   p.x:p.x + p.w]
            else:
                p.h, p.w = sizes
                p.y, p.x = starts
                p.data = self.data[p.y:p.y + p.h, p.x:p.x + p.w]

    def _prune(self, var_thr: float, e_thr: float):
        """Deactivate flat subtrees (reference adaptive_blocking.py:341-352):
        variance <= var_thr AND |mean| <= e_thr prunes the node and every
        descendant."""
        count = 0
        for p in self.patch_list:
            if p.prune:
                continue
            d = p.data.astype(np.float64)
            if ((d - d.mean()) ** 2).mean() <= var_thr and abs(d.mean()) <= e_thr:
                stack = [p]
                while stack:
                    q = stack.pop()
                    if not q.prune:
                        q.prune = True
                        count += 1
                    stack.extend(q.children)
        self.prune_count = count

    def _score(self):
        for p in self.patch_list:
            if not p.prune:
                # a 3-D node goes to cal_feature with a trailing channel so
                # it takes the 3-axis FFT branch (3 dims there mean an
                # (h, w, c) image)
                d = p.data[..., None] if self.ndim == 3 else p.data
                p.feature = cal_feature(d)

    def solve_optim(self, Nb: int, min_level: int) -> float:
        """Exact DP equal to the ILP optimum.  Marks .selected."""
        self.Nb = Nb

        def value(p: Patch) -> float:
            return p.feature / (self.arity ** p.level)

        choices: Dict[int, list] = {}

        def solve(p: Patch) -> np.ndarray:
            leaves_below = self.arity ** (self.max_level - p.level)
            cap = min(Nb, leaves_below)
            selectable = (not p.prune) and p.level >= min_level
            if not p.children:  # deepest level
                A = np.full(cap + 1, NEG_INF)
                ch = [None] * (cap + 1)
                if selectable and cap >= 1:
                    A[1:] = value(p)
                    for k in range(1, cap + 1):
                        ch[k] = "select"
                choices[id(p)] = ch
                return A
            child_tables = [solve(c) for c in p.children if not c.prune]
            # knapsack over the unpruned children (pruned ones need nothing)
            cur = np.array([0.0])
            alloc: List[Optional[tuple]] = [()]
            for At in child_tables:
                m = min(cap, len(cur) - 1 + len(At) - 1)
                new = np.full(m + 1, NEG_INF)
                new_alloc: List[Optional[tuple]] = [None] * (m + 1)
                for a in range(len(cur)):
                    if cur[a] == NEG_INF or alloc[a] is None:
                        continue
                    for b in range(len(At)):
                        if At[b] == NEG_INF:
                            continue
                        j = a + b
                        if j > m:
                            break
                        v = cur[a] + At[b]
                        if v > new[j]:
                            new[j] = v
                            new_alloc[j] = alloc[a] + (b,)
                cur, alloc = new, new_alloc
            # pad to cap+1 and make monotone (<=k means best over <=k)
            A = np.full(cap + 1, NEG_INF)
            ch: List = [None] * (cap + 1)
            upto = min(cap, len(cur) - 1)
            best_v, best_a = NEG_INF, None
            for k in range(cap + 1):
                if k <= upto and cur[k] > best_v:
                    best_v, best_a = cur[k], alloc[k]
                if best_a is not None:
                    A[k] = best_v
                    ch[k] = ("children", best_a)
            if selectable:
                v = value(p)
                for k in range(1, cap + 1):
                    if v > A[k]:
                        A[k] = v
                        ch[k] = "select"
            choices[id(p)] = ch
            return A

        A_root = solve(self.root)
        obj = A_root[int(np.argmax(A_root))]
        if obj == NEG_INF:
            raise ValueError("infeasible: Nb too small for min_level")

        def mark(p: Patch, k: int):
            ch = choices[id(p)][k]
            if ch == "select":
                p.selected = True
                return
            _, split = ch
            kids = [c for c in p.children if not c.prune]
            for c, b in zip(kids, split):
                mark(c, b)

        # the smallest budget achieving the optimum (splits stored per k)
        for k in range(len(A_root)):
            if A_root[k] == obj:
                mark(self.root, k)
                break
        self.objective = float(obj)
        return self.objective

    def get_active(self) -> List[Patch]:
        return [p for p in self.patch_list if (not p.prune) and p.selected]

    def draw(self, data: np.ndarray) -> np.ndarray:
        """Draw selected-block boundaries (value 2000, clamped to the dtype,
        for 3-D; a red rectangle for 2-D) — reference
        adaptive_blocking.py:115-123, 360-373."""
        marker = BOUNDARY
        if np.issubdtype(data.dtype, np.integer):
            marker = min(BOUNDARY, int(np.iinfo(data.dtype).max))
        for p in self.get_active():
            if self.ndim == 3:
                x, y, z, w, h, d = p.x, p.y, p.z, p.w, p.h, p.d
                data[z, y:y + h, x:x + w] = marker
                data[z + d - 1, y:y + h, x:x + w] = marker
                data[z:z + d, y, x:x + w] = marker
                data[z:z + d, y + h - 1, x:x + w] = marker
                data[z:z + d, y:y + h, x] = marker
                data[z:z + d, y:y + h, x + w - 1] = marker
            else:
                draw_rectangle(data, p.y, p.x, p.y + p.h, p.x + p.w)
        return data


# alias names mirroring the reference API
QuadTree = Tree
OctTree = Tree


def _to_gray(img: np.ndarray) -> np.ndarray:
    """Single-channel scoring input: the channel itself, or the gray of the
    first three channels read as RGB (cv2's RGB2GRAY weights), rounded
    back to the dtype."""
    if img.shape[-1] == 1:
        return img[..., 0]
    gray = bgr_to_gray(img[..., :3][..., ::-1])
    if np.issubdtype(img.dtype, np.integer):
        gray = np.rint(gray)
    return gray.astype(img.dtype)


def adaptive_cal_tree(data: np.ndarray, param_size: float,
                      var_thr: float = -1, e_thr: float = -1,
                      maxl: int = -1, minl: int = -1, Nb: int = -1):
    """Build + solve the adaptive tree for a (d, h, w, c) volume or an
    (h, w, c) image (reference adaptive_blocking.py:385-423; the JAX
    package reads the file itself, the port takes the array).

    Nb defaults to param_size/(4*1361) — the average SIREN block heuristic;
    minl = floor(log_{arity}(Nb)) so blocks are as uniform as possible;
    maxl = minl + 2.  Returns (tree, boundary-drawn copy, dimension).
    """
    dimension = data.ndim - 1
    if dimension == 3:
        gray = data[..., 0] if data.shape[-1] == 1 else \
            np.stack([_to_gray(data[i]) for i in range(data.shape[0])])
    else:
        gray = _to_gray(data)
    if Nb == -1:
        Nb = max(1, int(param_size / (4 * 1361)))
    minl_calc = math.floor(math.log(Nb, 2 ** dimension)) if Nb > 1 else 0
    if minl == -1 or maxl == -1:
        minl = minl_calc
        maxl = minl + 2
    tree = Tree(gray, maxl, var_thr, e_thr)
    tree.solve_optim(Nb, minl)
    save_data = tree.draw(data.copy())
    return tree, save_data, dimension
