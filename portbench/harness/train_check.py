"""The train cells' comparison with the reference.

The program's first steps (capture.FirstSteps) are judged against the
plain reference (reference/siren.py), which works out again each chain's
width, volume, normalization, weights and threshold (reference/derive.py).
The program's random draws are its own choice, so the reference follows
them: it starts from the program's initial parameters and its drawn voxels
after checking both on their own (the layout: widths, the SIREN init
bounds, the zero padding of a fleet's narrower chains; the batch: every
coordinate on the grid and every value and weight the reference's own at
that voxel).  From there it computes three steps itself.

Numbers compared (each against its limit in limits/<cell>.json):
  layout_faults  entries off their shape, out of their init bound, or
                 non-zero in a fleet chain's padding (exact: limit 0)
  batch_faults   drawn points whose coordinate lies off its grid point, or
                 whose value or weight is not the reference's at that
                 voxel, by more than float32 rounding (exact: limit 0)
  loss_gap       the largest relative gap of steps 1-3's losses
  grad_gap       the first gradient as the optimizer holds it after step 1
                 (first moment / (1 - b1)), by the worst leaf: the gap
                 between the program's and the reference's norms over the
                 larger of that leaf's reference norm and the median
                 leaf's
  update_gap     the parameters' change over three steps, each leaf's gap
                 taken the same way, and of those the median leaf's,
                 leaving out leaves whose reference gradient is under a
                 thousandth of the median leaf's.  Not the worst leaf:
                 Adamax scales each element's step by the size of that
                 element's own gradients, so an element whose gradient all
                 but cancels over the batch carries the rounding of the
                 products into its step many times over, and the worst
                 leaf's gap read from 3e-6 to 2e-3 over seeds of a sound
                 program, the median leaf's from 1.8e-7 to 5.5e-7
                 (PERF.md)
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import derive, siren

B1 = 0.9


@dataclass
class Chain:
    """What the reference knows of one network: its layer shapes, its
    normalized volume and weights (d, h, w, c), its loss threshold."""
    dims: List[Tuple[int, int]]
    volume: np.ndarray
    weights: np.ndarray
    thres: Optional[float]


@dataclass
class Setting:
    chains: List[Chain]
    w0: float
    mode: str
    lr: float
    milestones: Sequence[int]
    gamma: float
    value_range: float          # width of the Normalize range


def setting(task: str, config: Dict) -> Setting:
    """Work out, from the configuration (a plain dict of the yaml's
    schema) and its volume, what the program trains: one chain
    ("single") or one a block ("divide")."""
    cf = config["CompressFramework"]
    cc = cf["Compress"]
    phi = cf["Module"]["phi"]
    path = config["Dataset"]["data_path"]
    vol = derive.preprocess(derive.read_volume(path),
                            cc["preprocess"]["denoise"]["level"],
                            cc["preprocess"]["clip"])
    given = cc["param"]["given_size"]
    budget = float(given) if given > 0 else \
        derive.budget_bytes(path, cc["param"]["filesize_ratio"])
    if task == "divide":
        blocks = derive.blocks(vol, cc["divide"]["divide_type"])
        parts = [b["data"] for b in blocks]
        budgets = derive.split_by_var(budget, parts)
        if min(budgets) < cc["divide"]["param_size_thres"]:
            raise NotImplementedError("a block below the budget threshold")
    else:
        parts, budgets = [vol], [budget]
    norm = cf["Normalize"]["name"]
    chains = []
    for part, b in zip(parts, budgets):
        f = derive.siren_width(b, phi["layers"], phi["coords_channel"],
                               phi["data_channel"])
        x, mn, mx = derive.normalize(part, norm)
        thres = cc["loss"].get("weight_thres")
        t = derive.normalized_value(thres, norm, mn, mx) if thres else None
        chains.append(Chain(
            dims=derive.siren_dims(f, phi["layers"], phi["coords_channel"],
                                   phi["data_channel"]),
            volume=x, weights=derive.loss_weights(part, cc["loss"]["weight"]),
            thres=t))
    sched = cc.get("lr_scheduler_phi") or {}
    _, a, b = norm.split("_")
    return Setting(chains=chains, w0=float(phi["w0"]),
                   value_range=float(b) - float(a),
                   mode=cc["coords_mode"], lr=float(cc["lr_phi"]),
                   milestones=sched.get("milestones", []) if
                   sched.get("name") == "MultiStepLR" else [],
                   gamma=float(sched.get("gamma", 0.1)))


def _chain_leaves(layers: List[Dict[str, torch.Tensor]], b: Optional[int],
                  dims) -> List[torch.Tensor]:
    """Chain b's true-width leaves (W, b per layer) of the program's
    parameters (stacked along a first axis when b is not None)."""
    out = []
    for layer, (fi, fo) in zip(layers, dims):
        w, bias = layer["w"], layer["b"]
        if b is not None:
            w, bias = w[b], bias[b]
        out += [w[:fi, :fo], bias[:fo]]
    return out


def _padding_nonzero(layers, b: Optional[int], dims) -> int:
    if b is None:
        return 0
    n = 0
    for layer, (fi, fo) in zip(layers, dims):
        w, bias = layer["w"][b].clone(), layer["b"][b].clone()
        w[:fi, :fo] = 0
        bias[:fo] = 0
        n += int(torch.count_nonzero(w)) + int(torch.count_nonzero(bias))
    return n


def _init_faults(leaves: List[torch.Tensor], dims) -> int:
    """Entries outside the SIREN init's bounds (first layer U(±1/fan_in),
    others U(±sqrt(6/fan_in)/30), biases U(±1/sqrt(fan_in)))."""
    n = 0
    for i, (fi, _) in enumerate(dims):
        wb = 1.0 / fi if i == 0 else math.sqrt(6.0 / fi) / 30.0
        n += int((leaves[2 * i].abs() > wb * (1 + 1e-6)).sum())
        n += int((leaves[2 * i + 1].abs() > (1 + 1e-6) / math.sqrt(fi)).sum())
    return n


# float32 rounding, with room: coordinates lie in the coords_mode range
# (|c| <= 1 here), normalized values in the Normalize range (0-100 here)
COORD_TOL = 1e-6
VALUE_TOL = 1e-6        # of the normalized range's width
WEIGHT_TOL = 1e-6


def voxel_indices(coords: torch.Tensor, shape: Sequence[int], mode: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-axis voxel indices (N, ndim) of drawn coordinates, and whether
    each coordinate lies off that grid point (N,)."""
    lo, _ = derive.coords_mode(mode)
    idx = []
    off = torch.zeros(coords.shape[0], dtype=torch.bool, device=coords.device)
    for a, n in enumerate(shape):
        step = derive.axis_step(n, mode)
        c = coords[:, a].double()
        i = torch.round((c - lo) / step).long() if step else \
            torch.zeros_like(c, dtype=torch.long)
        i = i.clamp(0, n - 1)
        grid = (torch.tensor(lo, dtype=torch.float32, device=c.device)
                + i.float() * torch.tensor(step, dtype=torch.float32,
                                           device=c.device))
        off |= (coords[:, a] - grid).abs() > COORD_TOL
        idx.append(i)
    return torch.stack(idx, -1), off


def grid_coords(idx: torch.Tensor, shape: Sequence[int], mode: str,
                dtype) -> torch.Tensor:
    lo, _ = derive.coords_mode(mode)
    return torch.stack([lo + idx[:, a].to(dtype) * derive.axis_step(n, mode)
                        for a, n in enumerate(shape)], -1)


def _leaf_gaps(prog: List[torch.Tensor], ref: List[torch.Tensor],
               skip: Optional[List[bool]] = None) -> List[float]:
    """Each leaf's |‖p‖ - ‖r‖| / max(‖r‖, median leaf ‖r‖)."""
    pn = [float(torch.linalg.vector_norm(p.double())) for p in prog]
    rn = [float(torch.linalg.vector_norm(r.double())) for r in ref]
    keep = [i for i in range(len(rn)) if not (skip and skip[i])]
    med = float(np.median([rn[i] for i in keep]))
    return [abs(pn[i] - rn[i]) / max(rn[i], med, 1e-300) for i in keep]


def _layout(cap, st: Setting, fleet: bool) -> float:
    """Widths (raises on a mismatch), init bounds and padding."""
    p0, p3 = cap.steps[0]["layers"], cap.steps[3]["layers"]
    if len(p0) != len(st.chains[0].dims):
        raise RuntimeError(f"the program's chain has {len(p0)} layers, the "
                           f"configuration {len(st.chains[0].dims)}")
    faults = 0
    for k, b in enumerate(_chain_ids(st, fleet)):
        dims = st.chains[k].dims
        if fleet:
            got = [int(m[b].sum()) for m in cap.masks[:len(dims) - 1]]
            want = [fo for _, fo in dims[:-1]]
        else:
            got = [tuple(l["w"].shape) for l in p0]
            want = list(dims)
        if got != want:
            raise RuntimeError(f"chain {k}: the program's widths {got}, the "
                               f"reference's {want}")
        faults += _init_faults(_chain_leaves(p0, b, dims), dims) + \
            _padding_nonzero(p0, b, dims) + _padding_nonzero(p3, b, dims)
    return float(faults)


def _chain_ids(st: Setting, fleet: bool) -> List[Optional[int]]:
    return list(range(len(st.chains))) if fleet else [None]


def reference_steps(cap, st: Setting, fleet: bool, device, *,
                    dtype=torch.float64, tf32: bool = False,
                    half_batch: bool = False) -> Dict:
    """Three steps of the reference from the program's initial parameters
    on the program's drawn voxels: losses, first gradients and the change
    of every leaf, chain by chain, and the batch's distance from the
    reference's volume.  half_batch: on the first half of each batch (a
    fault put in the program's place)."""
    out = {"loss": [], "g1": [], "delta": [], "batch_faults": 0}
    steps = cap.steps
    for k, b in enumerate(_chain_ids(st, fleet)):
        ch = st.chains[k]
        shape = ch.volume.shape[:-1]
        c = ch.volume.shape[-1]
        vol = torch.from_numpy(ch.volume.reshape(-1, c)).to(device)
        wts = torch.from_numpy(ch.weights.reshape(-1, c)).to(device)
        strides = torch.tensor(
            np.cumprod((list(shape[1:]) + [1])[::-1])[::-1].copy(),
            device=device)
        start = [t.to(device) for t in
                 _chain_leaves(steps[0]["layers"], b, ch.dims)]
        params = [t.to(dtype).clone() for t in start]
        opt = siren.Adamax(st.lr, st.milestones, st.gamma)
        for s in range(3):
            rec = steps[s]
            pick = (lambda t: t[b]) if fleet else (lambda t: t)
            idx, off = voxel_indices(pick(rec["coords"]).to(device),
                                     shape, st.mode)
            flat = (idx * strides).sum(-1)
            v, w = vol[flat], wts[flat]
            bad = off | ((pick(rec["values"]).to(device) - v).abs()
                         > VALUE_TOL * st.value_range).any(-1) \
                | ((pick(rec["weights"]).to(device) - w).abs()
                   > WEIGHT_TOL).any(-1)
            out["batch_faults"] += int(bad.sum())
            x = grid_coords(idx, shape, st.mode, dtype)
            v, w = v.to(dtype), w.to(dtype)
            if half_batch:
                n = x.shape[0] // 2
                x, v, w = x[:n], v[:n], w[:n]
            pairs = list(zip(params[::2], params[1::2]))
            loss, grads = siren.loss_and_grads(pairs, x, v, w, st.w0,
                                               ch.thres, tf32)
            opt.step(params, grads)
            out["loss"].append(float(loss))
            if s == 0:
                out["g1"] += grads
        out["delta"] += [p - s0.to(dtype) for p, s0 in zip(params, start)]
    return out


def program_steps(cap, st: Setting, fleet: bool, device) -> Dict:
    """The same quantities as the program took them: its losses, the first
    gradient out of its optimizer's first moments, its parameters' change
    over three steps."""
    out = {"loss": [], "g1": [], "delta": []}
    p0, p3 = cap.steps[0]["layers"], cap.steps[3]["layers"]
    mu = _as_layers(cap.mu1, p0)
    for k, b in enumerate(_chain_ids(st, fleet)):
        dims = st.chains[k].dims
        for s in range(3):
            loss = cap.steps[s]["loss"]
            out["loss"].append(float(loss[b] if fleet else loss))
        out["g1"] += [m.to(device) / (1.0 - B1)
                      for m in _chain_leaves(mu, b, dims)]
        out["delta"] += [q.to(device) - p.to(device) for p, q in
                         zip(_chain_leaves(p0, b, dims),
                             _chain_leaves(p3, b, dims))]
    return out


def check(cap, st: Setting, fleet: bool, device, *,
          control: Optional[str] = None) -> Dict[str, float]:
    """The numbers compared.  control: None judges the program; 'tf32'
    puts the reference with TF32 products in the program's place (the
    control); 'half_batch' the reference on half of each batch, and
    'unchanged' parameters that never move (faults)."""
    if len(cap.steps) < 4:
        raise RuntimeError(f"recorded {len(cap.steps)} steps of 4: the loop "
                           "did not run its first steps through the hooks")
    out = {"layout_faults": _layout(cap, st, fleet)}
    ref = reference_steps(cap, st, fleet, device)
    out["batch_faults"] = float(ref["batch_faults"])
    if control is None:
        prog = program_steps(cap, st, fleet, device)
    elif control == "tf32":
        prog = reference_steps(cap, st, fleet, device, dtype=torch.float32,
                               tf32=True)
    elif control == "half_batch":
        prog = reference_steps(cap, st, fleet, device, half_batch=True)
    elif control == "unchanged":
        prog = dict(ref, delta=[torch.zeros_like(d) for d in ref["delta"]])
    else:
        raise ValueError(control)
    return _gaps(out, prog, ref)


def _as_layers(flat: List[torch.Tensor], like) -> List[Dict]:
    """The optimizer's leaf list back into the parameters' layer dicts."""
    it = iter(flat)
    return [{k: next(it) for k in layer} for layer in like]


def _gaps(out, prog, ref) -> Dict[str, float]:
    out["loss_gap"] = max(abs(p - r) / abs(r)
                          for p, r in zip(prog["loss"], ref["loss"]))
    norms = [float(torch.linalg.vector_norm(g)) for g in ref["g1"]]
    med = float(np.median(norms))
    skip = [n < 1e-3 * med for n in norms]
    out["grad_gap"] = max(_leaf_gaps(prog["g1"], ref["g1"]))
    out["update_gap"] = float(np.median(
        _leaf_gaps(prog["delta"], ref["delta"], skip)))
    return out
