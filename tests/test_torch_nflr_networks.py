"""The port's NFLR networks (brief_pytorch_tpu_torch/nflr/networks.py)
against the JAX package's (brief_pytorch_tpu/nflr/networks.py), on the CPU,
on JAX-initialised weights: every network's forward within 1e-5 (relative
and absolute, to the output's scale) and its gradients (of a fixed
quadratic of the output, for every parameter and the input) within 1e-4.

Sizes: SIREN 4 x 16, y_channel 8, ps 8, z_channel 4, a 2 x 2 x 2 patch
grid, 24 coordinates a patch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brief_pytorch_tpu.nflr import networks as jn
from brief_pytorch_tpu_torch.core.tree import tree_leaves_sorted
from brief_pytorch_tpu_torch.nflr import networks as pn
from brief_pytorch_tpu_torch.nflr.framework import (params_from_numpy,
                                                    value_and_grad)

FWD = 1e-5
GRAD = 1e-4


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(a, b, tol, what=""):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a.detach()), b, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(b).max())),
                               err_msg=what)


def _check(jnet, pnet, x, apply=None, seed=0):
    """Forward and gradients of (out * w).sum() for a fixed random w,
    w.r.t. the parameters and the input x."""
    jp = jax.tree_util.tree_map(np.asarray,
                                jnet.init(jax.random.PRNGKey(seed)))
    pp = params_from_numpy(jp)
    apply = apply or (lambda net, p, v: net.apply(p, v))
    jo = apply(jnet, jp, jnp.asarray(x))
    po = apply(pnet, pp, t(x))
    outs_j = jo if isinstance(jo, (tuple, list)) else [jo]
    outs_p = po if isinstance(po, (tuple, list)) else [po]
    for a, b in zip(outs_p, outs_j):
        _close(a, b, FWD, "forward")
    rng = np.random.default_rng(seed + 1)
    ws = [rng.normal(size=np.asarray(b).shape).astype(np.float32)
          for b in outs_j]

    def jloss(p, v):
        o = apply(jnet, p, v)
        o = o if isinstance(o, (tuple, list)) else [o]
        return sum((a * w).sum() for a, w in zip(o, ws))

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))

    def ploss(tr):
        o = apply(pnet, tr["p"], tr["x"])
        o = o if isinstance(o, (tuple, list)) else [o]
        return sum((a * t(w)).sum() for a, w in zip(o, ws))

    _, g = value_and_grad(ploss, {"p": pp, "x": t(x)})
    _close(g["x"], jgx, GRAD, "input grad")
    for i, (a, b) in enumerate(zip(tree_leaves_sorted(g["p"]),
                                   jax.tree_util.tree_leaves(jgp))):
        _close(a, b, GRAD, f"param grad {i}")


def test_crop_modulator():
    kw = dict(name="CropModulator", y_channel=8, dim_hidden=16, layers=3)
    y = np.random.default_rng(0).normal(0, 1, (2, 8, 2, 2, 2))
    _check(jn.init_gmod(**kw), pn.init_gmod(**kw), y,
           lambda net, p, v: list(net.apply(p, v)))


def test_modulator():
    kw = dict(name="Modulator", y_channel=8, dim_hidden=16, layers=3)
    y = np.random.default_rng(1).normal(0, 1, (5, 8))
    _check(jn.init_gmod(**kw), pn.init_gmod(**kw), y,
           lambda net, p, v: list(net.apply(p, v)))


@pytest.mark.parametrize("cropped", [True, False])
def test_siren_forward_syn(cropped):
    """The modulated SIREN (first w0 30, hidden 30) through fast_sin_cached,
    with the modulations and the coordinates differentiated."""
    from brief_pytorch_tpu.models.phi import init_phi as jphi
    phi = jphi({"name": "SIREN", "coords_channel": 3, "data_channel": 1,
                "features": 16, "layers": 4, "w0": 30})
    jp = jax.tree_util.tree_map(np.asarray,
                                phi.init(jax.random.PRNGKey(0)))["layers"]
    rng = np.random.default_rng(2)
    if cropped:
        coords = rng.uniform(-1, 1, (2, 2, 2, 2, 24, 3)).astype(np.float32)
        mods = [rng.normal(0, 1, (2, 16, 2, 2, 2)).astype(np.float32)
                for _ in range(3)]
        jfn, pfn = jn.siren_forward_syn, pn.siren_forward_syn
    else:
        coords = rng.uniform(-1, 1, (2, 24, 3)).astype(np.float32)
        mods = [rng.normal(0, 1, (2, 16)).astype(np.float32)
                for _ in range(3)]
        jfn, pfn = jn.siren_forward_syn_wocrop, pn.siren_forward_syn_wocrop
    w = rng.normal(size=coords.shape[:-1] + (1,)).astype(np.float32)
    jl = lambda L, c, m: (jfn(L, c, m, 30.0, 30.0) * w).sum()
    jv, jg = jax.value_and_grad(jl, argnums=(0, 1, 2))(
        jp, jnp.asarray(coords), [jnp.asarray(m) for m in mods])
    pl, g = value_and_grad(
        lambda tr: (pfn(tr["L"], tr["c"], tr["m"], 30.0, 30.0)
                    * t(w)).sum(),
        {"L": params_from_numpy(jp), "c": t(coords),
         "m": [t(m) for m in mods]})
    _close(pn.siren_forward_syn(params_from_numpy(jp), t(coords),
                                [t(m) for m in mods]) if cropped else
           pn.siren_forward_syn_wocrop(params_from_numpy(jp), t(coords),
                                       [t(m) for m in mods]),
           jfn(jp, jnp.asarray(coords), [jnp.asarray(m) for m in mods]),
           FWD, "forward")
    np.testing.assert_allclose(float(pl), float(jv), rtol=FWD, atol=FWD)
    _close(g["c"], jg[1], GRAD, "coords grad")
    for a, b in zip(g["m"], jg[2]):
        _close(a, b, GRAD, "mods grad")
    for i, (a, b) in enumerate(zip(tree_leaves_sorted(g["L"]),
                                   jax.tree_util.tree_leaves(jg[0]))):
        _close(a, b, GRAD, f"layer grad {i}")


def test_crop_conv3d_stridedown():
    kw = dict(name="CropConv3dStridedown", ps_d=8, ps_h=8, ps_w=8,
              data_channel=1, y_channel=8)
    x = np.random.default_rng(3).uniform(0, 100, (1, 2, 2, 2, 1, 8, 8, 8))
    _check(jn.init_hy(**dict(kw)), pn.init_hy(**dict(kw)), x)


def test_conv3d_stridedown_pooling():
    kw = dict(name="Conv3dStridedownPooling", data_channel=1,
              y_channel=800, stridedown_layers=2, ps_d=8)
    x = np.random.default_rng(4).normal(0, 1, (1, 1, 16, 24, 24))
    _check(jn.init_hy(**dict(kw)), pn.init_hy(**dict(kw)), x)


def test_channel_shrink_and_mean_scale():
    y = np.random.default_rng(5).normal(0, 2, (1, 8, 3, 3, 3))
    _check(jn.init_hz(name="PlainConv3dChannelShrink", y_channel=8,
                      z_channel=4, layers=2),
           pn.init_hz(name="PlainConv3dChannelShrink", y_channel=8,
                      z_channel=4, layers=2), y)
    z = np.random.default_rng(6).normal(0, 2, (1, 4, 3, 3, 3))
    _check(jn.init_gy(name="PlainConv3dMeanScale", y_channel=8, z_channel=4,
                      layers=2),
           pn.init_gy(name="PlainConv3dMeanScale", y_channel=8, z_channel=4,
                      layers=2), z)


def test_projector():
    x = np.random.default_rng(7).normal(0, 1, (1, 16, 3, 3, 3))
    _check(jn.Projector(16, 2, 2), pn.Projector(16, 2, 2), x)


def test_adaptive_pool3d_matches_torch_bins():
    """adaptive_pool3d's windows are torch's AdaptiveAvg/MaxPool3d's."""
    x = torch.randn(2, 3, 7, 11, 13, generator=torch.Generator().manual_seed(0))
    for out in ((4, 10, 10), (3, 5, 6), (7, 11, 13)):
        torch.testing.assert_close(pn.adaptive_pool3d(x, out, "avg"),
                                   torch.nn.functional.adaptive_avg_pool3d(
                                       x, out), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(pn.adaptive_pool3d(x, out, "max"),
                                   torch.nn.functional.adaptive_max_pool3d(
                                       x, out), rtol=0, atol=0)


def test_init_shapes_and_bounds():
    """The port's own inits: the JAX package's shapes, torch's
    U(+-1/sqrt(fan_in)) bounds."""
    g = torch.Generator().manual_seed(0)
    for name, kw in (("CropConv3dStridedown",
                      dict(ps_d=8, ps_h=8, ps_w=8, data_channel=1,
                           y_channel=8)),):
        pp = pn.init_hy(name=name, **kw).init(g)
        jp = jn.init_hy(name=name, **kw).init(jax.random.PRNGKey(0))
        for a, b in zip(tree_leaves_sorted(pp), jax.tree_util.tree_leaves(jp)):
            assert tuple(a.shape) == tuple(b.shape)
    conv = pn.init_conv3d(g, 4, 8, (3, 3, 3))
    bound = 1 / np.sqrt(4 * 27)
    assert float(conv["w"].abs().max()) <= bound
    assert float(conv["w"].abs().max()) > 0.9 * bound
