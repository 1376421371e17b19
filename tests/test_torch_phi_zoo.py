"""The whole φ zoo of the port against the JAX package, family by family.

Parameters initialised by the JAX package cross as numpy arrays
(params_from_numpy, same keys); the forward and every leaf's gradient of a
mean-squared loss then agree to float32 rounding: atol 2e-5 on the forward
(the chains share the fast sine; matmuls sum in different orders), 1e-5 +
rtol 1e-4 on gradients.  The MFNs at the reference's input_scale = 256 feed
sines with arguments of a few hundred, where a last-bit difference of the
argument moves the value by ~3e-5 and the products of four filters
compound it: forward within 1e-3 of max|JAX|, gradients within 2e-2
relative to each leaf's largest entry; at input_scale = 8 they meet the
chains' tolerances.
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from brief_pytorch_tpu.io import modelsave as jms
from brief_pytorch_tpu.models import phi as jphi
from brief_pytorch_tpu_torch.core.tree import (tree_leaves, tree_leaves_sorted,
                                               tree_unflatten)
from brief_pytorch_tpu_torch.io import modelsave as tms
from brief_pytorch_tpu_torch.models import phi as tphi

FAMILY_KEYS = {
    "SIREN": {}, "SIRENFT": {"ratio": 2.2},
    "SIREN_Pyramid": {"features_dis": 3}, "SIRENPS": {"ratio": 1.4},
    "SIREN_RELU": {}, "SIREN_SIGMOID": {},
    "SIRENPos": {"T": [2.0, 3.0, 2.0]}, "NeRF": {"frequencies": 4},
    "FFN": {"embsize": 12, "scale": 5},
    "MFNFourier": {"input_scale": 8.0}, "MFNGabor": {"input_scale": 8.0},
}
CHAINS = [n for n in FAMILY_KEYS if not n.startswith("MFN")]
CASES = [(n, 3, 4, 16) for n in FAMILY_KEYS] + \
    [(n, 2, 3, 8) for n in FAMILY_KEYS] + [
    ("SIREN", 3, 4, 16, {"res": True}),
    ("SIRENFT", 3, 5, 8, {"res": True, "output_act": True}),
    ("NeRF", 3, 4, 16, {"skip": False}), ("NeRF", 3, 3, 8, {}),
    ("FFN", 3, 4, 16, {"skip": True}), ("FFN", 2, 3, 8, {"skip": True}),
    ("SIREN_RELU", 3, 3, 8, {"output_act": True}),
    ("MFNFourier", 3, 4, 8, {"output_act": True}),
]


def _cfg(name, coords, layers, features, extra=None):
    cfg = {"name": name, "coords_channel": coords, "data_channel": 1,
           "layers": layers, "features": features, "w0": 20,
           **FAMILY_KEYS[name], **(extra or {})}
    if name == "SIRENPos":
        cfg["T"] = cfg["T"][:coords]
    return cfg


def _id(case):
    return "-".join(str(x) for x in case[:4]) + \
        ("".join(f"-{k}" for k in case[4]) if len(case) > 4 else "")


def _both(cfg, seed=0):
    jmodel = jphi.init_phi(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    as_np = jax.tree_util.tree_map(np.asarray, jparams)
    return jmodel, jparams, tphi.init_phi(cfg), tphi.params_from_numpy(as_np)


def _entries(spec):
    return [(e.kind, e.fan_in, e.fan_out, e.act, e.w0, e.w_init)
            for e in spec.entries]


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_forward_and_leaf_gradients_match_jax(case):
    cfg = _cfg(*case)
    jmodel, jparams, tmodel, tparams = _both(cfg)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (193, cfg["coords_channel"])).astype(np.float32)
    y = rng.uniform(0, 1, (193, 1)).astype(np.float32)
    mfn = cfg["name"].startswith("MFN")

    def jloss(p):
        return jnp.mean((jmodel.apply(p, jnp.asarray(x)) - y) ** 2)

    jl, jg = jax.value_and_grad(jloss)(jparams)
    jout = np.asarray(jmodel.apply(jparams, jnp.asarray(x)))
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    pred = tmodel.apply(tparams, torch.from_numpy(x))
    assert pred.shape == jout.shape == (193, 1)
    np.testing.assert_allclose(pred.detach().numpy(), jout, atol=2e-5,
                               rtol=1e-4 if mfn else 0)
    tl = torch.mean((pred - torch.from_numpy(y)) ** 2)
    grads = torch.autograd.grad(tl, leaves, allow_unused=True)
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-5)
    jflat = tree_leaves(jax.tree_util.tree_map(np.asarray, jg))
    # both walks follow the keys of one tree: the JAX gradient's
    assert len(jflat) == len(leaves)
    tgrads = _unflatten(tparams, grads)
    for (path, tg), jgrad in zip(_paths(tgrads), jflat_by(tgrads, jg)):
        if tg is None:        # FFN's frozen bvals: no gradient, JAX's zero
            assert path.endswith("bvals") and not np.any(jgrad)
            continue
        np.testing.assert_allclose(tg.numpy(), jgrad, atol=1e-5, rtol=1e-4,
                                   err_msg=path)


def _unflatten(like, flat):
    return tree_unflatten(like, list(flat))


def _paths(tree, prefix=""):
    """(path, leaf) pairs in insertion order; None leaves included."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def jflat_by(like, jtree):
    """Another tree's leaves as numpy, looked up by `like`'s keys, in
    `like`'s insertion order."""
    if isinstance(like, dict):
        for k in like:
            yield from jflat_by(like[k], jtree[k])
    elif isinstance(like, list):
        for a, b in zip(like, jtree):
            yield from jflat_by(a, b)
    else:
        yield np.asarray(jtree)


@pytest.mark.parametrize("name", ["MFNFourier", "MFNGabor"])
def test_mfn_at_the_reference_input_scale(name):
    """input_scale = 256 (the reference default): the looser tolerance
    stated in the module docstring."""
    cfg = _cfg(name, 3, 4, 16, {"input_scale": 256.0})
    jmodel, jparams, tmodel, tparams = _both(cfg)
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (257, 3)).astype(np.float32)
    jout = np.asarray(jmodel.apply(jparams, jnp.asarray(x)))
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    pred = tmodel.apply(tparams, torch.from_numpy(x))
    scale = float(np.abs(jout).max())
    assert np.abs(pred.detach().numpy() - jout).max() <= 1e-3 * scale
    jg = jax.grad(lambda p: jnp.mean(jmodel.apply(p, jnp.asarray(x)) ** 2))(
        jparams)
    grads = torch.autograd.grad((pred ** 2).mean(), leaves)
    for (path, tg), jgrad in zip(_paths(_unflatten(tparams, grads)),
                                 jflat_by(tparams, jg)):
        assert np.abs(tg.numpy() - jgrad).max() <= \
            2e-2 * np.abs(jgrad).max() + 1e-7, path


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in CHAINS],
                         ids=_id)
def test_spec_entries_match_jax(case):
    cfg = _cfg(*case)
    j, t = jphi.init_phi(cfg).spec, tphi.init_phi(cfg).spec
    assert _entries(j) == _entries(t)
    assert (j.skip_entry, j.encoder, tuple(j.encoder_cfg), j.num_linears) == \
        (t.skip_entry, t.encoder, tuple(t.encoder_cfg), t.num_linears)


@pytest.mark.parametrize("case", CASES[:22], ids=_id)
def test_init_has_jax_structure_count_and_bounds(case):
    """The port's own init: the JAX tree's keys and shapes, the same
    parameter count, reproducible from the generator's seed, and every
    leaf within its distribution's bound."""
    cfg = _cfg(*case)
    jparams = jphi.init_phi(cfg).init(jax.random.PRNGKey(0))
    tmodel = tphi.init_phi(cfg)
    tparams = tmodel.init(torch.Generator().manual_seed(3), "cpu")
    again = tmodel.init(torch.Generator().manual_seed(3), "cpu")
    # (jax.tree_util.tree_map hands dicts back with sorted keys)
    assert sorted(p for p, _ in _paths(tparams)) == sorted(
        p for p, _ in _paths(jax.tree_util.tree_map(np.asarray, jparams)))
    for (path, t), j, t2 in zip(_paths(tparams), jflat_by(tparams, jparams),
                                tree_leaves(again)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32, path
        assert torch.equal(t, t2), path
    assert tphi.get_param_count(tparams) == jphi.get_param_count(jparams)
    assert tmodel.serializable_chain == jphi.init_phi(cfg).serializable_chain
    if cfg["name"] in CHAINS:
        li = 0
        for e in tmodel.spec.entries:
            for k in range(2 if e.kind == "res" else 1):
                fan_in = e.fan_in if k == 0 else e.fan_out
                bound = {"default": 1 / np.sqrt(fan_in),
                         "siren": np.sqrt(6 / fan_in) / 30,
                         "siren_first": 1 / fan_in}[e.w_init]
                w = tparams["layers"][li]["w"]
                assert float(w.abs().max()) <= bound * (1 + 1e-6)
                assert float(tparams["layers"][li]["b"].abs().max()) <= \
                    1 / np.sqrt(fan_in) * (1 + 1e-6)
                if w.numel() >= 64:
                    assert float(w.abs().max()) > 0.6 * bound
                li += 1
    else:
        f = cfg["features"]
        for lin in tparams["linear"]:
            assert float(lin["w"].abs().max()) <= np.sqrt(1.0 / f) * 1.000001
        for flt in tparams["filters"]:
            assert float(flt["b"].abs().max()) <= np.pi * 1.000001
            if "mu" in flt:
                assert float(flt["mu"].abs().max()) <= 1.0
                assert bool((flt["gamma"] > 0).all())


@pytest.mark.parametrize("coords,emb,scale", [(3, 12, 5), (2, 256, 10)])
def test_ffn_bvals_bit_equal(coords, emb, scale):
    cfg = _cfg("FFN", coords, 4, 16, {"embsize": emb, "scale": scale})
    j = np.asarray(jphi.init_phi(cfg).init(
        jax.random.PRNGKey(0))["encoder"]["bvals"])
    t = tphi.init_phi(cfg).init(torch.Generator().manual_seed(9),
                                "cpu")["encoder"]["bvals"].numpy()
    assert t.dtype == np.float32 and t.shape == (emb, coords)
    np.testing.assert_array_equal(t, j)


def test_gabor_gamma_is_a_seeded_gamma_draw():
    cfg = _cfg("MFNGabor", 3, 5, 4096, {"alpha": 6.0, "beta": 2.0})
    p = tphi.init_phi(cfg).init(torch.Generator().manual_seed(0), "cpu")
    gamma = p["filters"][0]["gamma"].numpy()
    # Gamma(alpha / (layers - 1), rate beta): mean k / beta, var k / beta^2
    k = 6.0 / 4
    assert abs(gamma.mean() - k / 2.0) < 0.05
    assert abs(gamma.var() - k / 4.0) < 0.05
    q = tphi.init_phi(cfg).init(torch.Generator().manual_seed(0), "cpu")
    np.testing.assert_array_equal(gamma, q["filters"][0]["gamma"].numpy())


def test_tree_orders():
    """tree_leaves keeps insertion order (w then b); tree_leaves_sorted is
    jax.tree_util.tree_flatten's order, which numbers params.npz."""
    cfg = _cfg("MFNGabor", 3, 4, 8)
    jparams = jphi.init_phi(cfg).init(jax.random.PRNGKey(0))
    as_np = jax.tree_util.tree_map(np.asarray, jparams)
    for a, b in zip(tree_leaves_sorted(as_np),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))
    chain = {"layers": [{"w": 1, "b": 2}, {"w": 3, "b": 4}],
             "encoder": {"bvals": 5}}
    assert tree_leaves(chain) == [1, 2, 3, 4, 5]
    assert tree_leaves_sorted(chain) == [5, 2, 1, 4, 3]


@pytest.mark.parametrize("name", ["MFNFourier", "MFNGabor", "FFN", "NeRF",
                                  "SIREN"])
def test_module_dirs_cross_the_packages(tmp_path, name):
    """save_phi_module of either package is read back by the other into the
    same arrays: params.npz in tree_flatten order for the MFNs, raw
    binaries (+ encoder.npz for FFN) for chains; byte-equal files."""
    cfg = _cfg(name, 3, 4, 8)
    jmodel, jparams, tmodel, tparams = _both(cfg)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jms.save_phi_module(jmodel, jparams, jdir)
    tms.save_phi_module(tmodel, tparams, tdir)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    want = {"MFNFourier": ["params.npz"], "MFNGabor": ["params.npz"]}.get(name)
    if want:
        assert sorted(os.listdir(tdir)) == want
        with np.load(os.path.join(jdir, "params.npz")) as a, \
                np.load(os.path.join(tdir, "params.npz")) as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
        like = tmodel.init(torch.Generator().manual_seed(5), "cpu")
        back = tms.load_phi_module(tmodel, jdir, like)
        jback = jms.load_phi_module_npz(tdir, jparams)
        for (path, t), got, jgot in zip(
                _paths(tparams), jflat_by(tparams, back),
                jflat_by(tparams, jback)):
            np.testing.assert_array_equal(got, t.numpy(), err_msg=path)
            np.testing.assert_array_equal(jgot, t.numpy(), err_msg=path)
    else:
        assert ("encoder.npz" in os.listdir(tdir)) == (name == "FFN")
        for f in os.listdir(jdir):
            if f != "encoder.npz":
                assert open(os.path.join(jdir, f), "rb").read() == \
                    open(os.path.join(tdir, f), "rb").read()
        back = tms.load_phi_module(tmodel, jdir)
        for (path, t), got in zip(_paths(tparams), jflat_by(tparams, back)):
            np.testing.assert_array_equal(got, t.numpy(), err_msg=path)


def test_npz_loader_rejects_wrong_architecture(tmp_path):
    cfg = _cfg("MFNFourier", 3, 4, 8)
    model = tphi.init_phi(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tms.save_phi_module(model, params, str(tmp_path / "m"))
    deeper = tphi.init_phi({**cfg, "layers": 5}).init(
        torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="leaves"):
        tms.load_phi_module_npz(str(tmp_path / "m"), deeper)
    wider = tphi.init_phi({**cfg, "features": 9}).init(
        torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="shape"):
        tms.load_phi_module_npz(str(tmp_path / "m"), wider)
