"""The port's entropy models (brief_pytorch_tpu_torch/nflr/entropy.py)
against the JAX package's (brief_pytorch_tpu/nflr/entropy.py), on the CPU.

The same numpy inputs through both: likelihoods, factorized_forward on
injected noise and quantile_loss within 1e-5 (relative and absolute), their
gradients within 1e-4; the gradients of jnp.maximum, jnp.round, jnp.sign
and jnp.clip at ties against the port's counterparts; factorized and
Gaussian integer tables exactly; escape coding round trips; factorized
streams written by either package decode in the other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brief_pytorch_tpu.nflr import entropy as jem
from brief_pytorch_tpu_torch.nflr import entropy as em
from brief_pytorch_tpu_torch.nflr.framework import (params_from_numpy,
                                                    value_and_grad)

FWD = 1e-5
GRAD = 1e-4


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _params(channels=3, seed=0, perturb=True):
    """JAX-initialised factorized parameters (numpy), moved off their init
    so that factors and quantiles are not at their constants."""
    p = jem.factorized_init(jax.random.PRNGKey(seed), channels)
    p = jax.tree_util.tree_map(np.asarray, p)
    if perturb:
        rng = np.random.default_rng(seed)
        p = jax.tree_util.tree_map(
            lambda a: (a + rng.normal(0, 0.2, a.shape)).astype(np.float32), p)
    return p


def _close(a, b, tol):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a.detach()), b, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(b).max())))


def test_factorized_likelihood_and_grads():
    p = _params()
    x = np.random.default_rng(1).normal(0, 4, (3, 1, 200)).astype(np.float32)
    jl = jem.factorized_likelihood(p, jnp.asarray(x))
    pp = params_from_numpy(p)
    _close(em.factorized_likelihood(pp, t(x)), jl, FWD)
    jf = lambda q, xx: jnp.log(jem.factorized_likelihood(q, xx)).sum()
    jgp, jgx = jax.grad(jf, argnums=(0, 1))(p, jnp.asarray(x))
    _, g = value_and_grad(lambda tr: torch.log(em.factorized_likelihood(
        tr["p"], tr["x"])).sum(), {"p": pp, "x": t(x)})
    _close(g["x"], jgx, GRAD)
    for key in ("matrices", "biases", "factors"):
        for a, b in zip(g["p"][key], jgp[key]):
            _close(a, b, GRAD)


def test_stop_gradient_in_logits_cumulative():
    """stop_gradient=True: no gradient reaches matrices, biases, factors."""
    pp = params_from_numpy(_params())
    _, g = value_and_grad(lambda tr: em._logits_cumulative(
        tr, tr["quantiles"], True).sum(), pp)
    for key in ("matrices", "biases", "factors"):
        assert all(float(a.abs().max()) == 0 for a in g[key])
    assert float(g["quantiles"].abs().max()) > 0


def test_factorized_forward_injected_noise():
    p = _params(4, 2)
    y = np.random.default_rng(3).normal(0, 3, (2, 4, 3, 3, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(9)
    jt, jl = jem.factorized_forward(p, jnp.asarray(y), key, training=True)
    noise = jax.random.uniform(key, y.shape, jnp.float32, -0.5, 0.5)
    pt, pl = em.factorized_forward(params_from_numpy(p), t(y),
                                   noise=t(noise))
    _close(pt, jt, FWD)
    _close(pl, jl, FWD)
    # eval mode: round(x - median) + median
    jt, jl = jem.factorized_forward(p, jnp.asarray(y), None, training=False)
    pt, pl = em.factorized_forward(params_from_numpy(p), t(y),
                                   training=False)
    _close(pt, jt, FWD)
    _close(pl, jl, FWD)
    # the grad through the noisy forward
    jg = jax.grad(lambda yy: jnp.log(jem.factorized_forward(
        p, yy, key)[1]).sum())(jnp.asarray(y))
    _, g = value_and_grad(lambda tr: torch.log(em.factorized_forward(
        params_from_numpy(p), tr["y"], noise=t(noise))[1]).sum(),
        {"y": t(y)})
    _close(g["y"], jg, GRAD)


def test_quantile_loss_and_grad():
    p = _params(3, 4)
    jl, jg = jax.value_and_grad(lambda q: jem.quantile_loss(
        {**p, "quantiles": q}))(jnp.asarray(p["quantiles"]))
    pp = params_from_numpy(p)
    pl, g = value_and_grad(lambda tr: em.quantile_loss({**pp, **tr}),
                           {"quantiles": pp["quantiles"]})
    _close(pl, jl, FWD)
    _close(g["quantiles"], jg, GRAD)


def test_gaussian_likelihood_and_grads():
    """In the conditioned range (|y - mean| <= 3 scales): 0.5 * (1 +
    erf(.)) differences lose float32 precision further out, in both
    packages."""
    rng = np.random.default_rng(5)
    scales = np.exp(rng.uniform(-2, 2, (2, 3, 4, 4, 4))).astype(np.float32)
    means = rng.normal(0, 2, scales.shape).astype(np.float32)
    y = (means + scales * rng.uniform(-3, 3, scales.shape)).astype(
        np.float32)
    jl = jem.gaussian_likelihood(jnp.asarray(y), jnp.asarray(scales),
                                 jnp.asarray(means), 0.11)
    _close(em.gaussian_likelihood(t(y), t(scales), t(means), 0.11), jl, FWD)
    jf = lambda a, s, m: jnp.log(jem.gaussian_likelihood(a, s, m)).sum()
    jg = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(y), jnp.asarray(scales),
                                         jnp.asarray(means))
    _, g = value_and_grad(lambda tr: torch.log(em.gaussian_likelihood(
        tr["y"], tr["s"], tr["m"])).sum(),
        {"y": t(y), "s": t(scales), "m": t(means)})
    for k, b in zip("ysm", jg):
        _close(g[k], b, GRAD)


@pytest.mark.parametrize("op", ["maximum", "clip", "round", "sign"])
def test_gradients_at_ties(op):
    """The jnp ops' gradients where their inputs tie (maximum/clip at the
    floor: half; round, sign: zero) against the port's."""
    x = np.asarray([1e-9, 0.11, -1.0, 0.5, 1.5, 2.5, 0.0, 3.0], np.float32)
    if op == "maximum":
        jf = lambda v: (jnp.maximum(v, 1e-9) * 3.0).sum()
        pf = lambda v: (em.maximum(v, 1e-9) * 3.0).sum()
    elif op == "clip":
        jf = lambda v: (jnp.clip(v, -1.0, 2.5) * 3.0).sum()
        pf = lambda v: (em.clip(v, -1.0, 2.5) * 3.0).sum()
    elif op == "round":
        jf = lambda v: (jnp.round(v) * v).sum()
        pf = lambda v: (torch.round(v) * v).sum()
    else:
        jf = lambda v: (jnp.sign(v) * v).sum()
        pf = lambda v: (torch.sign(v) * v).sum()
    jv, jg = jax.value_and_grad(jf)(jnp.asarray(x))
    pv, g = value_and_grad(lambda tr: pf(tr["x"]), {"x": t(x)})
    np.testing.assert_allclose(float(pv), float(jv), rtol=FWD)
    np.testing.assert_array_equal(g["x"].numpy(), np.asarray(jg))


@pytest.mark.parametrize("seed", [0, 1])
def test_factorized_tables_equal_jax(seed):
    p = _params(4, seed)
    jt = jem.factorized_build_tables(p)
    pt = em.factorized_build_tables(params_from_numpy(p))
    np.testing.assert_array_equal(pt["offsets"], jt["offsets"])
    np.testing.assert_array_equal(pt["medians"], jt["medians"])
    assert len(pt["cdfs"]) == len(jt["cdfs"])
    for a, b in zip(pt["cdfs"], jt["cdfs"]):
        np.testing.assert_array_equal(a, b)


def test_gaussian_tables_and_indexes_equal_jax():
    jt = jem.GaussianTables.build()
    pt = em.GaussianTables.build()
    np.testing.assert_array_equal(pt.offsets, jt.offsets)
    np.testing.assert_array_equal(pt.scale_table, jt.scale_table)
    for a, b in zip(pt.cdfs, jt.cdfs):
        np.testing.assert_array_equal(a, b)
    scales = np.exp(np.random.default_rng(2).uniform(-4, 6, 500))
    np.testing.assert_array_equal(
        em.build_indexes(scales, pt.scale_table),
        jem.build_indexes(scales, jt.scale_table))


def test_factorized_streams_cross_the_packages():
    """A JAX-encoded factorized stream decodes in the port, and a
    port-encoded one in the JAX package, to the same latents; the bytes
    are the same."""
    p = _params(3, 6)
    y = np.random.default_rng(7).normal(0, 3, (2, 3, 3, 3, 3)).astype(
        np.float32)
    y[0, 1, 0, 0, 0] = 400.0          # an escaped symbol
    jt = jem.factorized_build_tables(p)
    pp = params_from_numpy(p)
    pt = em.factorized_build_tables(pp)
    js = jem.factorized_compress(p, jt, y)
    ps = em.factorized_compress(pp, pt, y)
    assert js == ps
    back_p = em.factorized_decompress(pp, pt, js, (3, 3, 3))
    back_j = jem.factorized_decompress(p, jt, ps, (3, 3, 3))
    np.testing.assert_array_equal(back_p, back_j)
    med = pt["medians"].reshape(1, 3, 1, 1, 1)
    np.testing.assert_array_equal(back_p, np.round(y - med) + med)


def test_gaussian_streams_cross_the_packages():
    tables = em.GaussianTables.build()
    rng = np.random.default_rng(1)
    scales = np.abs(rng.normal(1, 0.5, (2, 4, 2, 2, 2))) + 0.2
    means = rng.normal(0, 2, scales.shape)
    idx = em.build_indexes(scales, tables.scale_table)
    y = (means + scales * rng.normal(0, 1, scales.shape)).astype(np.float32)
    y[0, 0, 0, 0, 0] = 1e5            # beyond any table tail
    ps = em.gaussian_compress(tables, y, idx, means)
    js = jem.gaussian_compress(jem.GaussianTables.build(), y, idx, means)
    assert ps == js
    back = em.gaussian_decompress(tables, js, idx, means)
    np.testing.assert_array_equal(
        back, np.round(y - means).astype(np.float32)
        + means.astype(np.float32))


def test_escape_coding_round_trips():
    """Out-of-table symbols go through the bypass (tests/test_nflr.py
    TestEscapeCoding), and an escaped value past int32 raises."""
    pp = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jem.factorized_init(jax.random.PRNGKey(0), 3)))
    tables = em.factorized_build_tables(pp)
    rng = np.random.default_rng(0)
    y = rng.normal(0, 2, (2, 3, 3, 3, 3)).astype(np.float32)
    y[0, 1, 0, 0, 0] = 500.0
    y[1, 2, 1, 1, 1] = -500.0
    back = em.factorized_decompress(pp, tables, em.factorized_compress(
        pp, tables, y), (3, 3, 3))
    med = tables["medians"].reshape(1, 3, 1, 1, 1)
    np.testing.assert_array_equal(back, np.round(y - med) + med)
    cdf = em.rans.quantize_pmf(np.asarray([0.5, 0.3, 0.2]))
    with pytest.raises(OverflowError, match="int32"):
        em._encode_with_escape(np.asarray([0, 2 ** 32], np.int64),
                               np.asarray([1, 1]), [cdf, cdf],
                               np.asarray([0, 1]))
    blob = em._encode_with_escape(np.asarray([0, 7], np.int64),
                                  np.asarray([1, 1]), [cdf, cdf],
                                  np.asarray([0, 1]))
    with pytest.raises(ValueError, match="corrupt"):
        em._decode_with_escape(blob[:-4], np.asarray([1, 1]), [cdf, cdf],
                               np.asarray([0, 1]))
