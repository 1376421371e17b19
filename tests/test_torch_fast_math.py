"""Port of ops/fast_math.py (brief_pytorch_tpu_torch) against the JAX package.

Same constants and operation order: the two agree within 1e-6 (float32
rounding of a few Horner steps) over |x| <= 200.  The gradient of
fast_sin_cached is the cos of the shared reduction, as the JAX custom VJP.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from brief_pytorch_tpu.ops import fast_math as jf
from brief_pytorch_tpu_torch.ops import fast_math as tf


def _x(n=20001, lim=200.0, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([np.linspace(-lim, lim, n),
                           rng.uniform(-lim, lim, n)]).astype(np.float32)


def test_fast_sin_matches_jax():
    x = _x()
    ref = np.asarray(jf.fast_sin(jnp.asarray(x)))
    out = tf.fast_sin(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_fast_sincos_matches_jax():
    x = _x(seed=1)
    rs, rc = jf.fast_sincos(jnp.asarray(x))
    s, c = tf.fast_sincos(torch.from_numpy(x))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=0, atol=1e-6)
    np.testing.assert_allclose(c.numpy(), np.asarray(rc), rtol=0, atol=1e-6)


def test_accuracy_budget():
    """float32 error <= 2e-6 for |x| <= 40 and <= 8e-6 for |x| <= 200."""
    for lim, tol in [(40.0, 2e-6), (200.0, 8e-6)]:
        x = _x(lim=lim, seed=2)
        s, c = tf.fast_sincos(torch.from_numpy(x))
        x64 = x.astype(np.float64)
        assert np.abs(s.numpy() - np.sin(x64)).max() <= tol
        assert np.abs(c.numpy() - np.cos(x64)).max() <= tol


def test_float64_and_exact_env_fall_back(monkeypatch):
    x = torch.linspace(-50, 50, 101, dtype=torch.float64)
    assert torch.equal(tf.fast_sin(x), torch.sin(x))
    x32 = x.float()
    assert not torch.equal(tf.fast_sin(x32), torch.sin(x32))
    monkeypatch.setenv("BRIEF_TPU_EXACT_SINE", "1")
    assert torch.equal(tf.fast_sin(x32), torch.sin(x32))
    s, c = tf.fast_sincos(x32)
    assert torch.equal(s, torch.sin(x32)) and torch.equal(c, torch.cos(x32))


def test_fast_sin_cached_value_and_grad_match_jax():
    x = _x(n=501, lim=30.0, seed=3)
    g = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    val, vjp = jax.vjp(jf.fast_sin_cached, jnp.asarray(x))
    (ref_grad,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tf.fast_sin_cached(xt)
    (grad,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(val),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad),
                               rtol=0, atol=1e-5)
