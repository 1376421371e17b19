"""The port's optimisers and schedules (brief_pytorch_tpu_torch/train/
optim.py) against optax through the JAX package's make_optimizer.

50 steps on fixed per-step gradients (numpy, from a seed); params and
moments must agree to rtol 1e-5 / atol 1e-7: both run the same float32
update; the learning rate is a float64 product on the port's host and a
float32 one in optax, which may round one ulp apart.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from brief_pytorch_tpu.train import optim as jo
from brief_pytorch_tpu_torch.train import optim as to

SHAPES = [((3, 5), (5,)), ((5, 2), (2,))]


def _grads(rng, steps):
    return [[{"w": rng.normal(size=w).astype(np.float32) * 10 ** rng.uniform(-3, 1),
              "b": rng.normal(size=b).astype(np.float32)}
             for w, b in SHAPES] for _ in range(steps)]


def _params(rng):
    return [{"w": rng.normal(size=w).astype(np.float32),
             "b": rng.normal(size=b).astype(np.float32)} for w, b in SHAPES]


@pytest.mark.parametrize("name,sched", [
    ("Adamax", {"name": "MultiStepLR", "milestones": [20, 35], "gamma": 0.2}),
    ("Adam", {"name": "MultiStepLR", "milestones": [25], "gamma": 0.5}),
    ("Adamax", {"name": "none"}),
    ("SGD", {"name": "StepLR", "step_size": 10, "gamma": 0.5}),
    ("Adam", {"name": "CyclicLR", "base_lr": 1e-4, "max_lr": 1e-2,
              "step_size_up": 7, "step_size_down": 5}),
])
def test_trajectory_matches_optax(name, sched):
    rng = np.random.default_rng(0)
    p0 = _params(rng)
    grads = _grads(rng, 50)
    tx = jo.make_optimizer(name, 1e-2, sched)
    jp = {"layers": [{k: jnp.asarray(v) for k, v in l.items()} for l in p0]}
    js = tx.init(jp)
    opt = to.make_optimizer(name, 1e-2, sched)
    tp = {"layers": [{k: torch.tensor(v) for k, v in l.items()} for l in p0]}
    ts = opt.init(tp)
    for g in grads:
        jg = {"layers": [{k: jnp.asarray(v) for k, v in l.items()} for l in g]}
        upd, js = tx.update(jg, js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, {"layers": [{k: torch.tensor(v) for k, v in l.items()}
                                 for l in g]}, ts)
    for a, b in zip(tp["layers"], jp["layers"]):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       rtol=1e-5, atol=1e-7)
    if name != "SGD":
        inner = js[0]    # ScaleByAdamState(count, mu, nu)
        assert int(inner.count) == ts["count"] == 50
        # the port keeps moments layer by layer, w then b
        jmu = [l[k] for l in inner.mu["layers"] for k in ("w", "b")]
        jnu = [l[k] for l in inner.nu["layers"] for k in ("w", "b")]
        for a, b in zip(ts["mu"], jmu):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-8)
        for a, b in zip(ts["nu"], jnu):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-8)


@pytest.mark.parametrize("sched", [
    {"name": "MultiStepLR", "milestones": [50000, 60000, 70000], "gamma": 0.2},
    {"name": "MultiStepLR", "milestones": [3, 5], "gamma": 0.1},
    {"name": "StepLR", "step_size": 4, "gamma": 0.5},
    {"name": "CyclicLR", "base_lr": 0.001, "max_lr": 0.01, "step_size_up": 3},
])
def test_schedule_matches_jax(sched):
    js = jo.make_schedule(1e-3, sched)
    ts = to.make_schedule(1e-3, sched)
    steps = [0, 1, 2, 3, 4, 5, 6, 7, 8, 49999, 50000, 50001, 60000, 70001]
    for s in steps:
        np.testing.assert_allclose(ts(s), float(js(jnp.int32(s))), rtol=1e-6)


def test_multistep_reads_count_before_increment():
    """Step k uses schedule(k): the first step after milestone m is the
    (m+1)-th update."""
    opt = to.make_optimizer("SGD", 1.0, {"name": "MultiStepLR",
                                         "milestones": [2], "gamma": 0.1})
    p = {"layers": [{"w": torch.zeros(1), "b": torch.zeros(1)}]}
    g = {"layers": [{"w": torch.ones(1), "b": torch.ones(1)}]}
    st = opt.init(p)
    seen = []
    for _ in range(4):
        before = float(p["layers"][0]["w"])
        opt.step(p, g, st)
        seen.append(before - float(p["layers"][0]["w"]))
    np.testing.assert_allclose(seen, [1.0, 1.0, 0.1, 0.1], rtol=1e-6)


def test_unknown_names_raise():
    with pytest.raises(NotImplementedError):
        to.make_optimizer("LBFGS", 1e-3)
    with pytest.raises(NotImplementedError):
        to.make_schedule(1e-3, {"name": "Cosine"})


@pytest.mark.parametrize("name", ["Adamax", "Adam"])
def test_stacked_leaves_match_vmapped_optax(name):
    """The block fleet's stacked (B, ...) parameters: one port optimizer
    over the stacks equals jax.vmap(tx.update) over the block axis, as
    block_trainer.run_block_segment uses it — 50 steps, rtol 1e-5."""
    B = 3
    rng = np.random.default_rng(1)
    sched = {"name": "MultiStepLR", "milestones": [20, 40], "gamma": 0.2}
    p0 = [{"w": rng.normal(size=(B,) + w).astype(np.float32),
           "b": rng.normal(size=(B,) + b).astype(np.float32)}
          for w, b in SHAPES]
    tx = jo.make_optimizer(name, 1e-2, sched)
    jp = [{k: jnp.asarray(v) for k, v in l.items()} for l in p0]
    js = jax.vmap(tx.init)(jp)
    opt = to.make_optimizer(name, 1e-2, sched)
    tp = {"layers": [{k: torch.tensor(v) for k, v in l.items()} for l in p0]}
    ts = opt.init(tp)
    update = jax.jit(jax.vmap(tx.update))
    for _ in range(50):
        g = [{k: (rng.normal(size=v.shape) * 10 ** rng.uniform(-3, 1))
              .astype(np.float32) for k, v in l.items()} for l in p0]
        upd, js = update([{k: jnp.asarray(v) for k, v in l.items()}
                          for l in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, {"layers": [{k: torch.tensor(v) for k, v in l.items()}
                                 for l in g]}, ts)
    for a, b in zip(tp["layers"], jp):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       rtol=1e-5, atol=1e-7)
