"""The port's NFLR frameworks (brief_pytorch_tpu_torch/nflr/framework.py)
against the JAX package's, step for step, on the CPU.

For each of the six ALLCF frameworks: the JAX framework is built, its
weights go into the port's (params_from_numpy), and both take one
training_step on the same batch with the same draws (the JAX package's
PRNG draws, replayed here from its key walk and handed to the port as
tensors), then one compress step (SGA for the coding variants, the
distortion argmin for the others): loss within 1e-5 relative, updated
parameters and latents within 1e-5.  The rate-distortion losses'
gradients are compared directly at 1e-4.

One exception, measured here rather than hidden: the hyperprior's Gaussian
rate term is 0.5 * (1 + erf(.)) differences in float32 (the JAX package's
formula), which loses its precision in the tails.  From the reference's
gain-10000 latent init every |y - mean| / scale lies there, and the
gradient reaching gy (the hyper-synthesis convs) is 17-52% away from a
float64 evaluation in both packages.  The Hyper auto-decoder's step is
therefore held to 1e-5 on every leaf but gy's, and gy's gradient to the
JAX package's own distance from float64
(test_hyper_init_gy_gradient_is_float32_noise).  The SGA step of the
hyperprior variants starts from latents distributed as the hyperprior
predicts them (a trained model's regime), where the term is well
conditioned.

Sizes: SIREN 4 x 16, y_channel 8, ps 8, ol 2 on one 16^3 volume (a 3^3
patch grid), 128 coordinates a patch, 2 inner argmin steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_nflr_common import (NAMES, assert_tree_close, opt_yaml,
                               port_opt, t, write_volumes)

LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    """(paths, JAX batch, port batch) of one 16^3 volume: cropped, the
    first sampler batch, pc_shape, sideinfos."""
    from brief_pytorch_tpu.core import config as jcfg
    from brief_pytorch_tpu.nflr.crop import CropDataset as JDS
    paths = write_volumes(tmp_path_factory.mktemp("nflr_fw"), 1)
    opt = jcfg.loads(opt_yaml("NFLR_AutoDecoder"))
    ds = JDS(1, 128, opt.Normalize, None, opt.Module.crop, False, True,
             data_path_list=paths, seed=0)
    cropped, sampler, pc, side = next(iter(ds))
    coords, values = next(iter(sampler))
    jb = (cropped, pc, side, coords, values)
    pb = (t(cropped), pc, side, t(coords), t(values))
    return paths, jb, pb


def _pair(name):
    from brief_pytorch_tpu.core import config as jcfg
    from brief_pytorch_tpu.nflr import framework as jf
    from brief_pytorch_tpu_torch.nflr import framework as pf
    jfw = jf.init_compressframework(jcfg.loads(opt_yaml(name)))
    pfw = pf.init_compressframework(port_opt(name), device="cpu")
    pfw._load_state_dict(jfw._state_dict())
    return jfw, pfw


def _split(key):
    """The JAX framework's _next_key: (new walk key, drawn key)."""
    return tuple(jax.random.split(key))


def _jax_train_draws(jfw, name, y_shape, z_shape, argmin):
    """The draws jfw.training_step makes from its key walk, as tensors in
    the port's draw layout."""
    key = jfw._key
    u = lambda k, s: t(jax.random.uniform(k, s, jnp.float32, -0.5, 0.5))
    nrm = lambda k, s: t(jax.random.normal(k, s, jnp.float32))
    if name == "NFLR_AutoDecoder":
        key, k = _split(key)
        return {"y0": nrm(k, y_shape)}
    if name == "NFLR_AutoEncoder":
        return {}
    if name == "NFLR_Coding_AutoDecoder":
        key, k1 = _split(key)
        key, k2 = _split(key)
        keys = jax.random.split(k2, argmin + 1)
        return {"y0": nrm(k1, y_shape),
                "noise": [u(k, y_shape) for k in keys]}
    if name == "NFLR_Coding_AutoEncoder":
        key, k = _split(key)
        return {"noise": u(k, y_shape)}

    def un(k):
        kz, ky = jax.random.split(k)
        return (u(kz, z_shape), u(ky, y_shape))
    if name == "NFLR_Coding_Hyper_AutoDecoder":
        key, k1 = _split(key)
        key, k2 = _split(key)
        key, k3 = _split(key)
        return {"y0": nrm(k1, y_shape), "z0": nrm(k2, z_shape),
                "noise": [un(k) for k in jax.random.split(k3, argmin + 1)]}
    key, k = _split(key)
    return {"noise": un(k)}


@pytest.mark.parametrize("name", NAMES)
def test_training_step_matches_jax(name, batch):
    from brief_pytorch_tpu.train.optim import make_optimizer as jopt
    from brief_pytorch_tpu_torch.train.optim import make_optimizer as popt
    _, jb, pb = batch
    jfw, pfw = _pair(name)
    pc = tuple(jb[1])
    y_shape = (1, 8) + pc
    z_shape = (1, 4) + pc
    draws = _jax_train_draws(jfw, name, y_shape, z_shape, 2)
    jtx, ptx = jopt("Adam", 1e-4), popt("Adam", 1e-4)
    jst = jtx.init(jfw._train_params())
    pst = ptx.init(pfw._train_params())
    jloss, _ = jfw.training_step(*jb, jtx, jst)
    ploss, _ = pfw.training_step(*pb, ptx, pst, draws=draws)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=LOSS_RTOL)
    ill = {"gy"} if name == "NFLR_Coding_Hyper_AutoDecoder" else set()
    for key in pfw.params:
        if key not in ill:
            assert_tree_close(pfw.params[key], jfw.params[key], PARAM_TOL,
                              PARAM_TOL, f"{name} {key} after one step")


@pytest.mark.parametrize("name", NAMES)
def test_compress_step_matches_jax(name, batch):
    """One step of compressing_data's loop: SGA (coding) or the distortion
    argmin, from the same latents, with the same Gumbel draws."""
    from brief_pytorch_tpu.nflr import framework as jf
    _, jb, pb = batch
    jfw, pfw = _pair(name)
    cropped, pc, side, coords, values = jb
    rng = np.random.default_rng(3)
    y = (rng.normal(0, 3, (1, 8) + tuple(pc))).astype(np.float32)
    z = (rng.normal(0, 1, (1, 4) + tuple(pc))).astype(np.float32)
    if "Hyper" in name:
        # y ~ N(mean, scale) clipped to 2 scales, as gy(z) predicts it
        scales, means = pfw._scales_means(z)
        y = (means + scales * np.clip(rng.normal(0, 1, y.shape), -2, 2)
             ).astype(np.float32)
    c = jfw.opt.Compress
    tx_y = jfw._opt_tx(c.optimizer_name_y, c.lr_y)
    ptx_y = pfw._opt_tx(c.optimizer_name_y, c.lr_y)
    lat = {"y": t(y)}
    key = jax.random.PRNGKey(7)
    tau = jf.annealed_temperature(5, 0.001, 0.5, scheme="exp0", t0=700)
    if name in ("NFLR_AutoDecoder", "NFLR_AutoEncoder"):
        y1, _, jloss = jfw._y_step(tx_y, jnp.asarray(y), tx_y.init(y),
                                   jfw._module_params(), coords, values)
        ploss = pfw.y_step(lat, ptx_y.init(lat), ptx_y, pb[3], pb[4])
    elif "Hyper" not in name:
        y1, _, jloss = jf._sga_y_step(
            jfw._coding_params(), jnp.asarray(y), tx_y.init(y), key, coords,
            values, 100.0, tau, tx_y=tx_y, loss_fn=jfw._loss_rd_sga)
        g = t(jax.random.gumbel(key, y.shape + (2,), jnp.float32))
        ploss = pfw.sga_step(lat, ptx_y.init(lat), ptx_y, pb[3], pb[4], tau,
                             draws={"g": g})
    else:
        tx_z = jfw._opt_tx(c.optimizer_name_z, c.lr_z)
        ptx_z = pfw._opt_tx(c.optimizer_name_z, c.lr_z)
        y1, z1, _, _, jloss = jf._sga_yz_step(
            jfw._hyper_params(), jnp.asarray(y), jnp.asarray(z),
            tx_y.init(y), tx_z.init(z), key, coords, values, 100.0, tau,
            tx_y=tx_y, tx_z=tx_z, loss_fn=jfw._loss_rd_hyper_sga)
        kz, ky = jax.random.split(key)
        g = (t(jax.random.gumbel(kz, z.shape + (2,), jnp.float32)),
             t(jax.random.gumbel(ky, y.shape + (2,), jnp.float32)))
        # the gradients first: d loss / d (y, z) within 1e-4 of their max
        from brief_pytorch_tpu_torch.nflr.framework import value_and_grad
        _, (jgy, jgz) = jax.value_and_grad(
            lambda yy, zz: jfw._loss_rd_hyper_sga(
                jfw._hyper_params(), key, coords, values, yy, zz, 100.0,
                tau), argnums=(0, 1))(jnp.asarray(y), jnp.asarray(z))
        _, pgr = value_and_grad(
            lambda l: pfw._loss_rd_hyper_sga(
                pfw._hyper_params(), g, pb[3], pb[4], l["y"], l["z"], 100.0,
                tau), {"y": t(y), "z": t(z)})
        for a, b in ((pgr["y"], jgy), (pgr["z"], jgz)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=GRAD_TOL * np.abs(b).max())
        lat["z"] = t(z)
        ploss = pfw.sga_step(lat, (ptx_y.init({"y": lat["y"]}),
                                   ptx_z.init({"z": lat["z"]})),
                             (ptx_y, ptx_z), pb[3], pb[4], tau,
                             draws={"g": g})
        # Adam's first step is lr * g / (|g| + eps): where |g| is below
        # 1e-3 of the largest it scales gradient rounding up by
        # max|g| / |g|, so the step is compared where |g| is above that
        big = np.abs(np.asarray(jgz)) >= 1e-3 * np.abs(np.asarray(jgz)).max()
        np.testing.assert_allclose(lat["z"].numpy()[big],
                                   np.asarray(z1)[big],
                                   rtol=PARAM_TOL, atol=PARAM_TOL)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(lat["y"].numpy(), np.asarray(y1),
                               rtol=PARAM_TOL, atol=PARAM_TOL)


@pytest.mark.parametrize("name", ["NFLR_Coding_AutoEncoder",
                                  "NFLR_Coding_Hyper_AutoEncoder"])
def test_rd_loss_gradients_match_jax(name, batch):
    """d loss / d params of the uniform-noise RD loss, the whole training
    tree (SIREN, modulator, encoders, hyper-synthesis, entropy model)."""
    from brief_pytorch_tpu_torch.nflr.framework import value_and_grad
    _, jb, pb = batch
    jfw, pfw = _pair(name)
    cropped, pc, side, coords, values = jb
    pc = tuple(pc)
    key = jax.random.PRNGKey(11)
    if "Hyper" in name:
        jfn = lambda p: jfw._ae_hyper_loss(p, key, cropped, coords, values,
                                           100.0)
        kz, ky = jax.random.split(key)
        noise = (t(jax.random.uniform(kz, (1, 4) + pc, jnp.float32, -.5, .5)),
                 t(jax.random.uniform(ky, (1, 8) + pc, jnp.float32, -.5, .5)))
        pfn = lambda p: pfw._ae_hyper_loss(p, noise, pb[0], pb[3], pb[4],
                                           100.0)
    else:
        jfn = lambda p: jfw._ae_rd_loss(p, key, cropped, coords, values,
                                        100.0)
        noise = t(jax.random.uniform(key, (1, 8) + pc, jnp.float32, -.5, .5))
        pfn = lambda p: pfw._ae_rd_loss(p, noise, pb[0], pb[3], pb[4], 100.0)
    jloss, jg = jax.value_and_grad(jfn)(jfw._train_params())
    ploss, pg = value_and_grad(pfn, pfw._train_params())
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=LOSS_RTOL)
    # gradients relative to each leaf's largest entry
    from brief_pytorch_tpu_torch.core.tree import tree_leaves_sorted
    for i, (a, b) in enumerate(zip(tree_leaves_sorted(pg),
                                   jax.tree_util.tree_leaves(jg))):
        b = np.asarray(b)
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a.numpy(), b, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * scale,
                                   err_msg=f"{name} grad leaf {i}")


def test_hyper_init_gy_gradient_is_float32_noise(batch):
    """At the Hyper auto-decoder's first step (latents from the gain-10000
    init) the uniform-noise RD loss's gradient on gy is float32 noise in
    both packages: each is > 5% from a float64 evaluation (the port's code
    in double), and the port is no further from it than 1.25x the JAX
    package's distance.  Every other leaf agrees with JAX to 1e-5 of its
    largest entry."""
    from brief_pytorch_tpu_torch.core.tree import tree_leaves_sorted
    from brief_pytorch_tpu_torch.core.tree import tree_map
    from brief_pytorch_tpu_torch.nflr import framework as pf
    _, jb, pb = batch
    name = "NFLR_Coding_Hyper_AutoDecoder"
    jfw, pfw = _pair(name)
    pc = tuple(jb[1])
    draws = _jax_train_draws(jfw, name, (1, 8) + pc, (1, 4) + pc, 2)
    y0 = pf.init_y(None, 1, 8, pc, draws["y0"])
    z0 = pf.init_z(None, 1, 4, pc, draws["z0"])
    key = jax.random.PRNGKey(5)
    kz, ky = jax.random.split(key)
    nz = t(jax.random.uniform(kz, z0.shape, jnp.float32, -.5, .5))
    ny = t(jax.random.uniform(ky, y0.shape, jnp.float32, -.5, .5))
    jg = jax.grad(lambda p: jfw._loss_rd_hyper_un(
        p, key, jb[3], jb[4], jnp.asarray(y0.numpy()),
        jnp.asarray(z0.numpy()), 100.0))(jfw._hyper_params())
    _, pg = pf.value_and_grad(lambda p: pfw._loss_rd_hyper_un(
        p, (nz, ny), pb[3], pb[4], y0, z0, 100.0), pfw._hyper_params())
    _, pg64 = pf.value_and_grad(lambda p: pfw._loss_rd_hyper_un(
        p, (nz.double(), ny.double()), pb[3].double(), pb[4].double(),
        y0.double(), z0.double(), 100.0),
        tree_map(lambda x: x.double(), pfw._hyper_params()))
    for key in pg:
        for a, b, c in zip(tree_leaves_sorted(pg[key]),
                           jax.tree_util.tree_leaves(jg[key]),
                           tree_leaves_sorted(pg64[key])):
            a, b, c = a.numpy(), np.asarray(b), c.numpy()
            if key == "gy":
                scale = np.abs(c).max()
                port_err = np.abs(a - c).max() / scale
                jax_err = np.abs(b - c).max() / scale
                assert jax_err > 0.05 and port_err > 0.05
                assert port_err <= 1.25 * jax_err, (port_err, jax_err)
            else:
                assert np.abs(a - b).max() <= GRAD_TOL * np.abs(b).max() \
                    + 1e-12, (key, a.shape)
