"""Port of models/phi.py and models/sizing.py against the JAX package.

The same numpy weights go into both packages (params_from_numpy); the
SIREN forward and its gradients agree to float32 rounding (atol 1e-5,
rtol 1e-4: both use the fast sine with a cos-residual gradient, the
matmuls sum in different orders).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from brief_pytorch_tpu.core import config as jcfg
from brief_pytorch_tpu.models import sizing as js
from brief_pytorch_tpu.models.phi import init_phi as jinit
from brief_pytorch_tpu_torch.models import phi as tphi
from brief_pytorch_tpu_torch.models import sizing as ts


def _cfg(**kw):
    cfg = {"name": "SIREN", "coords_channel": 3, "data_channel": 1,
           "features": 16, "layers": 4, "w0": 20}
    cfg.update(kw)
    return cfg


def _jax_params(cfg, seed=0):
    model = jinit(cfg)
    params = model.init(jax.random.PRNGKey(seed))
    return model, params, [{k: np.asarray(v) for k, v in l.items()}
                           for l in params["layers"]]


@pytest.mark.parametrize("cfg", [
    _cfg(), _cfg(output_act=True), _cfg(layers=3, data_channel=2),
    _cfg(name="SIRENPos", T=[2.0, 3.0, 2.0]),
    _cfg(coords_channel=2, features=8, layers=5),
])
def test_forward_and_grads_match_jax(cfg):
    jmodel, jparams, layers = _jax_params(cfg)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (257, cfg["coords_channel"])).astype(np.float32)
    y = rng.uniform(0, 1, (257, cfg["data_channel"])).astype(np.float32)

    def jloss(p):
        return jnp.mean((jmodel.apply(p, jnp.asarray(x)) - y) ** 2)

    jl, jg = jax.value_and_grad(jloss)(jparams)
    tmodel = tphi.init_phi(cfg)
    tparams = tphi.params_from_numpy(layers)
    for layer in tparams["layers"]:
        for t in layer.values():
            t.requires_grad_(True)
    pred = tmodel.apply(tparams, torch.from_numpy(x))
    np.testing.assert_allclose(
        pred.detach().numpy(), np.asarray(jmodel.apply(jparams, x)),
        atol=1e-5, rtol=1e-4)
    tl = torch.mean((pred - torch.from_numpy(y)) ** 2)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for l, (a, b) in enumerate(zip(tparams["layers"], jg["layers"])):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k].grad.numpy(), np.asarray(b[k]),
                                       atol=1e-5, rtol=1e-4,
                                       err_msg=f"{k}{l}")


def test_spec_matches_jax():
    for cfg in [_cfg(), _cfg(output_act=True),
                _cfg(name="SIRENPos", T=[2.0, 3.0, 2.0])]:
        j, t = jinit(cfg).spec, tphi.init_phi(cfg).spec
        assert [(e.kind, e.fan_in, e.fan_out, e.act, e.w0, e.w_init)
                for e in j.entries] == \
            [(e.kind, e.fan_in, e.fan_out, e.act, e.w0, e.w_init)
             for e in t.entries]
        assert (j.skip_entry, j.encoder, tuple(j.encoder_cfg)) == \
            (t.skip_entry, t.encoder, tuple(t.encoder_cfg))


def test_init_distribution_bounds_and_count():
    cfg = _cfg(features=32, layers=5)
    model = tphi.init_phi(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    assert tphi.get_param_count(params) == js.siren_param_count(**{
        k: v for k, v in cfg.items() if k != "name"})
    w0 = params["layers"][0]["w"]
    assert w0.shape == (3, 32) and float(w0.abs().max()) <= 1 / 3
    w1 = params["layers"][1]["w"]
    assert float(w1.abs().max()) <= np.sqrt(6 / 32) / 30
    again = model.init(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a[k], b[k]) for a, b in
               zip(params["layers"], again["layers"]) for k in ("w", "b"))


def test_params_numpy_round_trip():
    _, _, layers = _jax_params(_cfg())
    back = tphi.params_to_numpy(tphi.params_from_numpy(layers))
    assert list(back) == ["layers"]      # a bare list of layers is a chain
    for a, b in zip(layers, back["layers"]):
        for k in ("w", "b"):
            assert b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])


def test_unported_families_raise():
    """Every family of the JAX registry is ported (tests/test_torch_phi_zoo.py
    holds each against JAX); only a name outside it raises, as in JAX."""
    from brief_pytorch_tpu.models.phi import ALLPHI as JALLPHI
    assert list(tphi.ALLPHI) == list(JALLPHI)
    for name in ["NeRF", "FFN", "MFNGabor", "SIRENFT"]:
        assert tphi.init_phi({"name": name, "features": 8}).name == name
    assert tphi.init_phi(_cfg(res=True)).spec.entries[1].kind == "res"
    with pytest.raises(KeyError):
        tphi.init_phi({"name": "MLP", "features": 8})


def test_sizing_default_config_gives_f22():
    opt = jcfg.load("opt/SingleTask/default.yaml").CompressFramework
    fixture = "dataset/brain/64x64x64/brain-64_128-64_128-192_256.tif"
    import os
    ideal = os.path.getsize(fixture) / opt.Compress.param.filesize_ratio
    jf = js.estimate_module_size(ideal, dict(opt.Module.phi), False)
    tf = ts.estimate_module_size(ideal, dict(opt.Module.phi), False)
    assert tf == jf
    assert tf[0] == 22


@pytest.mark.parametrize("ideal", [1000.0, 6516.0, 40000.0, 1e6])
@pytest.mark.parametrize("layers", [3, 5, 8])
def test_sizing_matches_jax(ideal, layers):
    cfg = _cfg(layers=layers)
    assert ts.estimate_module_size(ideal, dict(cfg), False) == \
        js.estimate_module_size(ideal, dict(cfg), False)
