"""Plain version of the port's grid-decode kernel
(brief_pytorch_tpu_torch/ops/fused_decode.py) against the JAX package's
Pallas kernel in interpret mode (ops/pallas_decode.fused_decode_grid), as
tests/test_pallas_decode.py runs it on the CPU.

Both build the lead-axis coordinate as lo + i * step and the plane axes
from axis_linspace (the TPU kernel's formulas).  The port's axis_linspace
differs from jnp.linspace by a few float32 ulps (test_torch_coords.py), so
outputs are held to atol 1e-5; against the JAX slab path, whose affine
index_to_coords differs the same way, too.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from brief_pytorch_tpu.core.coords import index_to_coords
from brief_pytorch_tpu.models.phi import init_phi as jinit
from brief_pytorch_tpu.ops import pallas_decode as pd
from brief_pytorch_tpu.ops import pallas_siren as ps
from brief_pytorch_tpu_torch.models import phi as tphi
from brief_pytorch_tpu_torch.ops import fused_decode as fd
from brief_pytorch_tpu_torch.ops.chain import chain_layer_specs


def _model(features=16, layers=4, cin=3, cout=1, **extra):
    cfg = {"name": "SIREN", "coords_channel": cin, "data_channel": cout,
           "features": features, "layers": layers, "w0": 20, **extra}
    model = jinit(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return cfg, model, params, [{k: np.asarray(v) for k, v in l.items()}
                                for l in params["layers"]]


@pytest.mark.parametrize("spatial,cin,cout,mode", [
    ((5, 6, 7), 3, 1, "n11"),
    ((4, 9), 2, 3, "n11"),
    ((3, 2, 150), 3, 1, "-1,1"),
    ((4, 5, 5), 3, 1, "0,1"),
    ((1, 6, 7), 3, 1, "n11"),
])
def test_matches_pallas_interpret(spatial, cin, cout, mode):
    cfg, model, params, layers_np = _model(cin=cin, cout=cout)
    acts = ps.chain_layer_specs(model.spec)
    ref = np.asarray(pd.fused_decode_grid(params["layers"], spatial, acts,
                                          mode, tile=128, interpret=True))
    out = fd.fused_decode_grid(tphi.params_from_numpy(layers_np)["layers"],
                               spatial, acts, mode)
    assert out.shape == ref.shape == (int(np.prod(spatial)), cout)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_sirenpos_matches_pallas_interpret():
    cfg, model, params, layers_np = _model(name="SIRENPos", T=[2.0, 3.0, 2.0])
    spatial = (5, 4, 6)
    ref = np.asarray(pd.decode_volume(model, params, spatial, "n11",
                                      tile=128, interpret=True))
    tmodel = tphi.init_phi(cfg)
    out = fd.decode_volume(tmodel, tphi.params_from_numpy(layers_np),
                           spatial, "n11")
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_slabs_agree_with_one_pass():
    """Slabs change only the matmuls' batch, so the float32 sums may
    round differently: atol 1e-6."""
    cfg, model, params, layers_np = _model()
    layers = tphi.params_from_numpy(layers_np)["layers"]
    acts = chain_layer_specs(tphi.init_phi(cfg).spec)
    whole = fd.fused_decode_grid(layers, (6, 7, 8), acts, "n11")
    for slab in (1, 100, 129, 10000):
        np.testing.assert_allclose(
            fd.fused_decode_grid(layers, (6, 7, 8), acts, "n11",
                                 slab=slab).numpy(), whole.numpy(),
            rtol=0, atol=1e-6)


def test_close_to_jax_slab_path():
    """The JAX CPU decode uses the affine index_to_coords on every axis."""
    cfg, model, params, layers_np = _model()
    spatial = (7, 9, 11)
    pop = int(np.prod(spatial))
    ref = np.asarray(model.apply(params, index_to_coords(
        jnp.arange(pop), spatial, "-1,1")))
    out = fd.fused_decode_grid(tphi.params_from_numpy(layers_np)["layers"],
                               spatial, ps.chain_layer_specs(model.spec),
                               "-1,1")
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_supports_gating():
    cfg, *_ = _model(features=22, layers=5)
    model = tphi.init_phi(cfg)
    assert fd.supports(model, (64, 64, 64))
    assert fd.supports(model, (64, 64))
    assert not fd.supports(model, (64,))
    # any grid of 2 or more axes, as the JAX gate (pallas_decode.py:231);
    # past 4 axes it takes the wide form
    assert fd.supports(model, (2, 2, 2, 2, 2))
    assert fd.choose_plan([3, 22, 22, 22, 22, 1])["layout"] == "narrow"
    # 512-wide weights (3 MB) take the wide form; past the JAX kernel's
    # 32 MB of weights (5 x 1,700: 34.7 MB), the slab path
    wide = tphi.init_phi({**cfg, "features": 512})
    assert fd.supports(wide, (4, 4, 4))
    assert fd.choose_plan([3, 512, 512, 512, 512, 1])["layout"] == "wide"
    huge = tphi.init_phi({**cfg, "features": 1700})
    assert not fd.supports(huge, (4, 4, 4))


def test_cpu_weights_never_reach_the_kernel():
    cfg, model, params, layers_np = _model()
    before = fd.launches
    fd.fused_decode_grid(tphi.params_from_numpy(layers_np)["layers"],
                         (4, 4, 4), ps.chain_layer_specs(model.spec))
    assert fd.launches == before
