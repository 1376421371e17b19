"""The port's batch-major fused chain forward (ops/fused_siren.py) against
the JAX package's Pallas kernel (ops/pallas_siren.py, run in interpret mode
with tile 256, as tests/test_pallas.py runs it) on the CPU.

The same numpy-seeded weights and coordinates go through both.  On the CPU
the port's wrapper takes its plain version (the CUDA kernel is held against
that on the card, tests/test_torch_cuda_kernels.py).  Tolerances: forward
atol 1e-4 (the bound tests/test_pallas.py holds the Pallas kernel to),
gradients 1e-5, SIRENPos through make_fused_apply 2e-5, the slab decode
against the JAX scan 1e-5.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from brief_pytorch_tpu.models.phi import init_phi as jinit
from brief_pytorch_tpu.ops import pallas_siren as ps
from brief_pytorch_tpu.train import decode as jdecode
from brief_pytorch_tpu_torch.models import phi as tphi
from brief_pytorch_tpu_torch.ops import chain_stream as cs
from brief_pytorch_tpu_torch.ops import fused_decode as fd
from brief_pytorch_tpu_torch.ops import fused_siren as fs
from brief_pytorch_tpu_torch.ops.chain import chain_layer_specs
from brief_pytorch_tpu_torch.train import decode as tdecode

pytestmark = pytest.mark.skipif(not ps._HAS_PALLAS, reason="no pallas")

KEYS = {"SIRENFT": {"ratio": 2.2}, "SIREN_Pyramid": {"features_dis": 3},
        "SIRENPS": {"ratio": 1.4}, "SIRENPos": {"T": [2.0, 3.0, 2.0]},
        "NeRF": {"frequencies": 4}, "FFN": {"embsize": 12}}
PLAIN = ["SIREN", "SIRENFT", "SIREN_Pyramid", "SIRENPS", "SIREN_RELU",
         "SIREN_SIGMOID", "SIRENPos"]


def _cfg(name="SIREN", **kw):
    return {"name": name, "coords_channel": 3, "data_channel": 1,
            "features": 32, "layers": 4, "w0": 20, **KEYS.get(name, {}), **kw}


def _pair(cfg, seed=0):
    jmodel = jinit(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tparams = tphi.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams))
    return jmodel, jparams, tphi.init_phi(cfg), tparams


def _coords(n, c=3, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (n, c)).astype(
        np.float32)


@pytest.mark.parametrize("name", [n for n in PLAIN if n != "SIRENPos"])
@pytest.mark.parametrize("n", [700, 130])
def test_forward_matches_pallas_interpret(name, n):
    """N = 130 is the padding tail: the Pallas kernel pads to its tile and
    slices back, the port's takes any N."""
    cfg = _cfg(name, features=16 if name != "SIREN" else 32)
    jmodel, jparams, tmodel, tparams = _pair(cfg)
    x = _coords(n)
    acts = ps.chain_layer_specs(jmodel.spec)
    assert chain_layer_specs(tmodel.spec) == acts
    want = np.asarray(ps.fused_chain_apply(jparams["layers"], jnp.asarray(x),
                                           acts, 256, True))
    before = fs.launches
    got = fs.fused_chain_apply(tparams["layers"], torch.from_numpy(x), acts)
    assert fs.launches == before       # no kernel launch on the CPU
    assert got.shape == want.shape == (n, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jmodel.apply(jparams, jnp.asarray(x))),
        atol=1e-4)


@pytest.mark.parametrize("name", ["SIREN", "SIREN_SIGMOID", "SIREN_Pyramid"])
def test_gradients_match_pallas_custom_vjp(name):
    """Gradients of (out ** 2).mean() for every w and b and for coords,
    against jax.grad through the Pallas kernel's custom VJP."""
    cfg = _cfg(name)
    jmodel, jparams, tmodel, tparams = _pair(cfg)
    x = _coords(256, seed=3)
    acts = ps.chain_layer_specs(jmodel.spec)

    def jloss(layers, coords):
        return (ps.fused_chain_apply(layers, coords, acts, 256, True)
                ** 2).mean()

    jgl, jgc = jax.grad(jloss, argnums=(0, 1))(jparams["layers"],
                                              jnp.asarray(x))
    coords = torch.from_numpy(x).requires_grad_(True)
    for layer in tparams["layers"]:
        for t in layer.values():
            t.requires_grad_(True)
    (fs.fused_chain_apply(tparams["layers"], coords, acts) ** 2).mean() \
        .backward()
    np.testing.assert_allclose(coords.grad.numpy(), np.asarray(jgc),
                               atol=1e-5)
    for l, (a, b) in enumerate(zip(tparams["layers"], jgl)):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k].grad.numpy(), np.asarray(b[k]),
                                       atol=1e-5, err_msg=f"{k}{l}")
    # and against autograd through the port's own model.apply
    leaves = [t for layer in tparams["layers"] for t in layer.values()]
    own = torch.autograd.grad(
        (tmodel.apply(tparams, coords) ** 2).mean(), leaves + [coords])
    for a, b in zip(own, [t.grad for t in leaves] + [coords.grad]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_backward_only_for_what_needs_it():
    _, _, tmodel, tparams = _pair(_cfg())
    acts = chain_layer_specs(tmodel.spec)
    w = tparams["layers"][1]["w"].requires_grad_(True)
    out = fs.fused_chain_apply(tparams["layers"], torch.from_numpy(_coords(8)),
                               acts)
    out.sum().backward()
    assert w.grad is not None and tparams["layers"][0]["w"].grad is None
    with torch.no_grad():
        assert not fs.fused_chain_apply(
            tparams["layers"], torch.from_numpy(_coords(8)),
            acts).requires_grad


def test_make_fused_apply_sirenpos_matches_both_models():
    cfg = _cfg("SIRENPos", features=16)
    jmodel, jparams, tmodel, tparams = _pair(cfg)
    x = _coords(300)
    want = np.asarray(ps.make_fused_apply(jmodel, interpret=True, tile=256)(
        jparams, jnp.asarray(x)))
    got = fs.make_fused_apply(tmodel)(tparams, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(
        got.numpy(), tmodel.apply(tparams, torch.from_numpy(x)).numpy(),
        atol=2e-5)


@pytest.mark.parametrize("name,extra,want", [(n, {}, True) for n in PLAIN] + [
    ("SIREN", {"res": True}, False), ("NeRF", {}, False), ("FFN", {}, False),
    ("MFNFourier", {}, False), ("MFNGabor", {}, False)])
def test_supports_is_the_jax_gate(name, extra, want):
    cfg = _cfg(name, **extra)
    assert fs.supports(tphi.init_phi(cfg)) is want
    assert ps.supports(jinit(cfg)) is want


def test_plans():
    """The kernel's forms are the decode kernel's: narrow chains keep the
    pre-split weights in shared memory, warp tiles of 16 or 32 rows in
    registers; wider ones stream them through the wide form's slab ring
    (3-186x4-1, its activations in shared memory), and past 256 features
    the streamed form (ops/chain_stream.py); the chains the train and
    decode kernels accept are accepted, and so are chains past 16 layers
    and 3,327 features."""
    from brief_pytorch_tpu_torch.ops import fused_train as ft
    p = fs.choose_plan([3, 22, 22, 22, 22, 1])
    assert (p["layout"], p["inst"], p["tile"]) == ("narrow", 3, 32)
    assert p["smem_bytes"] == 4 * p["packed_floats"] <= fd.SMEM_LIMIT
    p = fs.choose_plan([3] + [64] * 6 + [1])
    assert (p["layout"], p["inst"], p["warps_per_sm"]) == ("narrow", 9, 8)
    p = fs.choose_plan([3, 186, 186, 186, 186, 1])
    assert (p["layout"], p["inst"], p.get("stream")) == ("wide", 3, None)
    assert p["smem_bytes"] <= fd.SMEM_LIMIT and max(p["kb"]) == 24
    for widths in ([3, 217, 217, 217, 217, 1], [3] + [145] * 6 + [1],
                   [2, 8, 1], [3] + [40] * 15 + [1], [3, 2048, 2048, 1]):
        assert ft.choose_plan(widths) is not None
        p = fs.choose_plan(widths)
        if max(widths) > 256:
            assert p == cs.stream_plan(widths)
        else:
            assert p == fd.narrow_plan(widths) or p == fd.wide_plan(widths)
        assert p["smem_bytes"] <= fd.SMEM_LIMIT
    assert fs.choose_plan([3] + [8] * 17 + [1])["layout"] == "narrow"
    p = fs.choose_plan([3, 3328, 3328, 1])    # the streamed form
    assert (p["layout"], p["stream"]) == ("wide", True)
    assert fs.supports(tphi.init_phi(_cfg(features=3328)))


def test_fused_apply_or_returns_the_default_on_the_cpu():
    model = tphi.init_phi(_cfg())
    sentinel = lambda *a, **k: None
    assert tdecode.fused_apply_or(model, sentinel, device="cpu") is sentinel
    assert tdecode.fused_apply_or(model, sentinel, use_kernel=False,
                                  device="cpu") is sentinel
    assert jdecode.fused_apply_or(jinit(_cfg()), sentinel) is sentinel
    if not torch.cuda.is_available():    # no card: asking for it raises
        with pytest.raises(RuntimeError):
            tdecode.fused_apply_or(model, sentinel)


@pytest.mark.parametrize("shape,sample_size,mode", [
    ((9, 10, 11, 1), 300, "n11"), ((13, 7, 1), 10000, "0,1"),
    ((5, 6, 7, 1), 128, "-1,1")])
def test_reconstruct_flattened_apply_fn_matches_jax_scan(shape, sample_size,
                                                         mode):
    """With an apply_fn the slab loop runs it over index_to_coords slabs of
    sample_size voxels (rounded up to 128) and never takes the grid route;
    the result equals the JAX package's _decode_scan at 1e-5."""
    cfg = _cfg(coords_channel=len(shape) - 1, features=16)
    jmodel, jparams, tmodel, tparams = _pair(cfg)
    pop = int(np.prod(shape[:-1]))
    slab = max(128, -(-min(sample_size, pop) // 128) * 128)
    seen = []

    def apply_fn(params, coords):
        seen.append(tuple(coords.shape))
        return fs.make_fused_apply(tmodel)(params, coords)

    before = fd.launches
    got = tdecode.reconstruct_flattened(tmodel, tparams, shape, sample_size,
                                        mode, apply_fn=apply_fn)
    assert fd.launches == before
    assert len(seen) == -(-pop // slab)
    assert all(s == (slab, len(shape) - 1) for s in seen[:-1])
    assert sum(s[0] for s in seen) == pop
    want = np.asarray(jdecode._decode_scan(
        jparams, jmodel.apply, tuple(shape[:-1]), 1, slab, mode, None))
    assert got.shape == tuple(shape) and got.dtype == np.float32
    np.testing.assert_allclose(got.reshape(pop, 1), want, atol=1e-5)
    # the JAX entry point on the same route (no model: the scan)
    np.testing.assert_allclose(
        got, jdecode.reconstruct_flattened(jmodel.apply, jparams, shape,
                                           sample_size, mode), atol=1e-5)


def test_default_route_is_unchanged_without_apply_fn():
    """apply_fn=None keeps the grid route for a supported chain (its plain
    version on the CPU) and the model's own apply for the others."""
    cfg = _cfg(features=16)
    _, _, tmodel, tparams = _pair(cfg)
    grid = tdecode.reconstruct_flattened(tmodel, tparams, (6, 7, 8, 1), 200,
                                         "n11")
    want = fd.decode_volume(tmodel, tparams, (6, 7, 8), "n11").numpy()
    np.testing.assert_array_equal(grid.reshape(-1, 1), want)
    slab = tdecode.reconstruct_flattened(tmodel, tparams, (6, 7, 8, 1), 200,
                                         "n11", apply_fn=tmodel.apply)
    np.testing.assert_allclose(slab, grid, atol=2e-5)
    mcfg = _cfg("MFNFourier", features=8, input_scale=8.0)
    jm, jp, tm, tp = _pair(mcfg)
    got = tdecode.reconstruct_flattened(tm, tp, (6, 7, 8, 1), 200, "n11")
    np.testing.assert_allclose(
        got, jdecode.reconstruct_flattened(jm.apply, jp, (6, 7, 8, 1), 200,
                                           "n11"), atol=2e-5)


def test_wrapper_rejects_bad_inputs():
    _, _, tmodel, tparams = _pair(_cfg(features=16))
    acts = chain_layer_specs(tmodel.spec)
    x = torch.from_numpy(_coords(16))
    # the CPU route is the plain version; the checks guard the card's route
    for bad in (lambda: fs._check(tparams["layers"], x.T, acts),
                lambda: fs._check(tparams["layers"], x.double(), acts),
                lambda: fs._check(tparams["layers"], x, acts[:-1]),
                lambda: fs._check(tparams["layers"], x[0], acts)):
        with pytest.raises(ValueError):
            bad()
    assert fs._check(tparams["layers"], x, acts) == [3, 16, 16, 16, 1]
