"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked `gpu`: each test skips where torch.cuda.is_available() is
false (decided inside the fixture, never at import).  Run on a machine
with an NVIDIA Hopper card:

    python -m pytest tests/test_torch_cuda_kernels.py -m gpu

Tolerances: the kernels sum in another order than torch's matmuls and
contract multiply-adds into FMAs — loss rtol 1e-5, gradients
1e-4 * max|plain| + 1e-6, decoded values 1e-5 * max|plain| + 1e-5,
fast_sincos 4e-6 absolute over |x| <= 200.
"""
import numpy as np
import pytest
import torch

from brief_pytorch_tpu_torch.models import phi as tphi
from brief_pytorch_tpu_torch.ops import fused_decode as fd
from brief_pytorch_tpu_torch.ops import fused_train as ft
from brief_pytorch_tpu_torch.ops.chain import chain_layer_specs
from brief_pytorch_tpu_torch.ops.fast_math import (fast_sincos,
                                                   fast_sincos_device)

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _chain(dev, features, layers, cin=3, cout=1, seed=0, **extra):
    cfg = {"name": "SIREN", "coords_channel": cin, "data_channel": cout,
           "features": features, "layers": layers, "w0": 20, **extra}
    model = tphi.init_phi(cfg)
    params = model.init(torch.Generator().manual_seed(seed), dev)
    return model, params


def _batch(dev, n, cin=3, cout=1, seed=1):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    return (f(rng.uniform(-1, 1, (cin, n))), f(rng.uniform(0, 1, (cout, n))),
            f(rng.uniform(1, 2, (cout, n))))


def test_fast_sincos_device(dev):
    x = torch.linspace(-200, 200, 1 << 20, device=dev)
    s, c = fast_sincos_device(x)
    rs, rc = fast_sincos(x)
    assert float((s - rs).abs().max()) <= 4e-6
    assert float((c - rc).abs().max()) <= 4e-6


@pytest.mark.parametrize("features,layers,n,loss_name,thres", [
    (22, 5, 262144, "datal2", 0.5),
    (22, 5, 1000, "datasmoothl1", None),
    (16, 3, 300, "datal2", None),
    (64, 4, 4099, "datasmoothl1", 0.3),
])
def test_fused_train_matches_plain(dev, features, layers, n, loss_name,
                                   thres):
    model, params = _chain(dev, features, layers)
    acts = chain_layer_specs(model.spec)
    coords, values, weights = _batch(dev, n)
    kw = dict(loss_name=loss_name, beta=0.01, weight_thres=thres)
    before = ft.launches
    lk, gk = ft.fused_train_grads(params["layers"], coords, values, weights,
                                  acts, **kw)
    assert ft.launches == before + 1
    lp, gp = ft.fused_train_grads_reference(params["layers"], coords, values,
                                            weights, acts, **kw)
    torch.cuda.synchronize()
    assert abs(float(lk) - float(lp)) <= 1e-5 * abs(float(lp))
    for a, b in zip(gk["layers"], gp["layers"]):
        for k in ("w", "b"):
            assert a[k].shape == b[k].shape
            d = float((a[k] - b[k]).abs().max())
            assert d <= 1e-4 * float(b[k].abs().max()) + 1e-6


@pytest.mark.parametrize("acts", [
    (("sine", 20.0), ("relu", 1.0), ("none", 1.0)),
    (("sigmoid", 1.0), ("sine", 30.0), ("sigmoid", 1.0)),
])
def test_fused_train_other_activations(dev, acts):
    model, params = _chain(dev, 24, 3, cout=2)
    coords, values, weights = _batch(dev, 5000, cout=2)
    kw = dict(loss_name="datasmoothl1", beta=0.05, weight_thres=0.4)
    lk, gk = ft.fused_train_grads(params["layers"], coords, values, weights,
                                  acts, **kw)
    lp, gp = ft.fused_train_grads_reference(params["layers"], coords, values,
                                            weights, acts, **kw)
    assert abs(float(lk) - float(lp)) <= 1e-5 * abs(float(lp))
    for a, b in zip(gk["layers"], gp["layers"]):
        for k in ("w", "b"):
            d = float((a[k] - b[k]).abs().max())
            assert d <= 1e-4 * float(b[k].abs().max()) + 1e-6


def test_fused_train_is_deterministic(dev):
    model, params = _chain(dev, 22, 5)
    acts = chain_layer_specs(model.spec)
    coords, values, weights = _batch(dev, 100000)
    runs = [ft.fused_train_grads(params["layers"], coords, values, weights,
                                 acts, loss_name="datal2") for _ in range(3)]
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for a, b in zip(grads["layers"], runs[0][1]["layers"]):
            assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])


@pytest.mark.parametrize("spatial,features,cout,mode", [
    ((64, 64, 64), 22, 1, "-1,1"),
    ((5, 6, 7), 16, 1, "n11"),
    ((37, 41), 22, 3, "0,1"),
    ((1, 6, 7), 8, 1, "n11"),
    ((4, 4, 8, 16, 32), 22, 1, "n11"),     # 5 axes: past the old 4
    ((2, 3, 2, 3, 2, 3, 2, 3, 4), 16, 2, "-1,1"),   # 9 axes: 2 k-blocks
])
def test_fused_decode_matches_plain(dev, spatial, features, cout, mode):
    model, params = _chain(dev, features, 5, cin=len(spatial), cout=cout)
    acts = chain_layer_specs(model.spec)
    before = fd.launches
    out = fd.fused_decode_grid(params["layers"], spatial, acts, mode)
    assert fd.launches == before + 1
    ref = fd.fused_decode_grid_reference(params["layers"], spatial, acts, mode)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (int(np.prod(spatial)), cout)
    assert float((out - ref).abs().max()) <= \
        1e-5 * float(ref.abs().max()) + 1e-5


@pytest.mark.parametrize("widths,layout", [
    ([3] + [8] * 19 + [1], "narrow"),       # 20 layers
    ([3] + [9] * 19 + [1], "tiled"),        # 64^3 fixture, layers 20, 80x
    ([3] + [76] * 19 + [1], "wide"),        # demo volume, layers 20, 80x
    ([3, 4096, 1], "stream"),               # past 3,327 features
    ([3, 3400, 3400, 1], "stream"),
])
def test_reach_matches_plain(dev, widths, layout):
    """Chains past the kernels' old reach (16 layers, 3,327 features): the
    train kernel in the layout its plan names, the grid decode (weights
    within 32 MB) and the batch-major forward, each against its plain
    version."""
    layers_ = []
    g = torch.Generator().manual_seed(len(widths))
    for fin, fout in zip(widths[:-1], widths[1:]):
        bound = (6 / fin) ** 0.5 / 10
        layers_.append({
            "w": ((torch.rand(fin, fout, generator=g) * 2 - 1) * bound).to(dev),
            "b": ((torch.rand(fout, generator=g) * 2 - 1) * bound).to(dev)})
    acts = (("sine", 10.0),) * (len(widths) - 2) + (("none", 1.0),)
    p = ft.choose_plan(widths)
    assert ("stream" if p.get("stream") else p["layout"]) == layout
    coords, values, weights = _batch(dev, 3000)
    kw = dict(loss_name="datal2", beta=0.01, weight_thres=0.5)
    lk, gk = ft.fused_train_grads(layers_, coords, values, weights, acts, **kw)
    lp, gp = ft.fused_train_grads_reference(layers_, coords, values, weights,
                                            acts, **kw)
    _close(lk, gk["layers"], lp, gp["layers"])
    if sum(4 * a * b for a, b in zip(widths[:-1], widths[1:])) <= \
            fd.WEIGHT_BUDGET:
        out = fd.fused_decode_grid(layers_, (6, 7, 8), acts, "n11")
        ref = fd.fused_decode_grid_reference(layers_, (6, 7, 8), acts, "n11")
        assert float((out - ref).abs().max()) <= \
            1e-5 * float(ref.abs().max()) + 1e-5
    from brief_pytorch_tpu_torch.ops import fused_siren as fs
    rows = coords.T.contiguous()
    out = fs.fused_chain_apply(layers_, rows, acts)
    ref = fs.fused_chain_apply_reference(layers_, rows, acts)
    assert float((out - ref).abs().max()) <= \
        1e-5 * float(ref.abs().max()) + 1e-5


@pytest.mark.parametrize("true_widths,layers,layout", [
    ((24, 28, 30, 32), 20, "wide"),         # 4 x [3] + [32] x 19 + [1]
    ((4000, 4096), 2, "stream"),            # 2 x 3-4096-1
])
def test_reach_fleet_matches_plain(dev, true_widths, layers, layout):
    models, layers_, um, (c, v, w), thres = _fleet(dev, true_widths, layers,
                                                   n=3000)
    padded = [3] + [int(l["w"].shape[-1]) for l in layers_]
    p = ft.choose_plan(padded)
    assert ("stream" if p.get("stream") else p["layout"]) == layout
    acts = chain_layer_specs(models[0].spec)
    kw = dict(loss_name="datal2", beta=0.01)
    lk, gk = ft.fused_train_grads_fleet(layers_, c, v, w, acts, unit_masks=um,
                                        thres=thres, **kw)
    lp, gp = ft.fused_train_grads_reference(layers_, c, v, w, acts,
                                            weight_thres=thres,
                                            unit_masks=um, **kw)
    _close(lk, gk["layers"], lp, gp["layers"])


@pytest.mark.parametrize("widths,n", [
    ([3, 4096, 4096, 1], 16_384),           # chip_smoke.py REACH_TRAIN
    ([3, 20971, 1], 100_000),
])
def test_streamed_form_at_phase20_shapes(dev, widths, n):
    """Phase 20d's streamed shapes (kernel 1's streamed form, ops/stream.py):
    one launch of the form a call by its own count, within the plain
    version's tolerances, two calls bitwise equal."""
    from brief_pytorch_tpu_torch.ops import stream as st
    model, params = _chain(dev, widths[1], len(widths) - 1)
    assert ft.chain_widths(model.spec) == widths
    assert ft.choose_plan(widths).get("stream")
    acts = chain_layer_specs(model.spec)
    coords, values, weights = _batch(dev, n)
    kw = dict(loss_name="datal2", beta=0.01, weight_thres=0.5)
    before = st.launches
    lk, gk = ft.fused_train_grads(params["layers"], coords, values, weights,
                                  acts, **kw)
    assert st.launches == before + 1
    l2, g2 = ft.fused_train_grads(params["layers"], coords, values, weights,
                                  acts, **kw)
    assert torch.equal(lk, l2) and all(
        torch.equal(a[k], b[k]) for a, b in zip(gk["layers"], g2["layers"])
        for k in ("w", "b"))
    ft.free_scratch()
    lp, gp = ft.fused_train_grads_reference(params["layers"], coords, values,
                                            weights, acts, **kw)
    torch.cuda.synchronize()
    _close(lk, gk["layers"], lp, gp["layers"])


@pytest.mark.parametrize("loss_name", ["datal2", "datasmoothl1"])
def test_streamed_fleet_at_phase20_shape(dev, loss_name):
    """Phase 20d's streamed fleet, 2 x 3-4096-1 (true 4000 and 4096), N =
    100,000, masks and thresholds: within the plain version's tolerances,
    padded units' gradients exactly 0."""
    models, layers_, um, (c, v, w), thres = _fleet(dev, (4000, 4096), 2,
                                                   n=100_000)
    assert ft.choose_plan([3, 4096, 1]).get("stream")
    acts = chain_layer_specs(models[0].spec)
    kw = dict(loss_name=loss_name, beta=0.01)
    lk, gk = ft.fused_train_grads_fleet(layers_, c, v, w, acts, unit_masks=um,
                                        thres=thres, **kw)
    lp, gp = ft.fused_train_grads_reference(layers_, c, v, w, acts,
                                            weight_thres=thres,
                                            unit_masks=um, **kw)
    _close(lk, gk["layers"], lp, gp["layers"])
    assert not gk["layers"][0]["w"][0, :, 4000:].any()
    assert not gk["layers"][0]["b"][0, 4000:].any()
    assert not gk["layers"][1]["w"][0, 4000:, :].any()


def test_fused_decode_sirenpos(dev):
    model, params = _chain(dev, 16, 4, name="SIRENPos", T=[2.0, 3.0, 2.0])
    out = fd.decode_volume(model, params, (9, 10, 11), "n11")
    ref = fd.fused_decode_grid_reference(
        params["layers"], (9, 10, 11), chain_layer_specs(model.spec), "n11",
        enc_periods=(2.0, 3.0, 2.0))
    assert float((out - ref).abs().max()) <= 1e-5


def test_wrappers_reject_bad_inputs(dev):
    model, params = _chain(dev, 16, 3)
    acts = chain_layer_specs(model.spec)
    coords, values, weights = _batch(dev, 256)
    with pytest.raises(ValueError):
        ft.fused_train_grads(params["layers"], coords.T, values, weights,
                             acts, loss_name="datal2")
    with pytest.raises(ValueError):
        ft.fused_train_grads(params["layers"], coords.double(), values,
                             weights, acts, loss_name="datal2")
    with pytest.raises(ValueError):
        fd.fused_decode_grid(params["layers"], (4, 4), acts)


def test_profiling_reports_device_time(dev, capsys):
    from brief_pytorch_tpu_torch.utils import profiling
    out = profiling.main(["--steps", "20"])
    assert out["steps"] == 20 and out["device"] == torch.cuda.get_device_name(0)
    assert 0 < out["device_ms_per_step"] < out["wall_ms_per_step"]
    assert 0 <= out["device_idle_share"] < 1
    assert any("fused_train_kernel" in k for k in out["kernels"])


# --- the train kernel's fleet form and its wide-chain layout ---------------
def _fleet(dev, true_widths, layers=4, cout=1, n=5000, seed=3, cin=3):
    """B padded SIREN chains (w0 = 10) of the given true widths, their unit
    masks, a batch and per-block thresholds (finite and -inf)."""
    from brief_pytorch_tpu_torch.parallel.block_trainer import build_stacked
    models = [tphi.init_phi({"name": "SIREN", "coords_channel": cin,
                             "data_channel": cout, "features": f,
                             "layers": layers, "w0": 10})
              for f in true_widths]
    _, params, masks = build_stacked(models, seed, device=dev)
    B = len(true_widths)
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    batch = (f(rng.uniform(-1, 1, (B, cin, n))),
             f(rng.uniform(0, 1, (B, cout, n))),
             f(rng.uniform(1, 2, (B, cout, n))))
    thres = torch.tensor([0.4, -np.inf, 0.6, -np.inf][:B], device=dev)
    return models, params["layers"], list(masks[:-1]) + [None], batch, thres


def _close(lk, gk, lp, gp):
    assert bool(((lk - lp).abs() <= 1e-5 * lp.abs()).all())
    for a, b in zip(gk, gp):
        for k in ("w", "b"):
            assert a[k].shape == b[k].shape
            d = float((a[k] - b[k]).abs().max())
            assert d <= 1e-4 * float(b[k].abs().max()) + 1e-6


@pytest.mark.parametrize("true_widths,layers,n,layout", [
    ((8, 12, 10), 4, 5000, "narrow"),
    ((51, 54, 60, 66), 7, 20000, "tiled"),      # 3-66x6-1
    ((49, 52, 58, 64), 7, 100003, "tiled"),     # the HiP-CT bucket, ragged
    ((98, 106, 117, 128), 7, 20003, "wide"),    # past the tiled layout
])
@pytest.mark.parametrize("loss_name", ["datal2", "datasmoothl1"])
def test_fused_train_fleet_matches_plain(dev, true_widths, layers, n, layout,
                                         loss_name):
    models, layers_, um, (c, v, w), thres = _fleet(dev, true_widths, layers,
                                                   n=n)
    padded = [3] + [int(l["w"].shape[-1]) for l in layers_]
    assert ft.choose_plan(padded)["layout"] == layout
    acts = chain_layer_specs(models[0].spec)
    kw = dict(loss_name=loss_name, beta=0.01)
    before = ft.launches
    lk, gk = ft.fused_train_grads_fleet(layers_, c, v, w, acts, unit_masks=um,
                                        thres=thres, **kw)
    assert ft.launches == before + 1
    lp, gp = ft.fused_train_grads_reference(layers_, c, v, w, acts,
                                            weight_thres=thres,
                                            unit_masks=um, **kw)
    torch.cuda.synchronize()
    _close(lk, gk["layers"], lp, gp["layers"])
    # padded units get exactly zero gradient; each block equals the
    # one-chain kernel on its unpadded chain
    for i, m in enumerate(models):
        dims = [(e.fan_in, e.fan_out) for e in m.spec.entries]
        for (a, b), g in zip(dims, gk["layers"]):
            assert int(torch.count_nonzero(g["w"][i, a:, :])) == 0
            assert int(torch.count_nonzero(g["w"][i, :, b:])) == 0
            assert int(torch.count_nonzero(g["b"][i, b:])) == 0
        own = [{"w": l["w"][i, :a, :b].contiguous(),
                "b": l["b"][i, :b].contiguous()}
               for l, (a, b) in zip(layers_, dims)]
        t = float(thres[i])
        ls, gs = ft.fused_train_grads(own, c[i], v[i], w[i], acts,
                                      weight_thres=t if np.isfinite(t)
                                      else None, **kw)
        _close(lk[i], [{"w": g["w"][i, :a, :b], "b": g["b"][i, :b]}
                       for g, (a, b) in zip(gk["layers"], dims)],
               ls, gs["layers"])


@pytest.mark.parametrize("true_widths,layers,cin", [
    ((58, 58, 58, 58), 7, 3),       # vessel.yaml's fleet (by_size)
    ((28, 28, 28, 28), 7, 3),       # neuron.yaml's fleet (by_size)
    ((47, 46, 44, 45), 5, 2),       # the 2048^2 PNG's total_1_2_2 fleet
])
@pytest.mark.parametrize("loss_name", ["datal2", "datasmoothl1"])
def test_tiled_fleets_of_the_configs_match_plain(dev, true_widths, layers,
                                                 cin, loss_name):
    """The tiled layout at the DivideTask configs' other fleets: one launch
    within the plain version's tolerances, padded units' gradients exactly
    0, each block equal to the one-chain kernel on its unpadded chain
    within them, two more calls bitwise equal."""
    models, layers_, um, (c, v, w), thres = _fleet(dev, true_widths, layers,
                                                   n=20011, cin=cin)
    padded = [cin] + [int(l["w"].shape[-1]) for l in layers_]
    assert ft.choose_plan(padded)["layout"] == "tiled"
    acts = chain_layer_specs(models[0].spec)
    kw = dict(loss_name=loss_name, beta=0.01)
    run = lambda: ft.fused_train_grads_fleet(layers_, c, v, w, acts,
                                             unit_masks=um, thres=thres, **kw)
    before = ft.launches
    lk, gk = run()
    assert ft.launches == before + 1
    lp, gp = ft.fused_train_grads_reference(layers_, c, v, w, acts,
                                            weight_thres=thres,
                                            unit_masks=um, **kw)
    torch.cuda.synchronize()
    _close(lk, gk["layers"], lp, gp["layers"])
    for i, m in enumerate(models):
        dims = [(e.fan_in, e.fan_out) for e in m.spec.entries]
        for (a, b), g in zip(dims, gk["layers"]):
            assert int(torch.count_nonzero(g["w"][i, a:, :])) == 0
            assert int(torch.count_nonzero(g["w"][i, :, b:])) == 0
            assert int(torch.count_nonzero(g["b"][i, b:])) == 0
        own = [{"w": l["w"][i, :a, :b].contiguous(),
                "b": l["b"][i, :b].contiguous()}
               for l, (a, b) in zip(layers_, dims)]
        t = float(thres[i])
        ls, gs = ft.fused_train_grads(own, c[i], v[i], w[i], acts,
                                      weight_thres=t if np.isfinite(t)
                                      else None, **kw)
        _close(lk[i], [{"w": g["w"][i, :a, :b], "b": g["b"][i, :b]}
                       for g, (a, b) in zip(gk["layers"], dims)],
               ls, gs["layers"])
    for loss, grads in (run(), run()):
        assert torch.equal(loss, lk)
        for a, b in zip(grads["layers"], gk["layers"]):
            assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])


@pytest.mark.parametrize("true_widths,layers", [((30, 24, 17), 5),
                                                ((49, 52, 58, 64), 7)])
def test_fused_train_fleet_relu_sigmoid_masked(dev, true_widths, layers):
    models, layers_, um, (c, v, w), thres = _fleet(dev, true_widths, layers)
    acts = tuple((("relu", 1.0), ("sigmoid", 1.0))[l % 2]
                 for l in range(layers - 1)) + (("none", 1.0),)
    kw = dict(loss_name="datasmoothl1", beta=0.05)
    lk, gk = ft.fused_train_grads_fleet(layers_, c, v, w, acts, unit_masks=um,
                                        thres=thres, **kw)
    lp, gp = ft.fused_train_grads_reference(layers_, c, v, w, acts,
                                            weight_thres=thres,
                                            unit_masks=um, **kw)
    _close(lk, gk["layers"], lp, gp["layers"])


@pytest.mark.parametrize("true_widths,layers,layout", [
    ((8, 12, 10), 4, "narrow"), ((51, 54, 60, 66), 7, "tiled"),
    ((49, 52, 58, 64), 7, "tiled"), ((98, 106, 117, 128), 7, "wide")])
def test_fused_train_fleet_is_deterministic(dev, true_widths, layers, layout):
    models, layers_, um, (c, v, w), thres = _fleet(dev, true_widths, layers,
                                                   n=30000)
    padded = [3] + [int(l["w"].shape[-1]) for l in layers_]
    assert ft.choose_plan(padded)["layout"] == layout
    acts = chain_layer_specs(models[0].spec)
    runs = [ft.fused_train_grads_fleet(layers_, c, v, w, acts, unit_masks=um,
                                       thres=thres, loss_name="datal2")
            for _ in range(3)]
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for a, b in zip(grads["layers"], runs[0][1]["layers"]):
            assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])


@pytest.mark.parametrize("features,layers,layout", [
    (66, 7, "tiled"), (95, 5, "tiled"), (96, 5, "tiled"), (186, 5, "wide"),
    (352, 5, "wide")])
def test_wide_chain_trains_on_the_kernel(dev, features, layers, layout):
    """Chains beyond the narrow layout: 3-66x6-1 and SingleTask 5 x 95
    and 5 x 96 (the tiled layout; 5 x 96 needs its largest dW job
    instance, 13 a warp), the
    SingleTask default at 3-186x4-1 and a 352-wide chain, the widest the
    wide layout takes: supports_training holds, the plan is the expected
    one, and
    the kernel matches its plain version."""
    model, params = _chain(dev, features, layers)
    assert ft.supports_training(model, "datal2")
    p = ft.choose_plan(ft.chain_widths(model.spec))
    assert p["layout"] == layout
    if layout == "wide":
        assert p["block"] in (128, 64) and not p["stream"]
    acts = chain_layer_specs(model.spec)
    coords, values, weights = _batch(dev, 20000)
    kw = dict(loss_name="datal2", beta=0.01, weight_thres=0.5)
    lk, gk = ft.fused_train_grads(params["layers"], coords, values, weights,
                                  acts, **kw)
    lp, gp = ft.fused_train_grads_reference(params["layers"], coords, values,
                                            weights, acts, **kw)
    torch.cuda.synchronize()
    _close(lk, gk["layers"], lp, gp["layers"])


def test_too_wide_chain_raises_on_the_card(dev):
    """A chain whose widest layer the wide layout does not take (3,400
    features), which raised NotImplementedError before, trains on the
    kernel: the gate holds, the plan is the wide layout's streamed form,
    and the kernel matches its plain version."""
    model, params = _chain(dev, 3400, 2)
    assert ft.supports_training(model, "datal2")
    p = ft.choose_plan(ft.chain_widths(model.spec))
    assert p["layout"] == "wide" and p["stream"]
    coords, values, weights = _batch(dev, 1000)
    acts = chain_layer_specs(model.spec)
    kw = dict(loss_name="datal2", beta=0.01, weight_thres=0.5)
    before = ft.launches
    lk, gk = ft.fused_train_grads(params["layers"], coords, values, weights,
                                  acts, **kw)
    assert ft.launches == before + 1
    lp, gp = ft.fused_train_grads_reference(params["layers"], coords, values,
                                            weights, acts, **kw)
    torch.cuda.synchronize()
    _close(lk, gk["layers"], lp, gp["layers"])


# --- the wide layout at the demo volumes' SingleTask widths ---------------
@pytest.mark.parametrize("thres", [0.5, None])
@pytest.mark.parametrize("loss_name", ["datal2", "datasmoothl1"])
@pytest.mark.parametrize("features", [191, 242])
def test_wide_layout_matches_plain(dev, features, loss_name, thres):
    """opt/SingleTask/default.yaml's chain on the 64x512x512 demo volumes
    (5 x 191 at 80x, 5 x 242 at 50x) in the wide layout, N = 20,003 (a
    tail no tile divides): one launch, within the plain version's
    tolerances."""
    model, params = _chain(dev, features, 5)
    assert ft.choose_plan(ft.chain_widths(model.spec))["layout"] == "wide"
    acts = chain_layer_specs(model.spec)
    coords, values, weights = _batch(dev, 20003)
    kw = dict(loss_name=loss_name, beta=0.01, weight_thres=thres)
    before = ft.launches
    lk, gk = ft.fused_train_grads(params["layers"], coords, values, weights,
                                  acts, **kw)
    assert ft.launches == before + 1
    lp, gp = ft.fused_train_grads_reference(params["layers"], coords, values,
                                            weights, acts, **kw)
    torch.cuda.synchronize()
    _close(lk[None], [{k: v[None] for k, v in g.items()} for g in
                      gk["layers"]], lp[None],
           [{k: v[None] for k, v in g.items()} for g in gp["layers"]])


def test_wide_layout_is_deterministic(dev):
    model, params = _chain(dev, 242, 5)
    acts = chain_layer_specs(model.spec)
    coords, values, weights = _batch(dev, 100000)
    runs = [ft.fused_train_grads(params["layers"], coords, values, weights,
                                 acts, loss_name="datal2", weight_thres=0.5)
            for _ in range(3)]
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for a, b in zip(grads["layers"], runs[0][1]["layers"]):
            assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])


@pytest.mark.parametrize("features", [191, 242])
def test_wide_decode_matches_plain(dev, features):
    """The decode kernel's wide form on a 64x128x128 grid at the demo
    volumes' SingleTask widths: one launch, within 1e-5 * max|plain| +
    1e-5 of the plain version."""
    model, params = _chain(dev, features, 5)
    assert fd.supports(model, (64, 128, 128))
    assert fd.choose_plan(ft.chain_widths(model.spec))["layout"] == "wide"
    acts = chain_layer_specs(model.spec)
    before = fd.launches
    out = fd.fused_decode_grid(params["layers"], (64, 128, 128), acts, "-1,1")
    assert fd.launches == before + 1
    ref = fd.fused_decode_grid_reference(params["layers"], (64, 128, 128),
                                         acts, "-1,1", slab=1 << 18)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (64 * 128 * 128, 1)
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= \
        1e-5 * float(ref.abs().max()) + 1e-5


def _siren_layers(dev, widths, seed, w0=20.0):
    rng = np.random.default_rng(seed)
    layers = []
    for l, (fin, fout) in enumerate(zip(widths[:-1], widths[1:])):
        r = 1.0 / fin if l == 0 else np.sqrt(6.0 / fin) / w0
        layers.append({k: torch.from_numpy(
            rng.uniform(-r, r, shape).astype(np.float32)).to(dev)
            for k, shape in (("w", (fin, fout)), ("b", (fout,)))})
    return layers


DECODE_FORMS = [
    # (hidden widths, grid, plan: form, instance ("stream": the streamed
    # form))
    ((22, 22, 22, 22), (13, 17, 19), ("narrow", 3)),
    ((7, 7, 7, 7), (5, 33), ("narrow", 3)),
    ((60, 15, 15, 15), (7, 9, 11), ("narrow", 9)),
    ((40, 40, 40), (3, 4, 5, 7), ("narrow", 6)),
    ((66,) * 6, (9, 31, 29), ("narrow", 9)),
    ((88, 88, 88, 88), (6, 29, 23), ("narrow", 12)),
    ((64,) * 15, (5, 27, 19), ("wide", 1)),
    ((96, 96, 96, 96), (7, 23, 21), ("wide", 2)),
    ((191, 191, 191, 191), (5, 41, 37), ("wide", 3)),
    ((242, 242, 242, 242), (3, 43, 47), ("wide", 4)),
    ((300, 257, 40), (4, 19, 23), ("wide", "stream")),
    ((383, 383, 383, 383), (5, 29, 31), ("wide", "stream")),
    ((257, 257, 257, 257), (5, 29, 31), ("wide", "stream")),
]


def _form(p):
    """(layout, instance or "stream") of a plan"""
    return (p["layout"], "stream" if p.get("stream") else p["inst"])


@pytest.mark.parametrize("act", ["sine", "relu", "sigmoid", "none"])
@pytest.mark.parametrize("hidden,spatial,form", DECODE_FORMS,
                         ids=[f"{f[0]}{f[1]}-"
                              f"{'x'.join(map(str, h[:2]))}"
                              for h, _, f in DECODE_FORMS])
def test_decode_forms_match_plain(dev, hidden, spatial, form, act):
    """Every instance of the three forms of the tensor-core decode (plans:
    ops/fused_decode.py choose_plan; past 256 features the streamed form),
    on grids whose voxel count is no multiple of any tile, with each
    activation in the hidden layers and two outputs: within 1e-5 *
    max|plain| + 1e-5 of the plain version, one launch a call (one kernel
    in the narrow form, two in the wide, the plan's count in the
    streamed: the library's own count), two calls bitwise equal."""
    from brief_pytorch_tpu_torch.ops import chain_stream as cs
    widths = [len(spatial)] + list(hidden) + [2]
    p = fd.choose_plan(widths)
    assert _form(p) == form
    layers = _siren_layers(dev, widths, seed=len(hidden))
    w0 = 20.0 if act == "sine" else 1.0
    acts = ((act, w0),) * (len(widths) - 2) + (("none", 1.0),)
    before = fd.launches
    kernels = fd.kernels_launched()
    out = fd.fused_decode_grid(layers, spatial, acts, "n11")
    assert fd.launches == before + 1
    assert fd.kernels_launched() - kernels == (
        cs.stream_call(p, int(np.prod(spatial)), _sms(dev))["kernels"]
        if p.get("stream") else 1 if p["layout"] == "narrow" else 2)
    ref = fd.fused_decode_grid_reference(layers, spatial, acts, "n11")
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (int(np.prod(spatial)), 2)
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= \
        1e-5 * float(ref.abs().max()) + 1e-5
    assert torch.equal(fd.fused_decode_grid(layers, spatial, acts, "n11"),
                       out)


@pytest.mark.parametrize("hidden", [(22, 22, 22, 22), (100, 100)])
def test_decode_sirenpos_both_forms(dev, hidden):
    """The SIRENPos warp folded into the lead coordinate and the tables,
    in both forms."""
    spatial, periods = (9, 10, 11), (2.0, 3.0, 2.0)
    widths = [3] + list(hidden) + [1]
    layers = _siren_layers(dev, widths, seed=7)
    acts = (("sine", 20.0),) * len(hidden) + (("none", 1.0),)
    out = fd.fused_decode_grid(layers, spatial, acts, "n11",
                               enc_periods=periods)
    ref = fd.fused_decode_grid_reference(layers, spatial, acts, "n11",
                                         enc_periods=periods)
    assert float((out - ref).abs().max()) <= \
        1e-5 * float(ref.abs().max()) + 1e-5


@pytest.mark.parametrize("hidden,spatial,form", [
    ((22, 22, 22, 22), (13, 17, 19), "narrow"),
    ((66,) * 6, (5, 31, 29), "narrow"),
    ((191, 191, 191, 191), (3, 41, 37), "wide"),
])
def test_decode_sums_are_the_model(dev, hidden, spatial, form):
    """On a relu chain (no sine, whose device and CPU copies may differ in
    a last bit) both forms of the grid decode give
    fused_siren.chain_tc_model's outputs bit for bit on the coordinates
    the kernel builds (fused_decode.grid_coords): each k-block's three
    products summed from zero and added in float32, the CPU twin of the
    card's arithmetic; the narrow form in one launch a call."""
    from brief_pytorch_tpu_torch.ops import fused_siren as fs
    widths = [len(spatial)] + list(hidden) + [1]
    assert fd.choose_plan(widths)["layout"] == form
    layers = _siren_layers(dev, widths, seed=11)
    acts = (("relu", 1.0),) * len(hidden) + (("none", 1.0),)
    out = fd.fused_decode_grid(layers, spatial, acts, "n11").cpu()
    coords = fd.grid_coords(spatial, "n11", device=dev).cpu()
    cpu = [{k: t.cpu() for k, t in layer.items()} for layer in layers]
    assert torch.equal(out, fs.chain_tc_model(cpu, coords, acts))


def test_decode_past_2_31_voxels(dev):
    """A grid of 2^31 voxels or more takes the kernel's 64-bit index
    split: the first voxels and those around and past 2^31 against the
    plain version."""
    spatial = (1, 46341, 46341)          # 2,147,488,281 voxels
    layers = _siren_layers(dev, [3, 8, 1], seed=9)
    acts = (("sine", 20.0), ("none", 1.0))
    out = fd.fused_decode_grid(layers, spatial, acts, "n11")
    pop = int(np.prod(spatial))
    for start, stop in ((0, 1 << 20), ((1 << 31) - (1 << 19), pop)):
        ref = fd.fused_decode_grid_reference(layers, spatial, acts, "n11",
                                             voxels=(start, stop))
        got = out[start:stop]
        assert float((got - ref).abs().max()) <= \
            1e-5 * float(ref.abs().max()) + 1e-5
    del out


# --- the batch-major fused forward kernel (ops/fused_siren.py) -------------
def _coords(dev, n, cin=3, seed=5):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.uniform(-1, 1, (n, cin)).astype(np.float32)).to(dev)


def _family(dev, name, seed=0, **extra):
    cfg = {"name": name, "coords_channel": 3, "data_channel": 1,
           "features": 22, "layers": 5, "w0": 20, **extra}
    model = tphi.init_phi(cfg)
    return model, model.init(torch.Generator().manual_seed(seed), dev)


FUSED_SIREN_CASES = [
    ("SIREN", dict(), 262144, "narrow"),                   # the default's width
    ("SIREN", dict(features=64, layers=7, w0=10), 100003, "narrow"),  # HiP-CT block
    ("SIREN", dict(features=186), 20011, "wide"),          # weights beyond smem
    ("SIREN_Pyramid", dict(features=40, features_dis=6), 5000, "narrow"),
    ("SIRENFT", dict(ratio=2.5), 4099, "narrow"),
    ("SIRENPS", dict(features=9, ratio=1.6), 4099, "narrow"),
    ("SIREN_RELU", dict(), 4099, "narrow"),
    ("SIREN_SIGMOID", dict(), 4099, "narrow"),
    ("SIREN", dict(coords_channel=2, data_channel=3, features=16,
                   layers=3), 130, "narrow"),
    ("SIREN", dict(output_act=True), 1, "narrow"),
]


@pytest.mark.parametrize("name,extra,n,layout", FUSED_SIREN_CASES)
def test_fused_siren_matches_plain(dev, name, extra, n, layout):
    """Forward within 2e-6 + 2e-6 * max|plain| of the plain version (the
    tolerance of the CUDA-core design this kernel replaced, held by the
    3xTF32 products), the tail masked in the kernel, two runs bitwise
    equal, one launch per call, in the form the plan names."""
    from brief_pytorch_tpu_torch.ops import fused_siren as fs
    model, params = _family(dev, name, **extra)
    assert fs.supports(model)
    widths = fs.chain_widths(model.spec)
    assert fs.choose_plan(widths)["layout"] == layout
    acts = chain_layer_specs(model.spec)
    coords = _coords(dev, n, widths[0])
    before = fs.launches
    out = fs.fused_chain_apply(params["layers"], coords, acts)
    assert fs.launches == before + 1
    ref = fs.fused_chain_apply_reference(params["layers"], coords, acts)
    again = fs.fused_chain_apply(params["layers"], coords, acts)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (n, widths[-1])
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= \
        2e-6 + 2e-6 * float(ref.abs().max())
    assert torch.equal(out, again)


SIREN_FORMS = [
    # (c_in, hidden widths, N, plan: form, instance or "stream")
    (3, (22, 22, 22, 22), 5003, ("narrow", 3)),
    (3, (40, 40, 40), 4099, ("narrow", 6)),
    (3, (66,) * 6, 3001, ("narrow", 9)),
    (3, (88, 88, 88, 88), 2047, ("narrow", 12)),
    (3, (64,) * 15, 1301, ("wide", 1)),
    (3, (96, 96, 96, 96), 1299, ("wide", 2)),
    (3, (191, 191, 191, 191), 1031, ("wide", 3)),
    (3, (242, 242, 242, 242), 1029, ("wide", 4)),
    (3, (300, 257, 40), 517, ("wide", "stream")),
    (3, (1024, 1024, 1024, 1024), 65536, ("wide", "stream")),
    (2, (32, 32), 1001, ("narrow", 6)),
    (4, (32, 32), 1001, ("narrow", 6)),
    (11, (32, 32), 1001, ("narrow", 6)),
    (2, (191, 191), 333, ("wide", 3)),
    (4, (191, 191), 333, ("wide", 3)),
    (11, (191, 191), 333, ("wide", 3)),
    (100, (22, 22), 257, ("wide", 1)),
    (257, (22, 22), 1001, ("wide", "stream")),
]


@pytest.mark.parametrize("act", ["sine", "relu", "sigmoid", "none"])
@pytest.mark.parametrize("c_in,hidden,n,form", SIREN_FORMS,
                         ids=[f"c{c}-{f[0]}{f[1]}-"
                              f"{'x'.join(map(str, h[:2]))}"
                              for c, h, _, f in SIREN_FORMS])
def test_fused_siren_forms_match_plain(dev, c_in, hidden, n, form, act):
    """Every instance of both forms of the batch-major kernel (the decode
    kernel's tensor-core chain with rows of an (N, C) input; SIREN
    3-1024x4-1 at phase 9's N), inputs of 2 to 100 features, N no
    multiple of any tile (but 65,536), each activation in the
    hidden layers and two outputs: within 1e-5 * max|plain| + 1e-5 of the
    plain version (kernel 2's tolerance for the same arithmetic), one
    launch a call, three calls bitwise equal."""
    from brief_pytorch_tpu_torch.ops import fused_siren as fs
    widths = [c_in] + list(hidden) + [2]
    p = fs.choose_plan(widths)
    assert _form(p) == form
    layers = _siren_layers(dev, widths, seed=len(hidden) + c_in)
    w0 = 20.0 if act == "sine" else 1.0
    acts = ((act, w0),) * (len(widths) - 2) + (("none", 1.0),)
    coords = _coords(dev, n, c_in, seed=n)
    before = fs.launches
    out = fs.fused_chain_apply(layers, coords, acts)
    assert fs.launches == before + 1
    ref = fs.fused_chain_apply_reference(layers, coords, acts)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (n, 2)
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= \
        1e-5 * float(ref.abs().max()) + 1e-5
    for _ in range(2):
        assert torch.equal(fs.fused_chain_apply(layers, coords, acts), out)


F64_CASES = [
    # (family, config keys, N): phase 9's chains and a wide one
    ("SIREN", dict(), 262144),
    ("SIREN", dict(features=64, layers=7, w0=10), 100003),
    ("SIREN_RELU", dict(), 65536),
    ("SIREN_SIGMOID", dict(), 65536),
    ("SIREN", dict(features=186), 65536),
]


@pytest.mark.parametrize("name,extra,n", F64_CASES,
                         ids=[f"{c[0]}-{c[1].get('features', 22)}"
                              for c in F64_CASES])
def test_fused_siren_float32_accuracy(dev, name, extra, n):
    """Kernel 3's distance from a float64 evaluation of the chain (each
    layer's pre-activation rounded once to float32), max and mean, at most
    2x the plain version's: its sums keep float32's accuracy, where the
    tensor core's truncating sums lose it (chip_smoke.py phase 9 holds
    the same)."""
    from brief_pytorch_tpu_torch.ops import fused_siren as fs
    model, params = _family(dev, name, **extra)
    layers = params["layers"]
    acts = chain_layer_specs(model.spec)
    coords = _coords(dev, n, 3)
    out = fs.fused_chain_apply(layers, coords, acts).double()
    ref = fs.fused_chain_apply_reference(layers, coords, acts).double()
    h = coords.double()
    for layer, (act, w0) in zip(layers, acts):
        z = (h @ layer["w"].double() + layer["b"].double()).float()
        h = fs._act(z, act, w0).double()
    d_k, d_p = (out - h).abs(), (ref - h).abs()
    assert float(d_k.max()) <= 2 * float(d_p.max())
    assert float(d_k.mean()) <= 2 * float(d_p.mean())


def test_fused_siren_sums_are_the_model(dev):
    """On a relu chain (no sine, whose device and CPU copies may differ in
    a last bit) the kernel's outputs are fused_siren.chain_tc_model's bit
    for bit: the CPU twin of its sums, through mma_tf32_model, is the
    card's arithmetic."""
    from brief_pytorch_tpu_torch.ops import fused_siren as fs
    model, params = _family(dev, "SIREN_RELU")
    layers = params["layers"]
    acts = chain_layer_specs(model.spec)
    coords = _coords(dev, 4099, 3)
    out = fs.fused_chain_apply(layers, coords, acts).cpu()
    cpu = [{k: t.cpu() for k, t in layer.items()} for layer in layers]
    assert torch.equal(out, fs.chain_tc_model(cpu, coords.cpu(), acts))


def test_fused_siren_past_2_31_floats(dev):
    """N * C past 2^31 floats (200,000,000 rows of 11): the kernel's 64-bit
    row offsets, against the plain version on the first rows, those whose
    offsets cross 2^31 and the last."""
    from brief_pytorch_tpu_torch.ops import fused_siren as fs
    n, c = 200_000_000, 11
    layers = _siren_layers(dev, [c, 8, 1], seed=9)
    acts = (("sine", 20.0), ("none", 1.0))
    coords = torch.rand((n, c), generator=torch.Generator(dev).manual_seed(3),
                        device=dev) * 2 - 1
    out = fs.fused_chain_apply(layers, coords, acts)
    cross = (1 << 31) // c
    for start, stop in ((0, 1 << 20), (cross - (1 << 19), cross + (1 << 19)),
                        (n - (1 << 20), n)):
        ref = fs.fused_chain_apply_reference(layers, coords[start:stop], acts)
        got = out[start:stop]
        assert float((got - ref).abs().max()) <= \
            1e-5 * float(ref.abs().max()) + 1e-5
    del out, coords


@pytest.mark.parametrize("name,extra", [
    ("SIREN", dict(features=32, layers=4)),
    ("SIREN_SIGMOID", dict()),
    ("SIREN", dict(features=186)),
])
def test_fused_siren_gradients_match_autograd(dev, name, extra):
    """Gradients of (out ** 2).mean() for every w, b and for coords within
    1e-6 + 1e-5 * max|autograd| of autograd through model.apply."""
    from brief_pytorch_tpu_torch.ops import fused_siren as fs
    model, params = _family(dev, name, **extra)
    coords = _coords(dev, 256).requires_grad_(True)
    leaves = [t.requires_grad_(True) for l in params["layers"]
              for t in l.values()]
    fused = fs.make_fused_apply(model)
    g1 = torch.autograd.grad((fused(params, coords) ** 2).mean(),
                             leaves + [coords])
    g2 = torch.autograd.grad((model.apply(params, coords) ** 2).mean(),
                             leaves + [coords])
    for a, b in zip(g1, g2):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= \
            1e-6 + 1e-5 * float(b.abs().max())


def test_fused_siren_sirenpos_and_gate(dev):
    from brief_pytorch_tpu_torch.ops import fused_siren as fs
    from brief_pytorch_tpu_torch.train.decode import fused_apply_or
    model, params = _family(dev, "SIRENPos", features=16, layers=4,
                            T=[2.0, 3.0, 2.0])
    coords = _coords(dev, 300)
    got = fs.make_fused_apply(model)(params, coords)
    assert float((got - model.apply(params, coords)).abs().max()) <= 2e-5
    for name, extra in [("SIREN", dict(res=True)), ("NeRF", dict()),
                        ("FFN", dict(embsize=8)), ("MFNFourier", dict()),
                        ("MFNGabor", dict())]:
        other, _ = _family(dev, name, **extra)
        assert not fs.supports(other)
        assert fused_apply_or(other, other.apply, device=dev) == other.apply
    assert fused_apply_or(model, model.apply, device=dev) != model.apply
    assert fused_apply_or(model, model.apply, use_kernel=False,
                          device=dev) == model.apply


def test_fused_siren_slab_route_decodes(dev):
    """reconstruct_flattened(apply_fn=...) runs the kernel once per slab of
    sample_size voxels, never the grid kernel, and agrees with the same
    route through model.apply within 2e-5."""
    from brief_pytorch_tpu_torch.ops import fused_siren as fs
    from brief_pytorch_tpu_torch.train.decode import (fused_apply_or,
                                                      reconstruct_flattened)
    model, params = _family(dev, "SIREN")
    shape = (20, 21, 22, 1)
    n0, g0 = fs.launches, fd.launches
    out = reconstruct_flattened(model, params, shape, 1000, "-1,1",
                                apply_fn=fused_apply_or(model, model.apply,
                                                        device=dev))
    assert fs.launches - n0 == -(-20 * 21 * 22 // 1024)
    assert fd.launches == g0
    ref = reconstruct_flattened(model, params, shape, 1000, "-1,1",
                                apply_fn=model.apply)
    assert out.shape == shape and np.abs(out - ref).max() <= 2e-5


def test_fused_siren_rejects_bad_inputs(dev):
    from brief_pytorch_tpu_torch.ops import fused_siren as fs
    model, params = _family(dev, "SIREN", features=16, layers=3)
    acts = chain_layer_specs(model.spec)
    coords = _coords(dev, 64)
    with pytest.raises(ValueError):
        fs.fused_chain_apply(params["layers"], coords.T, acts)
    with pytest.raises(ValueError):
        fs.fused_chain_apply(params["layers"], coords.double(), acts)
    with pytest.raises(ValueError):
        fs.fused_chain_apply(params["layers"], coords, acts[:-1])
    # past the 3,327 features it once refused, the kernel takes the chain
    # and matches its plain version
    wide, wparams = _family(dev, "SIREN", features=3328)
    assert fs.supports(wide)
    wacts = chain_layer_specs(wide.spec)
    out = fs.fused_chain_apply(wparams["layers"], coords, wacts)
    ref = fs.fused_chain_apply_reference(wparams["layers"], coords, wacts)
    assert float((out - ref).abs().max()) <= \
        1e-5 * float(ref.abs().max()) + 1e-5


# --- the narrow layout: warp-owned tiles, 3xTF32 on the tensor cores -------
def _plain_close(model, params, coords, values, weights, **kw):
    acts = chain_layer_specs(model.spec)
    lk, gk = ft.fused_train_grads(params["layers"], coords, values, weights,
                                  acts, **kw)
    lp, gp = ft.fused_train_grads_reference(params["layers"], coords, values,
                                            weights, acts, **kw)
    torch.cuda.synchronize()
    _close(lk[None], [{k: v[None] for k, v in g.items()}
                      for g in gk["layers"]], lp[None],
           [{k: v[None] for k, v in g.items()} for g in gp["layers"]])
    return lk, gk


@pytest.mark.parametrize("n", [262144, 262144 - 51])
@pytest.mark.parametrize("loss_name,thres", [("datal2", 0.5),
                                             ("datasmoothl1", None)])
def test_narrow_layout_single_task_chain(dev, n, loss_name, thres):
    """5 x 22 at the SingleTask default's N (and a tail that is no multiple
    of a group's 128-coordinate tile) on the narrow layout."""
    model, params = _chain(dev, 22, 5)
    assert ft.choose_plan(ft.chain_widths(model.spec))["layout"] == "narrow"
    coords, values, weights = _batch(dev, n)
    _plain_close(model, params, coords, values, weights,
                 loss_name=loss_name, beta=0.01, weight_thres=thres)


@pytest.mark.parametrize("name,extra,layout", [
    ("SIREN_Pyramid", {"features": 27, "features_dis": 3}, "narrow"),
    ("SIREN", {"features": 33}, "narrow"),              # its last width
    ("SIREN", {"features": 64}, "tiled"),               # the old edges
    ("SIREN", {"features": 48, "layers": 7}, "tiled"),
])
def test_narrow_layout_reach(dev, name, extra, layout):
    """The chains the old narrow layout took up to its edges: each on the
    layout the plan picks, against the plain version."""
    model = tphi.init_phi({"name": name, "coords_channel": 3,
                           "data_channel": 1, "layers": 5, "w0": 20,
                           **extra})
    params = model.init(torch.Generator().manual_seed(4), dev)
    assert ft.choose_plan(ft.chain_widths(model.spec))["layout"] == layout
    coords, values, weights = _batch(dev, 30011)
    _plain_close(model, params, coords, values, weights,
                 loss_name="datal2", beta=0.01, weight_thres=0.5)


@pytest.mark.parametrize("loss_name", ["datal2", "datasmoothl1"])
@pytest.mark.parametrize("acts", ["sine", "relu_sigmoid"])
def test_narrow_layout_brain64_fleet(dev, loss_name, acts):
    """brain64's fleet (8 blocks of 3-7x4-1, 20,000 coordinates each, on
    the small-chain instance) with finite and -inf thresholds, padded
    units masked (true widths 5-7): against the plain version, padded
    gradients exactly 0, three runs bitwise equal."""
    models, layers_, um, (c, v, w), _ = _fleet(
        dev, (7, 5, 7, 6, 7, 7, 5, 7), layers=5, n=20000)
    thres = torch.tensor([0.4, -np.inf] * 4, device=dev)
    padded = [3] + [int(l["w"].shape[-1]) for l in layers_]
    p = ft.choose_plan(padded)
    assert p["layout"] == "narrow" and p["small"]
    spec = chain_layer_specs(models[0].spec)
    if acts == "relu_sigmoid":
        spec = tuple((("relu", 1.0), ("sigmoid", 1.0))[l % 2]
                     for l in range(len(spec) - 1)) + (("none", 1.0),)
    kw = dict(loss_name=loss_name, beta=0.01)
    runs = [ft.fused_train_grads_fleet(layers_, c, v, w, spec, unit_masks=um,
                                       thres=thres, **kw) for _ in range(3)]
    lp, gp = ft.fused_train_grads_reference(layers_, c, v, w, spec,
                                            weight_thres=thres,
                                            unit_masks=um, **kw)
    torch.cuda.synchronize()
    lk, gk = runs[0]
    _close(lk, gk["layers"], lp, gp["layers"])
    for i, m in enumerate(models):
        dims = [(e.fan_in, e.fan_out) for e in m.spec.entries]
        for (a, b), g in zip(dims, gk["layers"]):
            assert int(torch.count_nonzero(g["w"][i, a:, :])) == 0
            assert int(torch.count_nonzero(g["w"][i, :, b:])) == 0
            assert int(torch.count_nonzero(g["b"][i, b:])) == 0
    for loss, grads in runs[1:]:
        assert torch.equal(loss, lk)
        for a, b in zip(grads["layers"], gk["layers"]):
            assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])


def test_narrow_layout_is_deterministic(dev):
    """Three runs of 5 x 22 at N = 262,144 are bitwise equal (each dW entry
    summed in one warp's registers, the blocks' rows in a fixed order)."""
    model, params = _chain(dev, 22, 5)
    acts = chain_layer_specs(model.spec)
    coords, values, weights = _batch(dev, 262144)
    runs = [ft.fused_train_grads(params["layers"], coords, values, weights,
                                 acts, loss_name="datal2", weight_thres=0.5)
            for _ in range(3)]
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for a, b in zip(grads["layers"], runs[0][1]["layers"]):
            assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])


# --- the media shapes: 2 coordinates, 3 output channels, 2-axis grids -------
@pytest.mark.parametrize("cin,features,cout,n", [
    (2, 92, 1, 100000),     # the 2048^2 PNG at 80x (SingleTask)
    (3, 227, 3, 100000),    # 64 frames of 512^2 BGR at 80x (video)
    (2, 22, 1, 4099),       # a narrow chain with a 2-wide first layer
])
@pytest.mark.parametrize("loss_name,thres", [("datal2", 0.5),
                                             ("datasmoothl1", None)])
def test_media_chains_train_on_the_kernel(dev, cin, features, cout, n,
                                          loss_name, thres):
    """Kernel 1 with C = 2 inputs (the k of the first layer padded) and
    c_out = 3 outputs (the last layer's n-tile) against its plain
    version: one launch, the module's tolerances."""
    model, params = _chain(dev, features, 5, cin=cin, cout=cout)
    acts = chain_layer_specs(model.spec)
    assert ft.supports_training(model, loss_name)
    coords, values, weights = _batch(dev, n, cin=cin, cout=cout)
    kw = dict(loss_name=loss_name, beta=0.01, weight_thres=thres)
    before = ft.launches
    lk, gk = ft.fused_train_grads(params["layers"], coords, values, weights,
                                  acts, **kw)
    assert ft.launches == before + 1
    lp, gp = ft.fused_train_grads_reference(params["layers"], coords, values,
                                            weights, acts, **kw)
    torch.cuda.synchronize()
    _close(lk[None], [{k: v[None] for k, v in g.items()}
                      for g in gk["layers"]], lp[None],
           [{k: v[None] for k, v in g.items()} for g in gp["layers"]])


@pytest.mark.parametrize("true_widths", [(40, 45, 47, 50), (7, 9, 12, 8)])
def test_media_fleet_with_two_coordinates(dev, true_widths):
    """Kernel 1's fleet form on blocks of a 2-D image (C = 2): against its
    plain version, padded gradients exactly 0."""
    from brief_pytorch_tpu_torch.parallel.block_trainer import build_stacked
    models = [tphi.init_phi({"name": "SIREN", "coords_channel": 2,
                             "data_channel": 1, "features": f, "layers": 5,
                             "w0": 20}) for f in true_widths]
    _, params, masks = build_stacked(models, 3, device=dev)
    B, n = len(true_widths), 30000
    rng = np.random.default_rng(4)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    c, v, w = (f(rng.uniform(-1, 1, (B, 2, n))), f(rng.uniform(0, 1, (B, 1, n))),
               f(rng.uniform(1, 2, (B, 1, n))))
    thres = torch.tensor([0.4, -np.inf, 0.6, -np.inf], device=dev)
    um = list(masks[:-1]) + [None]
    acts = chain_layer_specs(models[0].spec)
    layers_ = params["layers"]
    lk, gk = ft.fused_train_grads_fleet(layers_, c, v, w, acts,
                                        loss_name="datal2", unit_masks=um,
                                        thres=thres)
    lp, gp = ft.fused_train_grads_reference(layers_, c, v, w, acts,
                                            loss_name="datal2",
                                            weight_thres=thres, unit_masks=um)
    torch.cuda.synchronize()
    _close(lk, gk["layers"], lp, gp["layers"])
    for i, m in enumerate(models):
        for e, g in zip(m.spec.entries, gk["layers"]):
            assert int(torch.count_nonzero(g["w"][i, :, e.fan_out:])) == 0


@pytest.mark.parametrize("spatial,features,cout,slab", [
    ((2048, 2048), 92, 1, 1 << 20),       # the 2048^2 PNG, two axes
    ((64, 512, 512), 227, 3, 1 << 19),    # the video, c_out = 3 (wide form)
    ((96, 96), 17, 3, None),              # a small BGR image
])
def test_media_grids_decode_on_the_kernel(dev, spatial, features, cout, slab):
    """Kernel 2 on a 2-axis grid (no lead axis) and with c_out = 3 against
    its plain version: one call, within 1e-5 * max|plain| + 1e-5."""
    model, params = _chain(dev, features, 5, cin=len(spatial), cout=cout)
    assert fd.supports(model, spatial)
    acts = chain_layer_specs(model.spec)
    out = fd.fused_decode_grid(params["layers"], spatial, acts, "-1,1")
    ref = fd.fused_decode_grid_reference(params["layers"], spatial, acts,
                                         "-1,1", slab=slab)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (int(np.prod(spatial)), cout)
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= \
        1e-5 * float(ref.abs().max()) + 1e-5


# --- kernels 2 and 3's streamed form: chains past 256 features -----------
STREAM_SHAPES = [
    # (widths, kernel 3's rows, kernel 2's grid, hidden activation)
    ([3, 257, 257, 257, 257, 1], 65_536, (16, 32, 32), "sine"),   # 64-wide
    ([3, 300, 300, 300, 300, 1], 5_000, (16, 32, 32), "sine"),    # tiles
    ([3, 383, 383, 383, 383, 1], 5_000, (16, 32, 32), "sine"),
    ([3, 20971, 1], 65_536, (16, 32, 32), "sine"),     # chip_smoke 20d
    ([3, 4096, 4096, 1], 5_000, (16, 32, 32), "sine"),
    ([3, 22213, 1], 10_112, (4, 64, 64), "sine"),      # phase 20b's chain
    ([12, 3400, 5], 700, None, "sine"),                # a square layer 0
    ([3, 3400, 20], 777, (5, 6, 7), "sine"),           # a square last layer
    ([3, 3400, 3400, 3400, 2], 500, (2,) * 9, "sigmoid"),
]


@pytest.mark.parametrize("widths,n,spatial,act", STREAM_SHAPES,
                         ids=["-".join(map(str, s[0])) for s in STREAM_SHAPES])
def test_streamed_form_matches_plain(dev, widths, n, spatial, act):
    """Kernels 2 and 3 in the streamed form (ops/chain_stream.py): within
    1e-5 * max|plain| + 1e-5 of the plain version, two calls bitwise
    equal, each call counted once as streamed, kernel 2's kernels those
    its plan states."""
    from brief_pytorch_tpu_torch.ops import chain_stream as cs
    from brief_pytorch_tpu_torch.ops import fused_siren as fs
    layers = _siren_layers(dev, widths, seed=len(widths))
    w0 = 20.0 if act == "sine" else 1.0
    acts = ((act, w0),) * (len(widths) - 2) + (("none", 1.0),)
    assert fs.choose_plan(widths).get("stream")
    rows = _coords(dev, n, widths[0])
    before = fs.stream_launches
    out = fs.fused_chain_apply(layers, rows, acts)
    assert fs.stream_launches == before + 1
    ref = torch.cat([fs.fused_chain_apply_reference(layers, rows[i:i + 8192],
                                                    acts)
                     for i in range(0, n, 8192)])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= \
        1e-5 * float(ref.abs().max()) + 1e-5
    assert torch.equal(fs.fused_chain_apply(layers, rows, acts), out)
    if spatial is None:
        return
    pop = int(np.prod(spatial))
    p = fd.choose_plan([len(spatial)] + widths[1:])
    assert p.get("stream")
    layers = _siren_layers(dev, [len(spatial)] + widths[1:], seed=3)
    before, kernels = fd.stream_launches, fd.kernels_launched()
    out = fd.fused_decode_grid(layers, spatial, acts, "n11")
    assert fd.stream_launches == before + 1
    assert fd.kernels_launched() - kernels == \
        cs.stream_call(p, pop, _sms(dev))["kernels"]
    ref = fd.fused_decode_grid_reference(layers, spatial, acts, "n11",
                                         slab=4096)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= \
        1e-5 * float(ref.abs().max()) + 1e-5
    assert torch.equal(fd.fused_decode_grid(layers, spatial, acts, "n11"),
                       out)


@pytest.mark.parametrize("widths,n", [([3, 3400, 6], 1500),
                                      ([3, 3400, 3400, 3400, 2], 300),
                                      ([12, 3400, 20], 200),
                                      ([3, 300, 300, 300, 300, 1], 700),
                                      ([3, 383, 383, 6], 600)])
def test_streamed_sums_are_the_model(dev, widths, n):
    """On relu chains (no sine, whose device and CPU copies may differ in
    a last bit) the streamed form's outputs are chain_stream.stream_model's
    bit for bit: the thin sums by fmaf in their order, the products'
    mma.sync sums through mma_tf32_model, the epilogue's partial sums."""
    from brief_pytorch_tpu_torch.ops import chain_stream as cs
    from brief_pytorch_tpu_torch.ops import fused_siren as fs
    layers = _siren_layers(dev, widths, seed=13)
    acts = (("relu", 1.0),) * (len(widths) - 2) + (("none", 1.0),)
    rows = _coords(dev, n, widths[0])
    out = fs.fused_chain_apply(layers, rows, acts).cpu()
    cpu = [{k: t.cpu() for k, t in layer.items()} for layer in layers]
    assert torch.equal(out, cs.stream_model(cpu, rows.cpu(), acts,
                                            fs.choose_plan(widths),
                                            _sms(dev)))
