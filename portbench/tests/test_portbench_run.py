"""Whole runs of each cell on the CPU at a small size: the harness's look
for a chip skipped, everything else as on the card.  A sound program comes
out correct; each fault a cell can have, planted in the program under the
timed path, comes out not correct; and the control (the reference with
TF32 products in the program's place) fails one of the cell's limits."""
import json

import pytest
import torch

from conftest import SMALL
from portbench import control, run
from portbench.harness import capture, manifest
from portbench.harness.run_state import Run

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]
TRAIN = [c for c in CELLS if c.endswith(".train")]
SEED = 2 ** 31 + 977


def _run(cell, path, seconds=0.5):
    return run.execute(cell, SEED, seconds, False, "cpu", data_path=path,
                       overrides=SMALL)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, small_volume):
    result, lines, checks = _run(cell, small_volume)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0
    want = {e["name"]: e["unit"] for e in manifest.cell(cell).end_to_end}
    assert {k: v["unit"] for k, v in result["metrics"].items()} == want
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    json.dumps(result)
    assert any(line.startswith("window:") for line in lines)


def _fault_optimizer_unchanged():
    from brief_pytorch_tpu_torch.train import optim
    return capture.patched(optim.Optimizer, "step",
                           lambda f: (lambda self, p, g, s: None))


def _fault_half_batch(cell):
    if cell.startswith("hipct-divide"):
        from brief_pytorch_tpu_torch.parallel import block_trainer

        def make(f):
            def half(st, coords, vals, wts, valid, **kw):
                n = coords.shape[1] // 2
                return f(st, coords[:, :n], vals[:, :n], wts[:, :n], valid,
                         **kw)
            return half
        return capture.patched(block_trainer, "fleet_step", make)
    from brief_pytorch_tpu_torch.train.fit import NFGR

    def make_s(f):
        def half(params, coords, vals, wts, **kw):
            n = coords.shape[0] // 2
            return f(params, coords[:n], vals[:n], wts[:n], **kw)
        return staticmethod(half)
    return capture.patched_static(NFGR, "_autograd_grads", make_s)


def _fault_altered_loss(cell):
    """The step's loss altered where it is produced (by 1%)."""
    if cell.startswith("hipct-divide"):
        from brief_pytorch_tpu_torch.parallel import block_trainer

        def make(f):
            def alt(*a, **kw):
                loss, grads = f(*a, **kw)
                return loss * 1.01, grads
            return alt
        return capture.patched(block_trainer, "fleet_step", make)
    from brief_pytorch_tpu_torch.train.fit import NFGR

    def make_s(f):
        def alt(*a, **kw):
            loss, grads = f(*a, **kw)
            return loss * 1.01, grads
        return staticmethod(alt)
    return capture.patched_static(NFGR, "_autograd_grads", make_s)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", TRAIN)
def test_train_faults_fail(cell, fault, small_volume):
    plant = {"unchanged": _fault_optimizer_unchanged,
             "half_batch": lambda: _fault_half_batch(cell),
             "altered": lambda: _fault_altered_loss(cell)}[fault]
    with plant():
        result, _, checks = _run(cell, small_volume)
    assert not result["correct"], checks


@pytest.mark.parametrize("cell", TRAIN)
def test_control_fails_a_limit(cell, small_volume):
    """The reference with TF32 products in the program's place fails one of
    the cell's numbers; the sound program passes all of them."""
    c = manifest.cell(cell)
    r = Run(cell=c, seed=SEED, seconds=0.0, trace=False,
            device=torch.device("cpu"), t_start=0.0,
            data_path=small_volume, overrides=SMALL)
    out = control.train_readings(r, SEED)
    assert all(v <= c.limits[k] for k, v in out["program"].items()), out
    assert any(v > c.limits[k] for k, v in out["tf32"].items()), out
    assert any(v > c.limits[k] for k, v in out["half_batch"].items())
    # at least half of the leaves read 1 when nothing moves
    assert out["unchanged"]["update_gap"] >= 0.5


def test_forbidden_modules_compared_whole(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "brief_pytorch_tpu_torchx",
                        types.ModuleType("brief_pytorch_tpu_torchx"))
    assert "brief_pytorch_tpu" not in run.loaded_forbidden() or \
        "brief_pytorch_tpu" in {m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "jaxlib.fake",
                        types.ModuleType("jaxlib.fake"))
    assert "jaxlib" in run.loaded_forbidden()


def test_no_card_no_result(capsys, monkeypatch):
    """Without a CUDA card the run prints no result and exits non-zero."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", str(SEED),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
