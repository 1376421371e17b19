"""The yardstick's counts, by hand, and the readers that use them."""
import pytest
import torch

from portbench import counts
from portbench.harness.readings import Readings
from portbench.harness.trace import TraceSummary
from portbench.harness import manifest
from portbench.reference import derive, siren

PEAKS = counts.peaks()
HIPCT = [derive.siren_dims(w, 7) for w in (51, 54, 60, 66)]
SINGLE = derive.siren_dims(191, 5)


@pytest.mark.parametrize("what,flops,least_ms", [
    ("fleet step", 4.0835e10, 0.0825),
    ("single step", 6.601e10, 0.1334),
    ("decompress", 3.698e12, 7.47),
])
def test_hand_checked_counts(what, flops, least_ms):
    if what == "fleet step":
        f = counts.train_step_flops(HIPCT, 100_000)
        b = counts.train_step_bytes(HIPCT, 100_000)
    elif what == "single step":
        f = counts.train_step_flops([SINGLE], 100_000)
        b = counts.train_step_bytes([SINGLE], 100_000)
    else:
        f = counts.decode_flops(SINGLE, 64 * 512 * 512)
        b = counts.decode_bytes(SINGLE, 64 * 512 * 512)
    assert f == pytest.approx(flops, rel=1e-4)
    # the products bound all three calls, not the bytes
    assert f / PEAKS["tf32_flops_per_s"] > b / PEAKS["hbm_bytes_per_s"]
    assert counts.least_seconds(f, b, PEAKS) * 1e3 == \
        pytest.approx(least_ms, rel=1e-3)


def test_macs_by_hand():
    # 3-191x4-1: 3*191 + 3*191^2 + 191 multiply-adds a point
    assert counts.macs(SINGLE) == 110207
    # forward + weight gradients + input gradients past the first layer
    assert counts.train_step_flops([SINGLE], 1) == 2 * (2 * 110207 + 109634)


def _readings(unit, rate, kernel_s, busy_s, launches, units=10):
    tr = TraceSummary(units=units, window_s=1.0, busy_s=busy_s,
                      launches=launches,
                      range_kernel_s={"train_kernel": kernel_s})
    f = counts.train_step_flops([SINGLE], 100_000)
    return Readings(unit=unit, units_per_s=rate, trace=tr,
                    work={"train_kernel": (f, 1.0)}, peaks=PEAKS)


def test_train_readers():
    # 10 steps, 2.9 ms of kernel 1 and 3.4 ms busy each, 237 steps/s
    r = _readings("step", 237.0, 0.029, 0.034, 1400)
    roof = manifest.reader("train_kernel_roofline")(r)
    assert roof == pytest.approx(100 * 0.13335e-3 / 2.9e-3, rel=1e-3)
    mfu = manifest.reader("train_mfu")(r)
    assert mfu == pytest.approx(100 * 6.60096e10 * 237 / 495e12, rel=1e-6)
    assert manifest.reader("host_launches_per_step")(r) == 140
    idle = manifest.reader("device_idle_share.train")(r)
    assert idle == pytest.approx(100 * (1 - 0.0034 * 237))
    assert manifest.reader("device_idle_share.single")(r) == idle


def test_nothing_to_read():
    """A reader that finds nothing returns nothing, never a 0."""
    r = _readings("step", 237.0, 0.029, 0.034, 0)
    assert manifest.reader("host_launches_per_step")(r) is None
    r.trace.range_kernel_s = {}
    assert manifest.reader("train_kernel_roofline")(r) is None
    other = _readings("decompress", 9.0, 0.9, 1.0, 100)
    for name in ("train_kernel_roofline", "train_mfu",
                 "host_launches_per_step", "device_idle_share.train"):
        assert manifest.reader(name)(other) is None


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.0 + 2 ** -12,
                      -1.0 - 2 ** -11 - 2 ** -13], dtype=torch.float32)
    got = siren.tf32_round(x)
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 3.0,
                            -1.0 - 2 ** -10]
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    exact = a.double() @ b.double()
    rel = ((siren.matmul(a, b, True).double() - exact).norm()
           / exact.norm())
    assert 1e-5 < rel < 2e-3      # TF32: ~2^-11 of each operand
