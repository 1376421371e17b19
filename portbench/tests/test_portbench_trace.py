"""The reduction of a Chrome trace to the traced sub-window's readings."""
import pytest

from portbench.harness import trace


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_summary():
    ev = [
        _ev("user_annotation", "portbench.train_kernel", 0, 100),
        _ev("cuda_runtime", "cudaLaunchKernel", 10, 5, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 150, 5, corr=3),
        _ev("cuda_runtime", "cudaMemcpyAsync", 160, 5, corr=4),
        _ev("cuda_runtime", "cudaStreamSynchronize", 170, 50),
        _ev("cpu_op", "aten::mul", 140, 30),
        # another thread's launch inside the range's time is not the range's
        _ev("cuda_runtime", "cudaLaunchKernel", 30, 5, tid=2, corr=5),
        _ev("kernel", "k1", 100, 40, tid=7, corr=1),
        _ev("kernel", "k2", 130, 30, tid=7, corr=2),     # overlaps k1
        _ev("kernel", "k3", 300, 10, tid=7, corr=3),
        _ev("gpu_memcpy", "Memcpy DtoH", 320, 20, tid=7, corr=4),
        _ev("kernel", "k5", 400, 10, tid=8, corr=5),
    ]
    s = trace.summarize(ev, units=2, window_s=0.001)
    assert s.launches == 5
    assert s.busy_s == pytest.approx((60 + 10 + 20 + 10) * 1e-6)
    assert s.range_kernel_s == {"train_kernel": pytest.approx(60e-6)}
    assert s.device_ops[0] == ("k1", pytest.approx(40e-6))
    assert s.device_events == 5
    # gaps: 160-300 (the copy's call opens at 160), 310-320 and 340-400
    # (no host event open)
    assert dict(s.idle_gaps) == {"cudaMemcpyAsync": pytest.approx(140e-6),
                                 "host": pytest.approx(70e-6)}


def test_union():
    assert trace.union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert trace.union_seconds([]) == 0
