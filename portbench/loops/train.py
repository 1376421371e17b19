"""Traffic of kind "train": a closed loop over the program's own training
loop, one step after another, for the measured window.

DivideTask configurations run BlockFleetTrainer.train on the blocks that
plan_blocks makes, with checkpoint intervals of `interval_steps` and no
artifacts, timed at the end of each interval by the trainer's progress
hook (which fires after the interval's losses reached the host, so after a
sync); the first interval is warm-up and the window is whole intervals
after it.  SingleTask configurations run one NFGR.compress call with no
logger and no checkpoint: its first `interval_steps` steps are warm-up,
and the window runs from a sync before the next step until a sync once
`seconds` have passed, when the harness ends the call (NFGR.compress has
no hook; its step function is wrapped).  In both, nvidia-smi is read just
before the window opens and just after it closes.

The first steps of the window's loop are recorded (capture.FirstSteps) and
judged against the reference after the window (harness/train_check.py):
the same trainer or call runs them in its warm-up and goes on into the
window.  With --trace 1 a further short loop of the same kind runs under
the profiler after the window.

Traffic parameters (traffic/<name>.json): interval_steps,
traced_warmup_steps, traced_steps.
"""
from __future__ import annotations

import gc
import time

import torch

from portbench import counts
from portbench.harness import capture, train_check
from portbench.harness.run_state import (Outcome, Run, SmiSampler,
                                         WindowClosed)
from portbench.harness.trace import Profiled

MAX_STEPS = 10_000_000   # a bound no window reaches; its close ends the loop


def run(r: Run, smi: SmiSampler) -> Outcome:
    if r.cell.config["task"] == "divide":
        return _fleet(r, smi)
    if r.cell.config["task"] == "single":
        return _single(r, smi)
    raise NotImplementedError(r.cell.config["task"])


def _peak(r: Run) -> int:
    return int(torch.cuda.max_memory_allocated(r.device)) \
        if r.device.type == "cuda" else 0


def _sync(r: Run) -> None:
    if r.device.type == "cuda":
        torch.cuda.synchronize(r.device)


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _fleet_blocks(cfg):
    from brief_pytorch_tpu_torch.io.image import read_img
    from brief_pytorch_tpu_torch.parallel.divide_runner import (param_budget,
                                                                plan_blocks)
    from brief_pytorch_tpu_torch.post.preprocess import preprocess
    cf, path = cfg.CompressFramework, cfg.Dataset.data_path
    pre = cf.Compress.preprocess
    data = preprocess(read_img(path), pre.denoise.level, pre.denoise.close,
                      pre.clip)
    return plan_blocks(cf, data, param_budget(cf.Compress, path))[1]


def _fleet(r: Run, smi: SmiSampler) -> Outcome:
    from brief_pytorch_tpu_torch.ops import fused_train
    from brief_pytorch_tpu_torch.parallel.block_trainer import \
        BlockFleetTrainer
    t = r.cell.traffic
    cfg = r.config()
    cc = cfg.CompressFramework.Compress
    k = int(t["interval_steps"])
    blocks = _fleet_blocks(cfg)
    points = len(blocks) * int(cc.sampler.sample_size)
    marks = []
    launches = []

    def hook(step, _losses):
        if step == k:                       # warm-up over: the window opens
            _sync(r)
            smi.sample("before window")
            launches.append(fused_train.launches)
            marks.append((step, time.perf_counter()))
            return
        now = time.perf_counter()
        marks.append((step, now))
        if now - marks[0][1] >= r.seconds:
            raise WindowClosed

    cap = capture.FirstSteps()
    trainer = BlockFleetTrainer(seed=r.seed, device=r.device)
    with cap.fleet():
        try:
            trainer.train(blocks, cc, MAX_STEPS, progress_cb=hook,
                          checkpoints=list(range(k, MAX_STEPS + 1, k)))
        except WindowClosed:
            pass
    launches.append(fused_train.launches)
    smi.sample("after window")
    peak = _peak(r)
    (s0, t0), (s1, t1) = marks[0], marks[-1]
    steps_per_s = (s1 - s0) / (t1 - t0)
    notes = [f"window: steps {s0}-{s1} in {t1 - t0:.6f} s by the harness's "
             f"clock at the trainer's progress hook; the trainer's train_s "
             f"{trainer.train_s:.6f} s for steps 0-{s1}",
             f"fused_train.launches in the window: "
             f"{launches[-1] - launches[0]} ({s1 - s0} steps)"]
    del trainer
    summary = None
    if r.trace:
        summary = _fleet_traced(r, blocks, cc)
    del blocks
    _free()
    st = train_check.setting("divide", cfg.to_plain())
    return Outcome(
        end_to_end={"train_coords_per_s": steps_per_s * points,
                    "setup_s": t0 - r.t_start},
        unit="step", units_per_s=steps_per_s, attempted=s1 - s0, failed=0,
        checks=train_check.check(cap, st, True, r.device),
        memory_peak_bytes=peak, work=_work(st, cfg), trace=summary,
        notes=notes)


def _work(st, cfg):
    """A step's product operations and bytes, at the reference's widths."""
    chains = [c.dims for c in st.chains]
    n = int(cfg.CompressFramework.Compress.sampler.sample_size)
    return {"train_kernel": (counts.train_step_flops(chains, n),
                             counts.train_step_bytes(chains, n))}


def _fleet_traced(r: Run, blocks, cc):
    from brief_pytorch_tpu_torch.parallel.block_trainer import \
        BlockFleetTrainer
    t = r.cell.traffic
    w, n = int(t["traced_warmup_steps"]), int(t["traced_steps"])
    prof = Profiled()

    def hook(step, _losses):
        if step == w:
            prof.start()
        else:
            prof.stop(n)

    trainer = BlockFleetTrainer(seed=r.seed, device=r.device)
    with capture.ranges(("train_kernel",)):
        trainer.train(blocks, cc, w + n, progress_cb=hook,
                      checkpoints=[w, w + n])
    return prof.summary


def _single_opt(cfg, steps: int):
    cf = cfg.CompressFramework
    cf.Compress.max_steps = int(steps)
    cf.Compress.checkpoints = "none"
    return cf


def _single(r: Run, smi: SmiSampler) -> Outcome:
    from brief_pytorch_tpu_torch.ops import fused_train
    from brief_pytorch_tpu_torch.train.fit import NFGR
    warm = int(r.cell.traffic["interval_steps"])
    cfg = r.config()
    calls = [0]
    marks = []                  # (steps done, time) at the open and close
    launches = []

    def windowed(f):
        def step(*a, **kw):
            calls[0] += 1
            if calls[0] == warm + 1:        # warm-up over: the window opens
                _sync(r)
                smi.sample("before window")
                launches.append(fused_train.launches)
                marks.append((warm, time.perf_counter()))
            elif marks and time.perf_counter() - marks[0][1] >= r.seconds:
                _sync(r)
                marks.append((calls[0] - 1, time.perf_counter()))
                launches.append(fused_train.launches)
                raise WindowClosed
            return f(*a, **kw)
        return staticmethod(step)

    cap = capture.FirstSteps()
    nf = NFGR(_single_opt(r.config(), MAX_STEPS), None, r.seed, r.device)
    with cap.single(), \
            capture.patched_static(NFGR, "_fused_step", windowed), \
            capture.patched_static(NFGR, "_autograd_step", windowed):
        try:
            nf.compress(cfg.Dataset.data_path)
        except WindowClosed:
            pass
    smi.sample("after window")
    peak = _peak(r)
    (s0, t0), (s1, t1) = marks
    steps = s1 - s0
    notes = [f"window: steps {s0}-{s1} in {t1 - t0:.6f} s by the harness's "
             f"clock, a sync at each end, inside one NFGR.compress call "
             f"(its own train_s covers a finished call's steps only, and "
             f"the harness ends this one at the window's close)",
             f"fused_train.launches in the window: "
             f"{launches[-1] - launches[0]} ({steps} steps)"]
    del nf
    trace = _single_traced(r) if r.trace else None
    _free()
    st = train_check.setting("single", cfg.to_plain())
    n = int(cfg.CompressFramework.Compress.sampler.sample_size)
    return Outcome(
        end_to_end={"train_coords_per_s": steps * n / (t1 - t0),
                    "setup_s": t0 - r.t_start},
        unit="step", units_per_s=steps / (t1 - t0), attempted=steps,
        failed=0, checks=train_check.check(cap, st, False, r.device),
        memory_peak_bytes=peak, work=_work(st, cfg), trace=trace,
        notes=notes)


def _single_traced(r: Run):
    """A short compress whose steps after the warm-up run under the
    profiler; the profiler starts at the first of them, the card drained."""
    from brief_pytorch_tpu_torch.ops import fused_train
    from brief_pytorch_tpu_torch.train.fit import NFGR
    t = r.cell.traffic
    w, n = int(t["traced_warmup_steps"]), int(t["traced_steps"])
    prof = Profiled()
    calls = [0]

    def make(fn):
        def counted(*a, **kw):
            calls[0] += 1
            if calls[0] == w + 1:
                prof.start()
            return fn(*a, **kw)
        return counted

    cfg = r.config()
    with capture.ranges(("train_kernel",)), \
            capture.patched(fused_train, "fused_train_grads", make):
        NFGR(_single_opt(cfg, w + n), None, r.seed, r.device).compress(
            cfg.Dataset.data_path)
    if prof.prof is None:
        raise RuntimeError("the traced loop took no step on the kernel")
    return prof.stop(n)
