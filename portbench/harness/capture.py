"""What the benchmark reads from inside the program while it runs.

Two kinds of hooks, both installed by swapping a module attribute that the
program looks up at each call, and both removed again:

* `FirstSteps` records the first steps of a training loop as the program
  takes them: the batch it drew, the parameters before each step, the
  losses and gradients its step function returned, and the optimizer state
  after the first step.  The reference check reads these after the window.
* `ranges` opens a named profiler range around each call of the program's
  public kernel entries, so that the trace reader can tell which device
  kernels each one launched.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, List, Optional

import torch

from portbench.harness.trace import RANGE_PREFIX

# the program's public kernel entries, by the layer they belong to
KERNEL_ENTRIES = {
    "train_kernel": [("brief_pytorch_tpu_torch.ops.fused_train",
                      "fused_train_grads"),
                     ("brief_pytorch_tpu_torch.ops.fused_train",
                      "fused_train_grads_fleet")],
}


def _module(name: str):
    import importlib
    return importlib.import_module(name)


@contextlib.contextmanager
def patched(obj, attr: str, make: Callable[[Callable], Callable]):
    """Replace obj.attr by make(original) for the duration."""
    orig = getattr(obj, attr)
    setattr(obj, attr, make(orig))
    try:
        yield orig
    finally:
        setattr(obj, attr, orig)


@contextlib.contextmanager
def ranges(layers):
    """A profiler range named portbench.<layer> around every call of that
    layer's kernel entries."""
    with contextlib.ExitStack() as stack:
        for layer in layers:
            for mod, attr in KERNEL_ENTRIES[layer]:
                def make(fn, name=RANGE_PREFIX + layer):
                    @functools.wraps(fn)
                    def wrapped(*a, **kw):
                        with torch.profiler.record_function(name):
                            return fn(*a, **kw)
                    return wrapped
                stack.enter_context(patched(_module(mod), attr, make))
        yield


def _clone_layers(layers) -> List[Dict[str, torch.Tensor]]:
    return [{k: v.detach().clone() for k, v in layer.items()}
            for layer in layers]


class FirstSteps:
    """The first `n` calls of a training loop's step function.

    steps[k]: {'layers': parameters before step k+1, 'coords', 'values',
    'weights': the batch, 'loss', 'grads': what the step returned}.
    mu1: the optimizer's first moments after step 1, leaf by leaf.
    """

    def __init__(self, n: int = 4):
        self.n = n
        self.steps: List[Dict] = []
        self.mu1: Optional[List[torch.Tensor]] = None
        self.masks = None
        self._opt_states: List[Dict] = []

    def _record(self, layers, coords, vals, wts, loss, grads, opt_state):
        if len(self.steps) == 1 and opt_state is not None:
            self.mu1 = [m.detach().clone() for m in opt_state["mu"]]
        self.steps.append({
            "layers": _clone_layers(layers),
            "coords": coords.detach().clone(),
            "values": vals.detach().clone(),
            "weights": wts.detach().clone(),
            "loss": loss.detach().clone(),
            "grads": _clone_layers(grads["layers"])})

    @contextlib.contextmanager
    def single(self):
        """Record NFGR's steps (the fused and the autograd step alike)."""
        from brief_pytorch_tpu_torch.train import fit

        def make_opt(orig):
            def wrapped(*a, **kw):
                opt = orig(*a, **kw)
                init = opt.init

                def rec_init(params):
                    state = init(params)
                    self._opt_states.append(state)
                    return state
                opt.init = rec_init
                return opt
            return wrapped

        def make_step(orig):
            def wrapped(params, coords, vals, wts, **kw):
                loss, grads = orig(params, coords, vals, wts, **kw)
                if len(self.steps) < self.n:
                    state = self._opt_states[-1] if self._opt_states else None
                    self._record(params["layers"], coords, vals, wts, loss,
                                 grads, state)
                return loss, grads
            return staticmethod(wrapped)

        with patched(fit, "make_optimizer", make_opt), \
                patched_static(fit.NFGR, "_fused_grads", make_step), \
                patched_static(fit.NFGR, "_autograd_grads", make_step):
            yield self

    @contextlib.contextmanager
    def fleet(self):
        """Record the block fleet's steps (one bucket)."""
        from brief_pytorch_tpu_torch.parallel import block_trainer

        def make_step(orig):
            def wrapped(st, coords, vals, wts, sample_valid, **kw):
                loss, grads = orig(st, coords, vals, wts, sample_valid, **kw)
                if len(self.steps) < self.n:
                    self.masks = [m.detach().clone() for m in st.masks]
                    self._record(st.params["layers"], coords, vals, wts,
                                 loss, grads, st.opt_state)
                return loss, grads
            return wrapped

        with patched(block_trainer, "fleet_step", make_step):
            yield self


@contextlib.contextmanager
def patched_static(cls, attr: str, make):
    """patched() for a staticmethod of a class."""
    orig = cls.__dict__[attr].__func__
    setattr(cls, attr, make(orig))
    try:
        yield orig
    finally:
        setattr(cls, attr, staticmethod(orig))
