"""Kernel 1's share of its roofline: the least time the card could take for
a step's products and bytes (counts.py) over the device time of the
kernels launched inside the fused_train entries, per step."""


def read(r):
    return r.roofline("train_kernel") if r.unit == "step" else None
