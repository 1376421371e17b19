"""The host's launch calls (kernels, graphs, copies, memsets) per training
step in the traced sub-window."""


def read(r):
    return r.launches_per_unit() if r.unit == "step" else None
