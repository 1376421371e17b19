"""The whole training step's share of the card's TF32 peak: a step's
product operations times the clean window's steps per second."""


def read(r):
    return r.mfu("train_kernel") if r.unit == "step" else None
