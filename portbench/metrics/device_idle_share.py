"""The share of a training step's time in which the card runs nothing:
1 - (device busy seconds per step, traced) x (steps per second, clean).
Read for device_idle_share.train and device_idle_share.single alike."""


def read(r):
    return r.idle_share() if r.unit == "step" else None
