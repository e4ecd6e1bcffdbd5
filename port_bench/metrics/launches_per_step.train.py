"""Kernels launched a train step: the kernels in the traced stretch's
device trace over its steps."""


def read(r: dict):
    t = r["trace"]
    return len(t.kernels) / t.steps if t.kernels else None
