"""Share of a step's wall time in which no operation ran on the card: the
card's busy time a step (the union of device operations in the traced
stretch, over its steps) against the wall time a step of the untraced
window.  The traced stretch's own wall time is not the divisor: the
profiler's per-launch cost slows a host-bound step while it records."""


def read(r: dict):
    t = r["trace"]
    if not t.busy_s or not r.get("untraced_steps"):
        return None
    return 100.0 * (1.0 - (t.busy_s / t.steps) / (r["untraced_s"] / r["untraced_steps"]))
