"""Share of the traced stretch (host clock, from a drained queue to a
drained queue) in which no operation ran on the card.  A served batch
issues few launches for its ~0.36 s, so the profiler's per-launch cost
leaves the stretch's length as the untraced window has it."""


def read(r: dict):
    t = r["trace"]
    if not t.window_s or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
