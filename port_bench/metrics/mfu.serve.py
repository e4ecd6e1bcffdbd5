"""Forward FLOP of a served batch (`flops/counts.py`), times the batches of
the window's untraced stretch, over its wall time, as a share of the card's
dense TF32 peak (495 TFLOP/s: the fastest it multiplies f32 operands)."""


def read(r: dict):
    if not r.get("untraced_s"):
        return None
    return 100.0 * r["flop_per_step"] * r["untraced_steps"] / r["untraced_s"] / r["peak_flops"]
