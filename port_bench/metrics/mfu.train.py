"""Model FLOP of the train step (`flops/counts.py`), times the steps of the
window's untraced stretch, over its wall time, as a share of the card's
dense bf16 peak (989 TFLOP/s)."""


def read(r: dict):
    if not r.get("untraced_s"):
        return None
    return 100.0 * r["flop_per_step"] * r["untraced_steps"] / r["untraced_s"] / r["peak_flops"]
