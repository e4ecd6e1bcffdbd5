"""K1's forward (`ops/fused_attention.py`, kernels named `attention_fwd*`)
against its bound: calls (the port's `launch_counts`, one a call) times
max(bytes / 3.35 TB/s, FLOP / peak) of one call (`flops/counts.k1_forward`),
over the kernels' summed device time in the traced stretch."""


def read(r: dict):
    calls = r["calls"].get("fused_self_attention", 0)
    _, seconds = r["trace"].matching("attention_fwd")
    if not calls or not seconds:
        return None
    return 100.0 * calls * r["k1_fwd_bound_s"] / seconds
