"""K1's backward (kernels named `attention_bwd*`: one or two launches a
call) against its bound: calls (`launch_counts`, one a call whatever its
launches) times max(bytes / 3.35 TB/s, FLOP / peak) of one call
(`flops/counts.k1_backward`), over the kernels' summed device time in the
traced stretch."""


def read(r: dict):
    calls = r["calls"].get("fused_self_attention_bwd", 0)
    _, seconds = r["trace"].matching("attention_bwd")
    if not calls or not seconds:
        return None
    return 100.0 * calls * r["k1_bwd_bound_s"] / seconds
