"""Host time of the KDA blocks a train step (`models/kimi_linear.py`
`KimiDeltaAttention.forward`: the projections, the short convolutions,
the gates, the chunked core and the gated norm, issued; the backward's
recomputation runs in autograd's `backward` span), summed over the layers.

The median over the traced steps of the host milliseconds a step spends
in the port's `kda` spans (`macsa_tpu_torch/utils/logging.span_median`),
with the profiler's per-launch cost in it, as every span metric (PERF.md
§5).  None where the program has no such span."""


def read(r: dict):
    try:
        from macsa_tpu_torch.utils.logging import span_median
    except ImportError:  # a program without spans
        return None
    return span_median("kda", "host_ms")
