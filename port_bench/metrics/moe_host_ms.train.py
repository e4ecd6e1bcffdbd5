"""Host time of the MoE layers a train step (`models/deepseek_v2.py`
`MoE.forward`: router, dispatch, the held experts' grouped products,
shared experts, combine), summed over the layers.

The median over the traced steps of the host milliseconds a step spends
in the port's `moe` spans (`macsa_tpu_torch/utils/logging.span_median`),
with the profiler's per-launch cost in it, as every span metric (PERF.md
§5).  None where the program has no such span."""


def read(r: dict):
    try:
        from macsa_tpu_torch.utils.logging import span_median
    except ImportError:  # a program without spans
        return None
    return span_median("moe", "host_ms")
