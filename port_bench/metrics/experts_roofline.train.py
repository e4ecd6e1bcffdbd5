"""The held experts' grouped products against their bound: over the traced
steps, the sum of each call's max(bytes / 3.35 TB/s, FLOP / 989 TFLOP/s)
(`flops/deepseek_v2.expert_calls`: the seven products a MoE layer runs in
a step, at the routes its `moe` span counted, `rows`), over the device
time of the grouped GEMM's kernels.  None where the trace or the spans
hold nothing."""

GROUPED_KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def read(r: dict):
    try:
        from macsa_tpu_torch.utils.logging import SPANS
    except ImportError:  # a program without spans
        return None
    t = r["trace"]
    _, seconds = t.matching(*GROUPED_KERNELS)
    rows = [s.counts.get("rows") for s in SPANS.spans if s.name == "moe" and s.step < t.steps]
    if not seconds or not rows or SPANS.dropped or any(v is None for v in rows):
        return None
    return 100.0 * sum(r["experts_bound_s"](int(v)) for v in rows) / seconds
