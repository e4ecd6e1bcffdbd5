"""Device milliseconds a train step of the held experts' grouped products
(`models/deepseek_v2.py` `HeldExperts`: `torch._grouped_mm`, forward, the
backward's recomputation and its four products): the summed device time
of the grouped GEMM's kernels (CUTLASS's `GroupProblemShape` kernel and
its `prepare_grouped_gemm_data`) in the traced stretch over its steps.
None where the trace holds none."""

GROUPED_KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def read(r: dict):
    t = r["trace"]
    n, seconds = t.matching(*GROUPED_KERNELS)
    return 1e3 * seconds / t.steps if n and t.steps else None
