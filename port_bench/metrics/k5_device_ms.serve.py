"""K5's (`ops/fused_resnet.py`; kernels `bottleneck_tf32x3_kernel`,
`bottleneck_wgmma_kernel`) device
milliseconds a served batch: the kernels' summed device time in the
traced stretch over its batches.  None where the trace holds none."""

K5_KERNELS = ("bottleneck_tf32x3_kernel", "bottleneck_wgmma_kernel")


def read(r: dict):
    t = r["trace"]
    n, seconds = t.matching(*K5_KERNELS)
    return 1e3 * seconds / t.steps if n and t.steps else None
