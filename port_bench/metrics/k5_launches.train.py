"""K5 (`ops/fused_resnet.py`; kernels `bottleneck_tf32x3_kernel`,
`bottleneck_wgmma_kernel`) a train step:
its launches in the traced stretch's device trace over the stretch's
steps, one a stride-1 identity bottleneck of the frozen ResNet's two
passes that `models/resnet.takes_k5` sends to K5.  None where the trace
holds none (cached features, or a ResNet on its modules alone)."""

K5_KERNELS = ("bottleneck_tf32x3_kernel", "bottleneck_wgmma_kernel")


def read(r: dict):
    t = r["trace"]
    n, _ = t.matching(*K5_KERNELS)
    return n / t.steps if n and t.steps else None
