"""K5 (`ops/fused_resnet.py`; kernels `bottleneck_tf32x3_kernel`,
`bottleneck_wgmma_kernel`) a served batch:
its launches in the traced stretch's device trace over the stretch's
batches.  One a stride-1 identity bottleneck that the ResNet's rule
(`models/resnet.takes_k5`) sends to K5, in each of a batch's two passes
(images, ROI crops).  None where the trace holds none (a program whose
ResNet runs every block on its modules)."""

K5_KERNELS = ("bottleneck_tf32x3_kernel", "bottleneck_wgmma_kernel")


def read(r: dict):
    t = r["trace"]
    n, _ = t.matching(*K5_KERNELS)
    return n / t.steps if n and t.steps else None
