"""The port's hand-written kernels and their plain versions.

Importing the package registers the ops that an exported program calls
(`torch.ops.macsa_tpu_torch.fused_self_attention`, K1's forward,
`torch.ops.macsa_tpu_torch.box_attention`, K3's, and
`torch.ops.macsa_tpu_torch.fused_bottleneck`, K5's): a serving bundle
loads with `import macsa_tpu_torch.ops` and nothing else of the package.
"""

# imported for their registration
from macsa_tpu_torch.ops import box_attention, fused_attention, fused_resnet  # noqa: F401
