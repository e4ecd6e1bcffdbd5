"""macsa_tpu_torch: the FCMF (ViMACSA) stack in PyTorch with hand-written
CUDA kernels for NVIDIA Hopper.

A port of the JAX package `macsa_tpu`, which stays the reference the port
is tested against.  Mirrors its layout: `config`, `ops` (kernels and their
plain PyTorch versions), `models`, `train`.  The kernels' sources are in
`csrc/`; they are built with `nvcc` at first use into `_build/`.  Nothing
here imports `jax`, `flax` or `macsa_tpu`.

Ported so far: the serving forward (`train.steps.make_finetune_eval_step`).
"""
