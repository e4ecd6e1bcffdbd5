"""macsa_tpu_torch: the FCMF (ViMACSA) stack in PyTorch with hand-written
CUDA kernels for NVIDIA Hopper.

A port of the JAX package `macsa_tpu`, which stays the reference the port
is tested against.  Mirrors its layout: `config`, `ops` (kernels and their
plain PyTorch versions), `models`, `train`, `data`, `native`, `utils`.  The
kernels' sources are in `csrc/`; they are built with `nvcc` at first use
into `_build/`.  Nothing here imports `jax`, `flax` or `macsa_tpu`.

Ported so far: the Phase-2 path, from files to reports: the host data path,
the serving forward (`train.steps.make_finetune_eval_step`), the fine-tune
train step, checkpoints, feature caches, and the fine-tune driver
(`python -m macsa_tpu_torch.train.finetune`).
"""
