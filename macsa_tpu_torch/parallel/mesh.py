"""Data parallelism over processes (the reference's DDP), on `torch.distributed`.

Counterpart of `macsa_tpu/parallel/mesh.py`, which does the work of the
reference's DDP/NCCL process groups (run_multimodal_fcmf.py:126-169,
run_pretraining_fcmf.py:87-96) with a `jax.sharding.Mesh`: there XLA
inserts the gradient all-reduce over the `dp` axis.  Here each process (a
rank) holds its local batch and the whole model, runs the step's kernels
on that batch, and the optimizer sums the ranks' gradients and divides by
the world size once on each update boundary (`all_reduce_gradients`,
called by `train/optim.py`).  `--train_batch_size` is per process; the
global batch is world x it, as in JAX.

`make_mesh`, the kernel mesh (`set_kernel_mesh`, the shard_map wrapper of
the Pallas kernels) and `shard_batch` have no counterpart: a rank never
sees a peer's rows, so nothing is sharded inside a step.  The `mp` axis
(tensor parallelism, `parallel/sharding.py`) is not ported.

Launch: `torchrun --nproc_per_node N -m macsa_tpu_torch.train.finetune ...`
(`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`), one
card a rank over NCCL, or `--device cpu` over gloo.  A caller may make the
process group itself first (tests; two ranks on one card over gloo, which
NCCL refuses): `maybe_initialize_distributed` then leaves it as it is.

Host arrays (the eval stripes' predictions, the feature cache's row
indices) are gathered over a gloo group, so gathering them never waits on
the card's stream.  The collectives run whenever a process group exists,
a world of one included (a copy then), and are skipped without one.
"""

from __future__ import annotations

import functools
import os
from typing import Iterable

import numpy as np
import torch
import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def maybe_initialize_distributed(device: torch.device) -> torch.device:
    """Join the process group `torchrun` describes (`WORLD_SIZE` > 1 in the
    environment): NCCL for a CUDA device, after making `cuda:LOCAL_RANK` the
    process's device, gloo for the CPU.  The reference's
    `dist.init_process_group('nccl')` (run_pretraining_fcmf.py:91).  Nothing
    happens when a group exists already or the world is one process.
    -> the device this rank runs on."""
    if _initialized():
        return device
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return device
    rank = int(os.environ["RANK"])
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            rank=rank, world_size=world)
    return device


def _host_group():
    """The group that host arrays travel over: the default one when it is
    gloo, else a gloo group over the same ranks (made once a default
    group, by every rank)."""
    return None if dist.get_backend() == "gloo" else _gloo_group_of(dist.group.WORLD)


@functools.cache
def _gloo_group_of(default_group):
    return dist.new_group(backend="gloo")


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks (a new tensor; `x` itself without a
    process group)."""
    if not _initialized():
        return x
    x = x.clone()
    dist.all_reduce(x)
    return x


def all_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the ranks: a metric of the global batch from
    the ranks' equal local batches."""
    if not _initialized():
        return x
    return all_sum(x) / process_count()


@torch.no_grad()
def all_reduce_gradients(grads: Iterable[torch.Tensor]) -> None:
    """Replace each gradient with its mean over the ranks, in place: one
    flat buffer per (device, dtype), summed, then divided by the world size."""
    if not _initialized():
        return
    world = process_count()
    groups: dict = {}
    for g in grads:
        groups.setdefault((g.device, g.dtype), []).append(g)
    for same in groups.values():
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat)
        flat.div_(world)
        torch._foreach_copy_(same, [part.view_as(g) for part, g in
                                    zip(flat.split([g.numel() for g in same]), same)])


def fetch_global(x) -> np.ndarray:
    """Every rank's `x` (equal shapes; a tensor or an array) concatenated
    along dim 0 in rank order, as a host array on every rank.  The
    counterpart of JAX's `process_allgather(x, tiled=True)`."""
    local = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if not _initialized():
        return local
    t = torch.from_numpy(np.ascontiguousarray(local))
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t, group=_host_group())
    return torch.cat(parts).numpy()


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Give every rank rank 0's parameters and buffers (a broadcast), so
    the ranks start from one model whatever each initialized."""
    if _initialized():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


def barrier() -> None:
    """Wait until every rank gets here (after rank 0 writes a file)."""
    if _initialized():
        dist.barrier(group=_host_group())
