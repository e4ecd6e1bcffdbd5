"""Data and tensor parallelism over processes, on `torch.distributed`.

Counterpart of `macsa_tpu/parallel/mesh.py`, which does the work of the
reference's DDP/NCCL process groups (run_multimodal_fcmf.py:126-169,
run_pretraining_fcmf.py:87-96) with a (dp, mp) `jax.sharding.Mesh`: there
XLA inserts the gradient all-reduce over `dp` and the tensor-parallel
collectives over `mp`.  Here each process (a rank) holds its local batch
and the model (whole, or its `mp` shard of it: `parallel/sharding.py`),
runs the step's kernels on that batch, and the optimizer sums the ranks'
gradients over its data-parallel group and divides by the group's size
once on each update boundary (`all_reduce_gradients`, called by
`train/optim.py`).  `--train_batch_size` is per data-parallel rank; the
global batch is dp x it, as in JAX.

The (dp, mp) layout (`init_model_parallel`) splits the world as JAX's
`make_mesh` splits its devices, `np.asarray(devices).reshape(dp, mp)`:
rank r sits at (r // mp, r % mp).  The mp ranks of one data-parallel
index see the same rows; the data-parallel sites (the gradient mean,
`all_sum` / `all_mean`, `fetch_global`, the loaders' shards and stripes,
the feature cache's rows) use the dp group and `dp_index()`, never the
world.  Without a layout (mp 1) the dp group is the world.

`make_mesh`, the kernel mesh (`set_kernel_mesh`, the shard_map wrapper of
the Pallas kernels) and `shard_batch` have no counterpart: a rank never
sees a peer's rows.

Launch: `torchrun --nproc_per_node N -m macsa_tpu_torch.train.finetune
[--mp M] ...` (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`,
`MASTER_PORT`), one card a rank over NCCL, or `--device cpu` over gloo.
A caller may make the process group itself first (tests; two ranks on one
card over gloo, which NCCL refuses): `maybe_initialize_distributed` then
leaves it as it is.

Host arrays (the eval stripes' predictions, the feature cache's row
indices, the checkpoints' shards) are gathered over gloo groups, so
gathering them never waits on the card's stream.  The collectives run
whenever a process group exists, a world of one included (a copy then),
and are skipped without one.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


@dataclasses.dataclass(frozen=True)
class _Layout:
    """The (dp, mp) split of one process group's world, and this rank's
    groups in it (each with the gloo group its host arrays travel over)."""

    world: object  # the default group it was made for
    dp: int
    mp: int
    dp_index: int
    mp_index: int
    dp_group: object
    mp_group: object
    dp_host: object
    mp_host: object


_LAYOUT: Optional[_Layout] = None


def _layout() -> Optional[_Layout]:
    """The layout of the current process group (None for mp 1, without a
    group, or after the group it was made for was destroyed)."""
    if _LAYOUT is None or not _initialized() or _LAYOUT.world is not dist.group.WORLD:
        return None
    return _LAYOUT


def init_model_parallel(mp: int) -> None:
    """Split the world into (dp, mp) = (world / mp, mp) as JAX's
    `make_mesh` reshapes its devices: rank r at (r // mp, r % mp).  Every
    rank calls it, after the process group exists (without one the world
    is one process).  Makes the dp groups (the ranks of one mp index) and
    the mp groups (the ranks of one dp index), and their gloo twins where
    the default group is not gloo.  mp 1 leaves no layout: the dp group is
    then the world."""
    global _LAYOUT
    world = process_count()
    if mp < 1 or world % mp:
        raise ValueError(f"--mp {mp} does not divide the {world} processes of the run")
    _LAYOUT = None
    if mp == 1:
        return
    rank, dp = process_index(), world // mp
    grid = np.arange(world).reshape(dp, mp)
    twins = dist.get_backend() != "gloo"

    def groups(ranks_list):
        """This rank's group among `ranks_list` and its host twin (every
        rank makes every group, in one order)."""
        mine = None
        for ranks in ranks_list:
            group = dist.new_group(ranks)
            host = dist.new_group(ranks, backend="gloo") if twins else group
            if rank in ranks:
                mine = (group, host)
        return mine

    dp_group, dp_host = groups([grid[:, j].tolist() for j in range(mp)])
    mp_group, mp_host = groups([grid[i].tolist() for i in range(dp)])
    _LAYOUT = _Layout(dist.group.WORLD, dp, mp, rank // mp, rank % mp,
                      dp_group, mp_group, dp_host, mp_host)


def dp_size() -> int:
    """Data-parallel ranks: the world divided by mp."""
    layout = _layout()
    return layout.dp if layout else process_count()


def dp_index() -> int:
    """This rank's data-parallel index: which share of the global batch it sees."""
    layout = _layout()
    return layout.dp_index if layout else process_index()


def mp_size() -> int:
    layout = _layout()
    return layout.mp if layout else 1


def mp_index() -> int:
    layout = _layout()
    return layout.mp_index if layout else 0


def dp_group():
    """The group the data-parallel collectives run over: the world without
    a layout, None without a process group."""
    layout = _layout()
    if layout:
        return layout.dp_group
    return dist.group.WORLD if _initialized() else None


def mp_group():
    """The tensor-parallel group; None unless mp > 1 (no mp collective is
    made then)."""
    layout = _layout()
    return layout.mp_group if layout else None


def mp_host_group():
    """The gloo group over this rank's mp peers (checkpoint shards)."""
    layout = _layout()
    return layout.mp_host if layout else None


def _dp_host_group():
    layout = _layout()
    return layout.dp_host if layout else _host_group()


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
    """The sum of `x` over the data-parallel ranks (a new tensor; `x`
    itself without a process group)."""
    if not _initialized():
        return x
    x = x.clone()
    dist.all_reduce(x, group=dp_group())
    return x


def all_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the data-parallel ranks: a metric of the global
    batch from the ranks' equal local batches."""
    if not _initialized():
        return x
    return all_sum(x) / dp_size()


@torch.no_grad()
def all_reduce_gradients(grads: Iterable[torch.Tensor]) -> None:
    """Replace each gradient with its mean over the data-parallel ranks, in
    place: one flat buffer per (device, dtype), summed, then divided by the
    dp size."""
    if not _initialized():
        return
    size, group = dp_size(), dp_group()
    groups: dict = {}
    for g in grads:
        groups.setdefault((g.device, g.dtype), []).append(g)
    for same in groups.values():
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat, group=group)
        flat.div_(size)
        torch._foreach_copy_(same, [part.view_as(g) for part, g in
                                    zip(flat.split([g.numel() for g in same]), same)])


def fetch_global(x) -> np.ndarray:
    """Every data-parallel rank's `x` (equal shapes; a tensor or an array)
    concatenated along dim 0 in dp order, as a host array on every rank.
    The counterpart of JAX's `process_allgather(x, tiled=True)`."""
    local = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if not _initialized():
        return local
    t = torch.from_numpy(np.ascontiguousarray(local))
    parts = [torch.empty_like(t) for _ in range(dp_size())]
    dist.all_gather(parts, t, group=_dp_host_group())
    return torch.cat(parts).numpy()


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Give every rank rank 0's parameters and buffers (a broadcast), so
    the ranks start from one model whatever each initialized.  Before
    `sharding.shard_model_`: it broadcasts whole tensors."""
    if _initialized():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


def barrier() -> None:
    """Wait until every rank gets here (after rank 0 writes a file)."""
    if _initialized():
        dist.barrier(group=_host_group())
