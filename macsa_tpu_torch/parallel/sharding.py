"""Tensor parallelism (Megatron) over the `mp` group: the rules of
`macsa_tpu/parallel/sharding.py` on the port's parameter names, and the
collectives the sharded modules run.

JAX shards its parameters with `NamedSharding`s and XLA/GSPMD inserts the
collectives.  Here each mp rank keeps its slice of every sharded parameter
(`shard_model_`) and the modules that own them run Megatron's forms:

* a column-parallel `Dense` (the attention's query/key/value, the MLP's
  `intermediate.dense`) computes the rank's share of the output features;
  its input goes through `copy_to_mp` (identity forward, the input
  gradient summed over mp backward);
* a row-parallel `Dense` (`attention.output.dense`, the MLP's
  `output.dense`) multiplies the rank's share of the input features, sums
  the products over mp (`reduce_from_mp`: all_reduce forward, identity
  backward) and adds its replicated bias once, after the sum;
* `BertSelfAttention` then runs on `num_attention_heads / mp` heads
  (`models/layers.py`), K1 and K1b included;
* the token table is split by rows (`torch.tensor_split`: any vocabulary
  size): an `Embed` looks up the ids in its range, writes zeros for the
  others and sums over mp; Phase 1's tied head computes its share of the
  logits, trains on the vocab-parallel cross-entropy of
  `models/seq2seq.chunked_seq2seq_loss` and gathers whole rows
  (`gather_vocab`) for decoding.

Every replicated activation stays replicated: each mp rank ends a
collective with the same values, and dropout after one draws the same mask
on every mp rank of a data-parallel index (`DropoutRng` is keyed by
`dp_index`, not by rank).  So the replicated parameters' gradients are
equal over mp, and with them the updates.

Rules (torch weights are [out, in], flax kernels [in, out]: JAX's
`P(None, "mp")` is torch dim 0, `P("mp", None)` torch dim 1):

  attention.self.{query,key,value}  weight [H, H] dim 0, bias dim 0  (column)
  intermediate.dense                weight [I, H] dim 0, bias dim 0  (column)
  output.dense (attention and MLP)  weight [H, I] dim 1              (row)
  word_embeddings, and the Phase-1 table's other two names
  (decoder.embedding, decoder.dense)  weight [V, H] dim 0            (vocab)
  everything else                                                    replicated

They reach the text encoder and the FCMF fusion stack's own attention and
MLP blocks alike; the decoder's `PerHeadAttention`, the box head, the MDE,
the poolers, the classifier and the ResNet match no rule.  AdamW's moments
are per parameter, so they are sharded with it; the clipping norm sums
the sharded gradients' squares over mp (`train/optim.py`); checkpoints
hold whole tensors (`train/checkpoints.py`: `gather_whole`, `local_part`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from macsa_tpu_torch.parallel import mesh

COLUMN, ROW, VOCAB, REPLICATED = "column", "row", "vocab", "replicated"
_COLUMN_PARENTS = ("query", "key", "value")
# the Phase-1 token table's names besides `...word_embeddings.weight`
# (`models/seq2seq.TIED_TABLE_NAMES`; JAX's `shared_embedding`)
_TABLE_NAMES = ("decoder.embedding.weight", "decoder.dense.weight")


def leaf_spec(name: str, tensor: torch.Tensor) -> Tuple[str, Optional[int]]:
    """(kind, torch dim it splits) of one parameter, by its state-dict name:
    JAX's `leaf_spec` (`macsa_tpu/parallel/sharding.py:45-75`), rule for
    rule, on the port's names."""
    parts = name.split(".")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) >= 2 else ""
    grand = parts[-3] if len(parts) >= 3 else ""
    if tensor.dim() == 0:
        return REPLICATED, None
    if name in _TABLE_NAMES or (parent == "word_embeddings" and leaf == "weight"):
        return VOCAB, 0
    column = parent in _COLUMN_PARENTS or (parent == "dense" and grand == "intermediate")
    if column and ((leaf == "weight" and tensor.dim() == 2)
                   or (leaf == "bias" and tensor.dim() == 1)):
        return COLUMN, 0
    if parent == "dense" and grand == "output" and leaf == "weight" and tensor.dim() == 2:
        return ROW, 1
    return REPLICATED, None


@dataclasses.dataclass(frozen=True, eq=False)
class Shard:
    """This rank's slice of a sharded parameter: `kind` (column, row,
    vocab), the torch `dim` split, every mp rank's length along it, this
    rank's index and the mp group the owning module's collectives run on."""

    kind: str
    dim: int
    sizes: Tuple[int, ...]
    index: int
    group: Any

    @property
    def size(self) -> int:
        return len(self.sizes)

    @property
    def start(self) -> int:
        return sum(self.sizes[:self.index])

    @property
    def length(self) -> int:
        return self.sizes[self.index]

    @property
    def whole(self) -> int:
        return sum(self.sizes)


def param_shard(p: torch.Tensor) -> Optional[Shard]:
    """The shard a parameter holds (None: whole, replicated)."""
    return getattr(p, "tp", None)


def _divisibility_error(mp: int, what: str, n: int) -> ValueError:
    return ValueError(
        f"--mp {mp} does not divide {what} ({n}): mp must divide every attention's head "
        "count, hidden width and intermediate width.  (On the TPU the JAX package runs such "
        "a mesh with K1 dropped for the XLA path, macsa_tpu/models/layers.py:164-171; the "
        "port refuses it.)")


@torch.no_grad()
def shard_model_(model: nn.Module) -> nn.Module:
    """Apply the rules to a built, initialised model in place, over the mp
    group of `parallel.mesh` (nothing at mp 1): each rank keeps its slice
    of each sharded parameter, cut from the whole tensor (so call it after
    `mesh.replicate`, on every rank), tagged with its `Shard` (`.tp`); each
    `Dense`, `Embed` and `TiedHead` whose weight is sharded gets the same
    `.tp` and runs its Megatron form.  The Phase-1 table stays ONE
    parameter (its three modules see the slice).  Raises when mp does not
    divide a head count or a split width."""
    from macsa_tpu_torch.models.layers import BertSelfAttention

    mp, index, group = mesh.mp_size(), mesh.mp_index(), mesh.mp_group()
    if mp == 1:
        return model
    specs: Dict[int, Tuple[str, int]] = {}
    params: Dict[int, nn.Parameter] = {}
    for name, p in model.named_parameters(remove_duplicate=False):
        kind, dim = leaf_spec(name, p)
        if kind == REPLICATED:
            continue
        if specs.setdefault(id(p), (kind, dim)) != (kind, dim):
            raise ValueError(f"{name}: one parameter under two sharding rules")
        if kind != VOCAB and p.shape[dim] % mp:
            raise _divisibility_error(mp, name, p.shape[dim])
        params[id(p)] = p
    for name, m in model.named_modules():
        if isinstance(m, BertSelfAttention) and m.config.num_attention_heads % mp:
            raise _divisibility_error(mp, f"the heads of {name}", m.config.num_attention_heads)
    for key, p in params.items():
        kind, dim = specs[key]
        sizes = tuple(len(part) for part in torch.arange(p.shape[dim]).tensor_split(mp))
        shard = Shard(kind, dim, sizes, index, group)
        p.data = p.data.narrow(dim, shard.start, shard.length).clone()
        p.tp = shard
    for m in model.modules():
        weight = m._parameters.get("weight")
        if weight is not None and param_shard(weight) is not None:
            m.tp = weight.tp
    return model


# ---------------------------------------------------------------------------
# collectives of the sharded forward and backward
# ---------------------------------------------------------------------------

class _CopyToMP(torch.autograd.Function):
    """Identity forward; the gradient summed over mp backward (each rank's
    column shard contributes a part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromMP(torch.autograd.Function):
    """The sum over mp forward (the row-parallel products, the vocab-shard
    lookups); identity backward: the sum is replicated, so each rank's
    gradient of it is already the whole one."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherVocab(torch.autograd.Function):
    """Whole [..., V] rows from each rank's [..., V/mp] share: a zero
    buffer holding the rank's columns, summed over mp (exact: every element
    has one nonzero term).  Backward: the rank's columns of the gradient."""

    @staticmethod
    def forward(ctx, local, shard):
        ctx.shard = shard
        whole = local.new_zeros(local.shape[:-1] + (shard.whole,))
        whole.narrow(-1, shard.start, shard.length).copy_(local)
        dist.all_reduce(whole, group=shard.group)
        return whole

    @staticmethod
    def backward(ctx, g):
        s = ctx.shard
        return g.narrow(-1, s.start, s.length).contiguous(), None


def copy_to_mp(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    return _CopyToMP.apply(x, shard.group)


def reduce_from_mp(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    return _ReduceFromMP.apply(x, shard.group)


def gather_vocab(local: torch.Tensor, shard: Shard) -> torch.Tensor:
    return _GatherVocab.apply(local, shard)


def all_reduce_(x: torch.Tensor, shard: Shard, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place, no autograd: the merges of the vocab-parallel loss."""
    dist.all_reduce(x, op=op, group=shard.group)
    return x


def vocab_parallel_embedding(ids: torch.Tensor, table: torch.Tensor,
                             shard: Shard) -> torch.Tensor:
    """Rows of a row-split table: the rank's rows where the id is in its
    range, zeros elsewhere, summed over mp (exact, as `gather_vocab`)."""
    local = ids - shard.start
    inside = (local >= 0) & (local < shard.length)
    rows = F.embedding(torch.where(inside, local, 0), table)
    return reduce_from_mp(torch.where(inside[..., None], rows, 0.0), shard)


# ---------------------------------------------------------------------------
# whole tensors for checkpoints (host tensors over the gloo mp group)
# ---------------------------------------------------------------------------

def gather_whole(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The whole tensor on the host from every mp rank's part (a collective
    of the mp group: each of its ranks calls it, in one order)."""
    local = t.detach().to("cpu", copy=True).movedim(shard.dim, 0).contiguous()
    padded = local.new_zeros((max(shard.sizes),) + tuple(local.shape[1:]))
    padded[:shard.length] = local
    parts = [torch.empty_like(padded) for _ in shard.sizes]
    dist.all_gather(parts, padded, group=mesh.mp_host_group())
    whole = torch.cat([part[:n] for part, n in zip(parts, shard.sizes)])
    return whole.movedim(0, shard.dim).contiguous()


def local_part(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """This rank's part of a whole tensor."""
    return t.narrow(shard.dim, shard.start, shard.length).clone()


def shards_by_name(module: nn.Module) -> Dict[str, Shard]:
    """State-dict name -> shard of every sharded parameter (each of the
    tied table's names)."""
    return {name: p.tp for name, p in module.named_parameters(remove_duplicate=False)
            if param_shard(p) is not None}


def whole_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """`module.state_dict()` on the host with every shard gathered whole (a
    collective of the mp group)."""
    shards = shards_by_name(module)
    return {name: (gather_whole(t, shards[name]) if name in shards
                   else t.detach().to("cpu", copy=True))
            for name, t in module.state_dict().items()}
