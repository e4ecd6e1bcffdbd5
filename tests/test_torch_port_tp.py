"""Tensor parallelism in the port (`macsa_tpu_torch/parallel/sharding.py`):
gloo ranks on the CPU against one process and against the JAX package.

* (a) The rule table, name for name: for every parameter of the port's
  `FCMF` and `FCMFSeq2Seq`, `sharding.leaf_spec` equals JAX's `leaf_spec`
  at the path `jax_import` maps the name to, with the dim transposed
  (flax kernels are [in, out], torch weights [out, in]).

One job of four gloo ranks (subprocesses on a free port that import this
module, as `tests/test_torch_port_ddp.py` runs its job), then the first two
of them as a world of two, runs:
* (b) at (dp 2, mp 2): 3 AdamW steps of the Phase-2 step from parameters
  the JAX package initialised (carried across with `jax_import`), dropout
  0, K1's CPU path on each rank's heads (L 32): the losses within 5e-4 of
  JAX's replicated run (the bound of `tests/test_tp.py`), within 1e-5 of
  the port's one process; the gathered parameters within 1e-5 of each
  tensor's largest value;
* `finetune.main --mp 2` and `pretrain.main --mp 2` under the four ranks
  (dp 2), then under the two (dp 1), 2 epochs on `data/synth.py` files:
  their losses and reports equal one process's at the global batch, and
  rank 0 alone writes;
* at (dp 1, mp 2): (c) the same step at dropout 0.1 with the plain
  attention path, against mp 1's: within 1e-5, the mp ranks' replicated
  parameters bitwise equal (every mask after a collective is drawn alike
  on both ranks, the attention's on the whole heads); (d) Phase 1: 3 steps
  with and without `vocab_chunk` (a vocabulary of 63 rows: 32 and 31 a
  rank) against mp 1, then greedy and beam-3 tokens; (e) checkpoints: a
  resume at mp 2 from an mp 1 file continues with the mp 1 run's losses,
  and the file it saves loads in one process with the mp 1 file's names
  and shapes.
AdamW runs at eps 1e-4 with random biases, for the reason
`tests/test_torch_port_ddp.py` gives: a gradient that is zero in exact
arithmetic (an attention key's bias) is rounding noise, and the
row-parallel sums in two halves change its summation order.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from macsa_tpu_torch import config as tcfg
from macsa_tpu_torch.data import synth
from macsa_tpu_torch.models.fcmf import FCMF
from macsa_tpu_torch.models.layers import init_weights
from macsa_tpu_torch.models.resnet import VisualFeatures
from macsa_tpu_torch.models.seq2seq import FCMFSeq2Seq
from macsa_tpu_torch.parallel import mesh, sharding
from macsa_tpu_torch.train import finetune, optim, pretrain
from macsa_tpu_torch.train.checkpoints import CheckpointManager
from macsa_tpu_torch.train.state import TrainState
from macsa_tpu_torch.train.steps import make_finetune_train_step, make_pretrain_train_step

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
GLOBAL_B, VOCAB, P1_VOCAB, L, T = 4, 64, 63, 32, 8
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
MODEL = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=4, intermediate_size=64)
FCMF_ARGS = dict(num_imgs=2, num_roi=2, num_patches=4, visual_feat_dim=128, max_text_len=L,
                 box_heads=8)
SMALL = dict(hidden_size=32, num_attention_heads=4, intermediate_size=64)
PRETRAIN_SAMPLES = 6


def _cfg(fused: bool, dropout: float = 0.0, vocab: int = VOCAB) -> tcfg.FCMFConfig:
    rates = dict(hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout)
    return tcfg.FCMFConfig(
        model=tcfg.ModelConfig(**MODEL, fused_attention=fused, **rates),
        text=tcfg.TextEncoderConfig(vocab_size=vocab, max_position_embeddings=64, **MODEL,
                                    fused_attention=fused, **rates),
        **FCMF_ARGS)


def phase2_batch() -> dict:
    rng = np.random.default_rng(0)
    a = len(tcfg.ASPECTS)
    return {"input_ids": rng.integers(2, VOCAB, size=(GLOBAL_B, a, L)).astype(np.int32),
            "token_type_ids": np.zeros((GLOBAL_B, a, L), np.int32),
            "attention_mask": (np.arange(L) < rng.integers(3, L + 1, size=(GLOBAL_B, a, 1))
                               ).astype(np.int32),
            "added_mask": np.ones((GLOBAL_B, a, L + 4), np.int32),
            "labels": rng.integers(0, 4, size=(GLOBAL_B, a)).astype(np.int32),
            "grid": rng.normal(size=(GLOBAL_B, 2, 4, 128)).astype(np.float32),
            "roi": rng.normal(size=(GLOBAL_B, 2, 2, 128)).astype(np.float32),
            "roi_coors": rng.uniform(0, 1, size=(GLOBAL_B, 2, 2, 4)).astype(np.float32)}


def phase1_batch() -> dict:
    rng = np.random.default_rng(1)
    dec = rng.integers(3, P1_VOCAB, size=(GLOBAL_B, T)).astype(np.int32)
    labels = np.roll(dec, -1, axis=1)
    labels[:2, 4:] = -100
    return {"enc_input_ids": rng.integers(2, P1_VOCAB, size=(GLOBAL_B, L)).astype(np.int32),
            "dec_input_ids": dec, "labels": labels,
            "token_type_ids": np.zeros((GLOBAL_B, L), np.int32),
            "attention_mask": np.ones((GLOBAL_B, L), np.int32),
            "added_mask": np.ones((GLOBAL_B, L + 4), np.int32),
            "grid": rng.normal(size=(GLOBAL_B, 2, 4, 128)).astype(np.float32),
            "roi": rng.normal(size=(GLOBAL_B, 2, 2, 128)).astype(np.float32),
            "roi_coors": rng.uniform(0, 1, size=(GLOBAL_B, 2, 2, 4)).astype(np.float32)}


def _local(batch: dict) -> dict:
    """This data-parallel rank's contiguous share of the global batch (the
    mp ranks of one dp index see the same rows)."""
    r, n = mesh.dp_index(), mesh.dp_size()
    per = GLOBAL_B // n
    return {k: torch.from_numpy(v[r * per:(r + 1) * per]) for k, v in batch.items()}


def _visual() -> VisualFeatures:
    return VisualFeatures(tcfg.ResNetConfig(stage_sizes=(1, 1, 1, 1), num_filters=4,
                                            dtype="float32"))


def _adamw(model) -> optim.AdamW:
    return optim.AdamW(model, optim.linear_warmup_schedule(1e-3, 1, 100), eps=1e-4,
                       head_learning_rate=optim.linear_warmup_schedule(1e-2, 1, 100))


def whole_params(model) -> dict:
    return {k: v.numpy() for k, v in sharding.whole_state_dict(model).items()}


def replicated_params(model) -> dict:
    shards = sharding.shards_by_name(model)
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()
            if k not in shards}


def phase2_run(sd: dict, fused: bool, dropout: float = 0.0, steps: int = 3) -> dict:
    """The Phase-2 train step on this rank's rows, from the state dict `sd`."""
    model = FCMF(_cfg(fused, dropout))
    model.load_state_dict(sd, strict=True)
    mesh.replicate(model)
    sharding.shard_model_(model)
    state = TrainState.create(model, _visual(), _adamw(model))
    step = make_finetune_train_step(state)
    local = _local(phase2_batch())
    losses = [float(mesh.all_mean(step(local, 7)["loss"])) for _ in range(steps)]
    return {"losses": losses, "params": whole_params(model),
            "replicated": replicated_params(model)}


def _seq2seq(vocab_chunk: int):
    cfg = _cfg(False, vocab=P1_VOCAB)
    dec_cfg = tcfg.DecoderConfig(vocab_size=P1_VOCAB, hidden_size=32, num_blocks=1,
                                 num_heads=4, ffn_hidden=32, max_decode_len=T, dropout=0.0)
    model = FCMFSeq2Seq(cfg, dec_cfg)
    g = torch.Generator().manual_seed(3)
    init_weights(model, g, 0.2)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.2, generator=g)
    mesh.replicate(model)
    sharding.shard_model_(model)
    state = TrainState.create(model, _visual(), _adamw(model))
    return model, make_pretrain_train_step(state, vocab_chunk=vocab_chunk)


def phase1_run(vocab_chunk: int, steps: int = 3) -> dict:
    """The Phase-1 step, then greedy and beam-3 decodes of the trained model."""
    model, step = _seq2seq(vocab_chunk)
    local = _local(phase1_batch())
    losses, accs = [], []
    for _ in range(steps):
        metrics = step(local, 7)
        losses.append(float(mesh.all_mean(metrics["loss"])))
        accs.append(float(metrics["token_accuracy"]))
    model.eval()
    args = (local["enc_input_ids"], local["grid"], local["roi"], local["roi_coors"], 1, 2)
    kw = dict(attention_mask=local["attention_mask"], added_attention_mask=local["added_mask"])
    greedy = model.greedy_decode(*args, **kw)
    beam, _ = model.beam_decode(*args, beam_size=3, **kw)
    return {"losses": losses, "accuracy": accs, "params": whole_params(model),
            "greedy": greedy.numpy(), "beam": beam.numpy()}


def resume_run(work: str) -> dict:
    """(e) 2 steps from the mp 1 checkpoint `resume_from`, then save."""
    model = FCMF(_cfg(False))
    sharding.shard_model_(model)  # shapes of this rank; values from the file
    state = TrainState.create(model, _visual(), _adamw(model))
    ckpt = CheckpointManager(work)
    ckpt.restore("resume_from", state)
    step = make_finetune_train_step(state)
    local = _local(phase2_batch())
    losses = [float(mesh.all_mean(step(local, 7)["loss"])) for _ in range(2)]
    ckpt.save("saved_at_mp2", state, 2)
    mesh.barrier()
    return {"losses": losses, "step": state.step}


def driver_hook(cfg, rcfg):
    """The drivers' models at the test's width, dropout 0."""
    rcfg = dataclasses.replace(rcfg, num_filters=4)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **SMALL, **NO_DROPOUT),
        text=dataclasses.replace(cfg.text, **SMALL, **NO_DROPOUT),
        visual_feat_dim=4 * 32, box_heads=8)
    return cfg, rcfg


def pretrain_hook(cfg, dec_cfg, rcfg):
    cfg, rcfg = driver_hook(cfg, rcfg)
    dec_cfg = dataclasses.replace(dec_cfg, hidden_size=32, num_heads=4, ffn_hidden=32,
                                  num_blocks=1, dropout=0.0)
    return cfg, dec_cfg, rcfg


def _common_argv(data: str, out: str) -> list:
    return ["--image_dir", os.path.join(data, "images"), "--output_dir", out,
            "--pretrained_hf_model", os.path.join(data, "tok"), "--device", "cpu",
            "--resnet_stages", "1,1,1,1", "--num_imgs", "2", "--num_rois", "2", "--no-bf16",
            "--max_seq_length", "48", "--num_train_epochs", "2", "--log_every", "1",
            "--seed", "5", "--do_train", "--mp", str(mesh.mp_size())]


def finetune_run(data: str, out: str) -> dict:
    """`finetune.main` at the global batch of 4 (4 / dp a rank)."""
    batch = str(GLOBAL_B // mesh.dp_size())
    result = finetune.main(_common_argv(data, out) + [
        "--data_dir", os.path.join(data, "data"), "--train_batch_size", batch,
        "--eval_batch_size", batch, "--do_eval", "--do_test"], config_hook=driver_hook)
    return {"losses": [e["losses"] for e in result["epochs"]],
            "best_dev_f1": result["best_dev_f1"], "test": result["test"]}


def pretrain_run(data: str, out: str) -> dict:
    """`pretrain.main` with all 6 samples in the global batch."""
    batch = str(PRETRAIN_SAMPLES // mesh.dp_size())
    result = pretrain.main(_common_argv(data, out) + [
        "--pretrained_data_dir", os.path.join(data, "data"), "--max_len_decoder", "8",
        "--train_batch_size", batch, "--debug_decode_every", "1"], config_hook=pretrain_hook)
    return {"losses": [e["losses"] for e in result["epochs"]],
            "best_train_loss": result["best_train_loss"]}


def worker(rank: int, port: int, out: str, data: str, pdata: str) -> None:
    """One rank: the four-rank world, then (ranks 0 and 1) the world of two.
    Every check's numbers go to `out`."""
    import torch.distributed as dist
    got = {}
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=4)
    try:
        mesh.init_model_parallel(2)
        got["layout4"] = [mesh.dp_size(), mesh.dp_index(), mesh.mp_size(), mesh.mp_index()]
        sd = torch.load(os.path.join(out, "jax_init.pt"))
        got["b"] = phase2_run(sd, fused=True)
        got["finetune4"] = finetune_run(data, os.path.join(out, "finetune4"))
        got["pretrain4"] = pretrain_run(pdata, os.path.join(out, "pretrain4"))
    finally:
        dist.destroy_process_group()
    if rank < 2:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port + 1}", rank=rank,
                                world_size=2)
        try:
            mesh.init_model_parallel(2)
            got["layout2"] = [mesh.dp_size(), mesh.dp_index(), mesh.mp_size(), mesh.mp_index()]
            got["c"] = phase2_run(sd, fused=False, dropout=0.1)
            got["d"] = {chunk: phase1_run(chunk) for chunk in (0, 16)}
            got["e"] = resume_run(out)
            got["finetune2"] = finetune_run(data, os.path.join(out, "finetune2"))
            got["pretrain2"] = pretrain_run(pdata, os.path.join(out, "pretrain2"))
        finally:
            dist.destroy_process_group()
    torch.save(got, os.path.join(out, f"rank{rank}.pt"))


def _free_port() -> int:
    """A free port whose successor is free too (the world of two's)."""
    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port + 1))
                return port
            except OSError:
                continue


# ---------------------------------------------------------------------------
# the JAX side: initial parameters, the replicated run, the rule table
# ---------------------------------------------------------------------------

def _jax_cfg(jcfg, **kw):
    return jcfg.FCMFConfig(model=jcfg.ModelConfig(**MODEL, **NO_DROPOUT, **kw),
                           text=jcfg.TextEncoderConfig(vocab_size=VOCAB,
                                                       max_position_embeddings=64, **MODEL,
                                                       **NO_DROPOUT, **kw),
                           **FCMF_ARGS)


def _jax_fcmf():
    """(JAX FCMF, its randomized params, the batch as JAX arrays)."""
    import jax.numpy as jnp

    from macsa_tpu import config as jcfg
    from macsa_tpu.models.fcmf import FCMF as JFCMF
    from test_torch_port_models import jinit, randomize
    batch = phase2_batch()
    model = JFCMF(_jax_cfg(jcfg))
    params = randomize(jinit(model, batch["input_ids"][:1, 0], batch["grid"][:1],
                             batch["roi"][:1], batch["roi_coors"][:1], None,
                             batch["attention_mask"][:1, 0], batch["added_mask"][:1, 0]
                             )["params"], np.random.default_rng(4))
    return model, params, {k: jnp.asarray(v) for k, v in batch.items()}


def _jax_losses(model, params, jbatch, steps: int = 3) -> list:
    """JAX's replicated run: its train step and AdamW at the port's rates."""
    import jax

    from macsa_tpu.models.resnet import VisualFeatures as JVisual
    from macsa_tpu import config as jcfg
    from macsa_tpu.train import optim as joptim
    from macsa_tpu.train import steps as jsteps
    from macsa_tpu.train.state import TrainState as JTrainState
    tx = joptim.make_adamw(joptim.linear_warmup_schedule(1e-3, 1, 100), eps=1e-4,
                           head_learning_rate=joptim.linear_warmup_schedule(1e-2, 1, 100))
    visual = JVisual(jcfg.ResNetConfig(stage_sizes=(1, 1, 1, 1), num_filters=4))
    state = JTrainState.create(params, {}, tx)
    step = jsteps.make_finetune_train_step(model, visual, donate=False)
    losses = []
    for _ in range(steps):
        state, m = step(state, jbatch, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return losses


def _phase2_sd(params) -> dict:
    from macsa_tpu_torch.train import jax_import
    return jax_import.fcmf_state_dict_from_jax(params, 1)


@pytest.fixture(scope="module")
def jax_fcmf():
    return _jax_fcmf()


@pytest.fixture(scope="module")
def job(tmp_path_factory, jax_fcmf):
    """The JAX reference, the mp 1 checkpoint, and the ranks' results."""
    root = tmp_path_factory.mktemp("tp")
    out = root / "job"
    out.mkdir()
    data, pdata = str(root / "synth"), str(root / "synth_iaog")
    synth.write_dataset(data, n_train=GLOBAL_B, n_dev=5, n_test=4)
    synth.write_dataset(pdata, n_train=3, n_dev=4, n_test=4, seed=0)
    model, params, jbatch = jax_fcmf
    sd = _phase2_sd(params)
    torch.save(sd, out / "jax_init.pt")
    jax_losses = _jax_losses(model, params, jbatch)
    # (e): an mp 1 run whose checkpoint after 2 steps the ranks resume from
    resume = mp1_resume_reference(sd, str(out))
    port = _free_port()
    code = (f"import sys; sys.path.insert(0, {TESTS!r}); sys.path.insert(0, {REPO!r}); "
            "import test_torch_port_tp as t; "
            "t.worker(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port), str(out), data,
                               pdata], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env)
             for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(4)]
    return {"ranks": ranks, "sd": sd, "jax_losses": jax_losses, "resume": resume,
            "out": out, "data": data, "pdata": pdata}


def mp1_resume_reference(sd: dict, work: str) -> dict:
    """One process: 2 steps, the checkpoint `resume_from`, 2 more steps."""
    model = FCMF(_cfg(False))
    model.load_state_dict(sd, strict=True)
    state = TrainState.create(model, _visual(), _adamw(model))
    step = make_finetune_train_step(state)
    local = _local(phase2_batch())
    for _ in range(2):
        step(local, 7)
    ckpt = CheckpointManager(work)
    ckpt.save("resume_from", state, 1)
    losses = [float(step(local, 7)["loss"]) for _ in range(2)]
    return {"losses": losses, "params": {k: v.numpy().copy()
                                         for k, v in model.state_dict().items()}}


def _close_params(got: dict, want: dict, rel: float = 1e-5) -> None:
    assert set(got) == set(want)
    for name, value in want.items():
        scale = max(float(np.abs(value).max()), 1e-30)
        np.testing.assert_allclose(got[name], value, rtol=0, atol=rel * scale, err_msg=name)


# ---------------------------------------------------------------------------
# (a) the rule table
# ---------------------------------------------------------------------------

def _jax_kind(path, leaf) -> tuple:
    """JAX's spec of one leaf as the port's (kind, torch dim)."""
    import jax.tree_util as jtu

    from macsa_tpu.parallel.sharding import leaf_spec as jleaf_spec
    spec = jleaf_spec(tuple(jtu.DictKey(k) for k in path), leaf)
    axes = [i for i, a in enumerate(spec) if a == "mp"]
    if not axes:
        return sharding.REPLICATED, None
    (dim,) = axes
    if path[-1] in ("embedding", "shared_embedding"):
        return sharding.VOCAB, dim
    if path[-1] == "kernel":
        dim = 1 - dim  # flax [in, out] -> torch [out, in]
    return (sharding.COLUMN if dim == 0 else sharding.ROW), dim


def _leaf(params, path):
    for k in path:
        params = params[k]
    return np.asarray(params)


def test_leaf_spec_equals_jax_name_for_name(jax_fcmf):
    from macsa_tpu.models.seq2seq import FCMFSeq2Seq as JSeq2Seq
    from macsa_tpu_torch.train import jax_import
    from test_torch_port_models import jinit
    from test_torch_port_phase1_models import _configs, encoder_args, make_inputs

    _, params, _ = jax_fcmf
    port = FCMF(_cfg(True))
    paths = jax_import.fcmf_param_paths(params, 1)
    seen = {}
    for name, p in port.named_parameters(remove_duplicate=False):
        want = _jax_kind(paths[name], _leaf(params, paths[name]))
        assert sharding.leaf_spec(name, p) == want, name
        seen[want[0]] = seen.get(want[0], 0) + 1
    # per block: q, k, v, intermediate weight + bias; attention and MLP output
    # weights; 1 text layer + the 2 fusion blocks; one word table
    assert seen[sharding.COLUMN] == 3 * 8 and seen[sharding.ROW] == 3 * 2
    assert seen[sharding.VOCAB] == 1

    jconfig, jdec, tconfig, tdec = _configs()
    x = make_inputs(np.random.default_rng(0))
    sparams = jinit(JSeq2Seq(jconfig, jdec), x["enc_input_ids"], x["dec_input_ids"],
                    *encoder_args(x, np.asarray))["params"]
    s2s = FCMFSeq2Seq(tconfig, tdec)
    spaths = jax_import.seq2seq_param_paths(sparams, 2, 2)
    kinds = {}
    for name, p in s2s.named_parameters(remove_duplicate=False):
        want = _jax_kind(spaths[name], _leaf(sparams, spaths[name]))
        assert sharding.leaf_spec(name, p) == want, name
        kinds[name] = want
    assert all(kinds[n] == (sharding.VOCAB, 0) for n in
               ("decoder.embedding.weight", "decoder.dense.weight",
                "encoder.bert.cell.embeddings.word_embeddings.weight"))
    assert kinds["decoder.dense.bias"] == (sharding.REPLICATED, None)
    assert not [n for n, k in kinds.items() if n.startswith("decoder.blks")
                and k[0] != sharding.REPLICATED]


def test_shard_model_is_a_no_op_at_mp_1_and_mp_must_divide_the_world():
    model = init_weights(FCMF(_cfg(False)), torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert sharding.shard_model_(model) is model and not sharding.shards_by_name(model)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    mesh.init_model_parallel(1)
    assert (mesh.dp_size(), mesh.dp_index(), mesh.mp_size(), mesh.mp_index()) == (1, 0, 1, 0)
    assert mesh.dp_group() is None and mesh.mp_group() is None
    with pytest.raises(ValueError, match="--mp 2 does not divide the 1 processes"):
        mesh.init_model_parallel(2)


# ---------------------------------------------------------------------------
# the ranks against one process and against JAX
# ---------------------------------------------------------------------------

def test_ranks_sit_where_jax_make_mesh_puts_them(job):
    # np.asarray(devices).reshape(dp, mp): rank r at (r // mp, r % mp)
    assert [r["layout4"] for r in job["ranks"]] == [
        [2, 0, 2, 0], [2, 0, 2, 1], [2, 1, 2, 0], [2, 1, 2, 1]]
    assert [r["layout2"] for r in job["ranks"][:2]] == [[1, 0, 2, 0], [1, 0, 2, 1]]


def test_phase2_at_dp2_mp2_matches_jax_and_one_process(job):
    single = phase2_run(job["sd"], fused=True)
    assert single["losses"][-1] < single["losses"][0]
    np.testing.assert_allclose(single["losses"], job["jax_losses"], rtol=0, atol=5e-4)
    for rank in job["ranks"]:
        got = rank["b"]
        np.testing.assert_allclose(got["losses"], job["jax_losses"], rtol=0, atol=5e-4)
        np.testing.assert_allclose(got["losses"], single["losses"], rtol=0, atol=1e-5)
        _close_params(got["params"], single["params"])


def test_dropout_on_the_plain_path_at_mp2_matches_mp1(job):
    single = phase2_run(job["sd"], fused=False, dropout=0.1)
    r0, r1 = (r["c"] for r in job["ranks"][:2])
    for got in (r0, r1):
        np.testing.assert_allclose(got["losses"], single["losses"], rtol=0, atol=1e-5)
        _close_params(got["params"], single["params"])
    assert r0["replicated"].keys() == r1["replicated"].keys()
    for name, value in r0["replicated"].items():
        np.testing.assert_array_equal(value, r1["replicated"][name], err_msg=name)
    # dropout moved the run: the losses are not those of dropout 0
    assert not np.allclose(single["losses"], phase2_run(job["sd"], fused=False)["losses"])


@pytest.mark.parametrize("vocab_chunk", [0, 16])
def test_phase1_at_mp2_matches_mp1_and_decodes_the_same_tokens(job, vocab_chunk):
    single = phase1_run(vocab_chunk)
    for rank in job["ranks"][:2]:
        got = rank["d"][vocab_chunk]
        np.testing.assert_allclose(got["losses"], single["losses"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["accuracy"], single["accuracy"], rtol=0, atol=1e-6)
        _close_params(got["params"], single["params"])
        np.testing.assert_array_equal(got["greedy"], single["greedy"])
        np.testing.assert_array_equal(got["beam"], single["beam"])
    # update 0 takes rate 0 (the warmup), update 1 the base rate
    assert single["losses"][0] == single["losses"][1] != single["losses"][2]


def test_checkpoints_hold_whole_tensors_and_resume_across_mp(job):
    want = job["resume"]
    for rank in job["ranks"][:2]:
        np.testing.assert_allclose(rank["e"]["losses"], want["losses"], rtol=0, atol=1e-5)
        assert rank["e"]["step"] == 4
    out = job["out"]
    mp1 = torch.load(out / "resume_from.pt", weights_only=True)
    mp2 = torch.load(out / "saved_at_mp2.pt", weights_only=True)
    assert mp2["model"].keys() == mp1["model"].keys()
    assert {k: v.shape for k, v in mp2["model"].items()} == \
        {k: v.shape for k, v in mp1["model"].items()}
    moments = lambda sd: {i: {k: v.shape for k, v in s.items()}  # noqa: E731
                          for i, s in sd["optimizer"]["optimizer"]["state"].items()}
    assert moments(mp2) == moments(mp1)
    _close_params({k: v.numpy() for k, v in mp2["model"].items()}, want["params"])
    # and it loads, whole, in one process
    model = FCMF(_cfg(False))
    state = TrainState.create(model, _visual(), _adamw(model))
    CheckpointManager(str(out)).restore("saved_at_mp2", state)
    assert state.step == 4


def _check_driver_files(out, single, names) -> None:
    for name in names:
        assert (out / name).is_file(), name
    lines = (out / "metrics.jsonl").read_text().splitlines()
    want = (single / "metrics.jsonl").read_text().splitlines()
    assert [sorted(json.loads(x)) for x in lines] == [sorted(json.loads(x)) for x in want]
    assert not [n for n in os.listdir(out) if ".tmp" in n or "copy-tmp" in n]


@pytest.fixture(scope="module")
def single_finetune(job, tmp_path_factory):
    """`finetune.main` in one process at the global batch, and its directory."""
    out = tmp_path_factory.mktemp("single_finetune")
    return finetune_run(job["data"], str(out)), out


@pytest.fixture(scope="module")
def single_pretrain(job, tmp_path_factory):
    out = tmp_path_factory.mktemp("single_pretrain")
    return pretrain_run(job["pdata"], str(out)), out


@pytest.mark.parametrize("world", [4, 2])
def test_finetune_driver_under_mp2_matches_one_process(job, single_finetune, world):
    want, single = single_finetune
    for rank in job["ranks"][:world]:
        got = rank[f"finetune{world}"]
        np.testing.assert_allclose(np.asarray(got["losses"]), np.asarray(want["losses"]),
                                   rtol=0, atol=1e-4)
        assert got["test"] == want["test"] and got["best_dev_f1"] == want["best_dev_f1"]
    out = job["out"] / f"finetune{world}"
    _check_driver_files(out, single,
                        ("best.pt", "last.pt", "train.log", "test_results_fcmf.txt"))
    assert (out / "test_results_fcmf.txt").read_text() == \
        (single / "test_results_fcmf.txt").read_text()
    whole = torch.load(out / "last.pt", weights_only=True)["model"]
    one = torch.load(single / "last.pt", weights_only=True)["model"]
    assert {k: v.shape for k, v in whole.items()} == {k: v.shape for k, v in one.items()}


@pytest.mark.parametrize("world", [4, 2])
def test_pretrain_driver_under_mp2_matches_one_process(job, single_pretrain, world):
    want, single = single_pretrain
    for rank in job["ranks"][:world]:
        got = rank[f"pretrain{world}"]
        np.testing.assert_allclose(np.asarray(got["losses"]), np.asarray(want["losses"]),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(got["best_train_loss"], want["best_train_loss"],
                                   rtol=0, atol=1e-4)
    out = job["out"] / f"pretrain{world}"
    _check_driver_files(out, single, ("best.pt", "last.pt", "train.log"))
    log = (out / "train.log").read_text()
    assert log.count("[debug] src=") == (single / "train.log").read_text().count(
        "[debug] src=") > 0
