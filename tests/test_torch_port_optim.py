"""The port's optimizers against the JAX package's optax ones.

The parameters are a small FCMF classifier's, made in JAX and carried
across with `macsa_tpu_torch.train.jax_import`; rounds of random numpy
gradients go through the JAX `make_adamw` / `optax.MultiSteps` /
`bert_adam` and the port's `AdamW` / `BertAdam`, and the parameters are
compared after every round (atol 1e-6).  The port's decay and head groups
are held against the JAX masks, mapped to the port's names through
`jax_import.fcmf_param_paths`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from macsa_tpu import config as jcfg
from macsa_tpu.models.fcmf import FCMF as JFCMF
from macsa_tpu.train import optim as joptim
from macsa_tpu_torch import config as tcfg
from macsa_tpu_torch.models.fcmf import FCMF as TFCMF
from macsa_tpu_torch.train import jax_import, optim
from test_torch_port_models import jinit, randomize
from test_torch_port_slice import KW, L, MODEL_KW, TEXT_KW

ROUNDS = 4


def _leaves(tree, prefix=()):
    """{path: leaf} of a nested dict (optax's masked leaves included)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) \
        else fn(tree)


@pytest.fixture(scope="module")
def fcmf_params():
    rng = np.random.default_rng(7)
    model = JFCMF(jcfg.FCMFConfig(model=jcfg.ModelConfig(**MODEL_KW),
                                  text=jcfg.TextEncoderConfig(**TEXT_KW), **KW))
    ids = np.full((1, L), 5, np.int32)
    params = jinit(model, ids, np.zeros((1, 2, 4, 128), np.float32),
                   np.zeros((1, 2, 2, 128), np.float32), np.zeros((1, 2, 2, 4), np.float32),
                   None, np.ones_like(ids), np.ones((1, L + 4), np.int32))["params"]
    params = _tree_map(np.asarray, randomize(params, rng))
    grads = [_tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32), params)
             for _ in range(ROUNDS)]
    return params, grads


def _port(params):
    port = TFCMF(tcfg.FCMFConfig(model=tcfg.ModelConfig(**MODEL_KW),
                                 text=tcfg.TextEncoderConfig(**TEXT_KW), **KW))
    port.load_state_dict(jax_import.fcmf_state_dict_from_jax(params, 2), strict=True)
    return port


def _set_grads(port, grads):
    sd = jax_import.fcmf_state_dict_from_jax(grads, 2)
    for name, p in port.named_parameters():
        p.grad = sd[name].clone()


def _run_both(params, grads, tx, port, opt, jit=True):
    """Apply each round on both sides; compare the parameters after each.
    (`bert_adam`'s cosine schedule branches in Python: it runs eagerly.)"""
    def update(g, state, params):
        updates, state = tx.update(g, state, params)
        return optax.apply_updates(params, updates), state

    update = jax.jit(update) if jit else update

    state = tx.init(params)
    for g in grads:
        params, state = update(g, state, params)
        _set_grads(port, g)
        opt.step()
        opt.zero_grad()
        want = jax_import.fcmf_state_dict_from_jax(params, 2)
        for name, p in port.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)
    return params


def test_linear_warmup_schedule_matches_jax():
    want = joptim.linear_warmup_schedule(2e-3, 10, 110)
    got = optim.linear_warmup_schedule(2e-3, 10, 110)
    for step in (0, 1, 5, 9, 10, 11, 60, 109, 110, 200):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12)
    assert got(0) == 0.0  # the first update's rate


def test_decay_and_head_groups_match_jax_masks(fcmf_params):
    params, _ = fcmf_params
    paths = jax_import.fcmf_param_paths(params, 2)
    port = _port(params)
    assert set(paths) == {n for n, _ in port.named_parameters()}
    decay = _leaves(joptim._decay_mask(params))
    tx = joptim.make_adamw(1e-3, head_learning_rate=1e-2)
    head_mu = _leaves(tx.init(params)[1].inner_states["head"].inner_state[0].mu)
    want_decay = {n for n, path in paths.items() if decay[path]}
    want_head = {n for n, path in paths.items() if not isinstance(head_mu[path],
                                                                  optax.MaskedNode)}
    assert want_head and want_decay and want_head != set(paths)

    opt = optim.AdamW(port.named_parameters(), 1e-3, head_learning_rate=1e-2)
    names = {id(p): n for n, p in port.named_parameters()}
    got_decay, got_head = set(), set()
    for group in opt.optimizer.param_groups:
        group_names = {names[id(p)] for p in group["params"]}
        if group["weight_decay"] > 0:
            got_decay |= group_names
        if group["part"] == "head":
            got_head |= group_names
    assert got_decay == want_decay
    assert got_head == want_head


def test_adamw_matches_optax(fcmf_params):
    """Dual LR with warmup, decay mask, clipping active (the random
    gradients' global norm is far above 1).  The rates are of the order
    of `finetune.py`'s defaults: optax takes Adam's bias correction
    1 - 0.999^t in f32 (1.3e-5 off on the first update), torch in double,
    which at a rate of 0.1 alone would move parameters by ~1e-6."""
    params, grads = fcmf_params
    enc = dict(base_lr=1e-3, warmup_steps=2, total_steps=10)
    head = dict(base_lr=1e-2, warmup_steps=2, total_steps=10)
    tx = joptim.make_adamw(joptim.linear_warmup_schedule(**enc), weight_decay=0.1,
                           head_learning_rate=joptim.linear_warmup_schedule(**head))
    port = _port(params)
    opt = optim.AdamW(port.named_parameters(), optim.linear_warmup_schedule(**enc),
                      weight_decay=0.1, head_learning_rate=optim.linear_warmup_schedule(**head))
    after = _run_both(params, grads, tx, port, opt)
    assert opt.updates == ROUNDS
    moved = jnp.abs(after["classifier"]["kernel"] - params["classifier"]["kernel"]).max()
    assert float(moved) > 1e-3


def test_adamw_accumulation_matches_optax_multisteps(fcmf_params):
    params, grads = fcmf_params
    sched = dict(base_lr=1e-2, warmup_steps=1, total_steps=10)
    tx = joptim.make_adamw(joptim.linear_warmup_schedule(**sched),
                           head_learning_rate=3e-2, accumulate_steps=2)
    port = _port(params)
    opt = optim.AdamW(port.named_parameters(), optim.linear_warmup_schedule(**sched),
                      head_learning_rate=3e-2, accumulate_steps=2)
    _run_both(params, grads, tx, port, opt)
    assert opt.updates == ROUNDS // 2  # the schedule counts updates, not micro-steps


@pytest.mark.parametrize("schedule", sorted(optim.SCHEDULES))
def test_bert_adam_matches_jax(fcmf_params, schedule):
    params, grads = fcmf_params
    kw = dict(lr=1e-2, warmup=0.3, t_total=5, schedule=schedule)
    port = _port(params)
    opt = optim.BertAdam(port.parameters(), **kw)
    _run_both(params, grads, joptim.bert_adam(**kw), port, opt, jit=False)


def test_bert_adam_schedules_match_jax():
    for name, fn in optim.SCHEDULES.items():
        for x in (0.0, 0.05, 0.1, 0.5, 0.75):
            np.testing.assert_allclose(fn(x, 0.1), float(joptim.SCHEDULES[name](jnp.asarray(x),
                                                                                 0.1)),
                                       rtol=1e-6, atol=1e-7, err_msg=name)


def test_optimizers_update_parameters_without_gradients(fcmf_params):
    """A parameter that got no gradient (the text encoder's unused pooler)
    still decays, as optax updates every leaf with a zero gradient."""
    params, _ = fcmf_params
    port = _port(params)
    pooler = port.encoder.bert.cell.pooler.dense.weight
    before = pooler.detach().clone()
    opt = optim.AdamW(port.named_parameters(), 1e-2, weight_decay=0.5)
    port.classifier.weight.grad = torch.ones_like(port.classifier.weight)
    opt.step()
    assert torch.allclose(pooler.detach(), before * (1 - 1e-2 * 0.5), rtol=0, atol=1e-7)
