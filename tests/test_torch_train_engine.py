"""The port's ``TrainEngine`` (``distributed_training_pytorch_tpu_torch/train/engine.py``)
with ``make_fused_lm_loss`` and AdamW, held step by step against the JAX package's
``TrainEngine`` with its ``make_fused_lm_loss`` and ``optax.adamw`` on a one-device CPU
mesh, from the same LMTiny weights (``models/convert.py::params_from_jax``) and batches.

Tolerances, f32: per-step loss atol 1e-5 and params after 3 steps atol 1e-5. The two run
the same f32 arithmetic in other summation orders. One block of params is held apart: the
key part of each ``qkv`` bias. Its gradient is 0 in exact arithmetic (a bias on every key
adds the same q.b to all of a query's logits, which the softmax ignores), so each
framework's gradient there is float noise (about 4e-10) and Adam, which divides a gradient
by its own running magnitude, turns that noise into steps of a few percent of the learning
rate, different on each side. That block is held to twice the summed learning rates (the
most Adam can move a param apart), and its gradient is checked to be noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_training_pytorch_tpu.models import transformer_lm as jax_lm
from distributed_training_pytorch_tpu.parallel import mesh as jax_mesh
from distributed_training_pytorch_tpu.train import TrainEngine as JaxTrainEngine
from distributed_training_pytorch_tpu_torch.models import LMTiny, params_from_jax
from distributed_training_pytorch_tpu_torch.models.transformer_lm import make_fused_lm_loss
from distributed_training_pytorch_tpu_torch.ops.schedules import warmup_cosine_lr
from distributed_training_pytorch_tpu_torch.train import TrainEngine, TrainState

SEQ, BATCH, LR = 40, 8, 1e-3


def _schedules():
    # warmup of 1 step (lr 0 at step 0), then cosine over the rest: 3 steps see 3 lrs
    return (
        optax.warmup_cosine_decay_schedule(0.0, LR, 1, 6, 0.0),
        warmup_cosine_lr(LR, total_epochs=1, steps_per_epoch=6, warmup_epochs=0),
    )


def _batches(n, seed=0, rows=BATCH):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        w = rng.randint(0, 256, size=(rows, SEQ + 1)).astype(np.int32)
        out.append({"image": w[:, :-1], "label": w[:, 1:]})
    return out


@pytest.fixture(scope="module")
def jax_init():
    model = jax_lm.LMTiny(vocab_size=256)
    params = model.init(jax.random.key(0), jnp.zeros((1, SEQ), jnp.int32))["params"]
    return model, params


def _port_engine(params, *, accum_steps=1, nan_guard=False, loss_wrap=None):
    model = LMTiny(device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    _, schedule = _schedules()
    opt = torch.optim.AdamW(model.parameters(), lr=schedule(0), betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)
    loss_fn = make_fused_lm_loss(model)
    if loss_wrap is not None:
        loss_fn = loss_wrap(loss_fn)
    engine = TrainEngine(loss_fn, accum_steps=accum_steps, schedule=schedule, nan_guard=nan_guard)
    return engine, TrainState(model=model, optimizer=opt)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_params_close(got, ref, atol, key_bias_atol):
    """``got``/``ref`` state dicts within ``atol``, except each qkv bias's key block (see
    the module docstring), held to ``key_bias_atol``."""
    for name, value in ref.items():
        a, b = got[name].numpy(), value.numpy()
        if name.endswith("qkv.bias"):
            d = a.shape[0] // 3
            np.testing.assert_allclose(a[d : 2 * d], b[d : 2 * d], atol=key_bias_atol, err_msg=name)
            a, b = np.concatenate([a[:d], a[2 * d :]]), np.concatenate([b[:d], b[2 * d :]])
        np.testing.assert_allclose(a, b, atol=atol, err_msg=name)


def test_three_steps_match_the_jax_engine(jax_init):
    jax_model, params = jax_init
    schedule, _ = _schedules()
    mesh = jax_mesh.create_mesh(devices=jax.devices()[:1])
    engine = JaxTrainEngine(
        jax_lm.make_fused_lm_loss(jax_model),
        optax.adamw(schedule, weight_decay=0.1, b1=0.9, b2=0.95),
        mesh,
        schedule=schedule,
    )
    state = engine.init_state(jax.random.key(1), lambda rng: {"params": params})
    port_engine, port_state = _port_engine(params)
    for i, batch in enumerate(_batches(3)):
        state, metrics = engine.train_step(state, engine.shard_batch(batch))
        port_state, port_metrics = port_engine.train_step(port_state, _torch_batch(batch))
        np.testing.assert_allclose(float(port_metrics["loss"]), float(metrics["loss"]), atol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(float(port_metrics["lr"]), float(metrics["lr"]), rtol=1e-6)
        assert set(port_metrics) >= {"loss", "nll", "ppl", "lr"}
    assert port_state.step == int(state.step) == 3
    ref = params_from_jax(jax.tree.map(np.asarray, state.params))
    summed_lr = sum(_schedules()[1](i) for i in range(3))
    _assert_params_close(port_state.model.state_dict(), ref, 1e-5, 2 * summed_lr)
    port_state.optimizer.zero_grad()
    loss, _ = port_engine.loss_fn(port_state.model, _torch_batch(_batches(1)[0]), True)
    loss.backward()
    for block in port_state.model.blocks:
        d = block.qkv.bias.shape[0] // 3
        assert block.qkv.bias.grad[d : 2 * d].abs().max().item() < 1e-8


def test_accumulated_step_equals_full_batch_step(jax_init):
    _, params = jax_init
    batches = _batches(2, seed=3)
    full_engine, full = _port_engine(params)
    accum_engine, accum = _port_engine(params, accum_steps=4)
    for batch in batches:
        _, m_full = full_engine.train_step(full, _torch_batch(batch))
        _, m_acc = accum_engine.train_step(accum, _torch_batch(batch))
        np.testing.assert_allclose(float(m_acc["loss"]), float(m_full["loss"]), atol=1e-6)
    summed_lr = sum(_schedules()[1](i) for i in range(2))
    _assert_params_close(accum.model.state_dict(), full.model.state_dict(), 1e-6, 2 * summed_lr)
    with pytest.raises(ValueError, match="micro-batches"):
        accum_engine.train_step(accum, _torch_batch(_batches(1, rows=6)[0]))


def test_nan_guard_skips_the_update(jax_init):
    _, params = jax_init
    poison = {"on": False}

    def wrap(loss_fn):
        def poisoned(model, batch, train):
            loss, metrics = loss_fn(model, batch, train)
            return (loss * float("nan"), metrics) if poison["on"] else (loss, metrics)

        return poisoned

    engine, state = _port_engine(params, nan_guard=True, loss_wrap=wrap)
    batches = _batches(3, seed=4)
    for batch in batches[:2]:
        state, metrics = engine.train_step(state, _torch_batch(batch))
        assert float(metrics["nonfinite"]) == 0.0
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt_before = {k: v.clone() for k, v in state.optimizer.state[next(state.model.parameters())].items()}
    poison["on"] = True
    state, metrics = engine.train_step(state, _torch_batch(batches[2]))
    assert float(metrics["nonfinite"]) == 1.0
    assert state.step == 3  # the step still advances
    for name, value in state.model.state_dict().items():
        assert torch.equal(value, before[name]), name
    for k, v in state.optimizer.state[next(state.model.parameters())].items():
        assert torch.equal(v, opt_before[k]), k


def test_eval_step_matches_the_jax_engine(jax_init):
    jax_model, params = jax_init
    mesh = jax_mesh.create_mesh(devices=jax.devices()[:1])
    engine = JaxTrainEngine(jax_lm.make_fused_lm_loss(jax_model), optax.adamw(1e-3), mesh)
    state = engine.init_state(jax.random.key(1), lambda rng: {"params": params})
    batch = dict(_batches(1, seed=5)[0], mask=np.array([1, 1, 1, 0, 1, 0, 0, 1], np.float32))
    ref = engine.eval_step(state, engine.shard_batch(batch))
    port_engine, port_state = _port_engine(params)
    got = port_engine.eval_step(port_state, _torch_batch(batch))
    for key in ("loss", "nll", "ppl"):
        np.testing.assert_allclose(float(got[key]), float(ref[key]), rtol=1e-5, err_msg=key)

