"""The port's losses (``distributed_training_pytorch_tpu_torch/ops/losses.py``) and
learning-rate schedules (``ops/schedules.py``) held against the JAX package's.

Inputs come from numpy with a seed and cross between the frameworks as numpy arrays.
Tolerances, f32: losses atol 1e-5 and gradients atol 1e-6 (the same f32 arithmetic in
other summation orders over at most 300 logits); schedules rtol 1e-6 (optax computes in
f32, the port in Python floats).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_training_pytorch_tpu.ops import losses as jax_losses
from distributed_training_pytorch_tpu.ops import schedules as jax_schedules
from distributed_training_pytorch_tpu_torch.ops import losses, schedules


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("vocab,chunk_size", [(256, 8192), (256, 128), (300, 128), (300, 8192)])
def test_tied_cross_entropy_values_and_grads_match_jax(vocab, chunk_size):
    rng = np.random.RandomState(vocab + chunk_size)
    hidden = rng.randn(2, 7, 16).astype(np.float32)
    emb = (0.5 * rng.randn(vocab, 16)).astype(np.float32)
    targets = rng.randint(0, vocab, size=(2, 7)).astype(np.int32)
    weights = rng.rand(2, 7).astype(np.float32)

    def jax_loss(h, e):
        return jnp.sum(jax_losses.tied_cross_entropy(h, e, jnp.asarray(targets), chunk_size=chunk_size) * weights)

    nll_jax = jax_losses.tied_cross_entropy(
        jnp.asarray(hidden), jnp.asarray(emb), jnp.asarray(targets), chunk_size=chunk_size
    )
    gh_jax, ge_jax = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(emb))

    h, e = _t(hidden).requires_grad_(), _t(emb).requires_grad_()
    nll = losses.tied_cross_entropy(h, e, _t(targets), chunk_size=chunk_size)
    (nll * _t(weights)).sum().backward()
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(nll_jax), atol=1e-5)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(gh_jax), atol=1e-6)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ge_jax), atol=1e-6)
    # The chunked loss is the plain CE of the full f32 logits.
    full = losses.softmax_cross_entropy_with_integer_labels(_t(hidden) @ _t(emb).T, _t(targets))
    np.testing.assert_allclose(nll.detach().numpy(), full.numpy(), atol=1e-5)


def test_tied_cross_entropy_rejects_mismatched_targets():
    with pytest.raises(ValueError, match="targets"):
        losses.tied_cross_entropy(torch.zeros(2, 3, 4), torch.zeros(10, 4), torch.zeros(2, 4, dtype=torch.long))


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss_matches_jax(label_smoothing, masked):
    rng = np.random.RandomState(3)
    logits = (3 * rng.randn(6, 11)).astype(np.float32)
    labels = rng.randint(0, 11, size=(6,)).astype(np.int32)
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32) if masked else None
    ref = jax_losses.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels), label_smoothing=label_smoothing,
        weights=None if mask is None else jnp.asarray(mask),
    )
    out = losses.cross_entropy_loss(
        _t(logits), _t(labels), label_smoothing=label_smoothing, weights=None if mask is None else _t(mask)
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize(
    "weights",
    [None, np.array([1, 0, 1, 0], np.float32), np.zeros(4, np.float32), np.array([0.5, 0.25, 1, 0], np.float32)],
)
def test_weighted_mean_matches_jax(weights):
    values = np.array([1.5, -2.0, 3.25, 8.0], np.float32)
    ref = jax_losses.weighted_mean(jnp.asarray(values), None if weights is None else jnp.asarray(weights))
    out = losses.weighted_mean(_t(values), None if weights is None else _t(weights))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    assert np.isfinite(out.numpy())


@pytest.mark.parametrize(
    "base_lr,epochs,steps_per_epoch,warmup_epochs,end_lr",
    [(3e-4, 3, 7, 1, 0.0), (1e-3, 2, 5, 5, 1e-5), (0.1, 1, 1, 1, 0.0), (2e-3, 4, 3, 0, 2e-4)],
)
def test_warmup_cosine_matches_optax_at_every_step(base_lr, epochs, steps_per_epoch, warmup_epochs, end_lr):
    ref = jax_schedules.warmup_cosine_lr(base_lr, epochs, steps_per_epoch, warmup_epochs, end_lr)
    port = schedules.warmup_cosine_lr(base_lr, epochs, steps_per_epoch, warmup_epochs, end_lr)
    for step in range(epochs * steps_per_epoch + 3):
        np.testing.assert_allclose(port(step), float(ref(step)), rtol=1e-6, atol=1e-12, err_msg=f"step {step}")


@pytest.mark.parametrize("milestones,gamma,steps_per_epoch", [((1, 3), 0.1, 4), ((2,), 0.5, 1), ((), 0.1, 3)])
def test_multistep_matches_optax_at_every_step(milestones, gamma, steps_per_epoch):
    ref = jax_schedules.multistep_lr(0.1, milestones, gamma, steps_per_epoch)
    port = schedules.multistep_lr(0.1, milestones, gamma, steps_per_epoch)
    for step in range(20):
        np.testing.assert_allclose(port(step), float(ref(step)), rtol=1e-6, err_msg=f"step {step}")


def test_adamw_update_matches_optax():
    """The torch optimizer the LM entry builds is optax.adamw's update: one step of each
    on the same params and grads, with the learning rate set per step as the engine does."""
    rng = np.random.RandomState(5)
    p0 = rng.randn(4, 3).astype(np.float32)
    grads = [rng.randn(4, 3).astype(np.float32) for _ in range(3)]
    lrs = [1e-3, 5e-4, 2e-3]
    tx = optax.adamw(lambda count: jnp.asarray(lrs)[count], weight_decay=0.1, b1=0.9, b2=0.95)
    params = jnp.asarray(p0)
    opt_state = tx.init(params)
    p = torch.nn.Parameter(_t(p0.copy()))
    opt = torch.optim.AdamW([p], lr=lrs[0], betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)
    for g, lr in zip(grads, lrs, strict=True):
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = optax.apply_updates(params, updates)
        opt.param_groups[0]["lr"] = lr
        p.grad = _t(g)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), atol=1e-6)
