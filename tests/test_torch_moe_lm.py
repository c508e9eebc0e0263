"""The port's Mixture-of-Experts LM (``models/transformer_lm.py`` with ``moe_every=2``)
held against the JAX package's on the same weights, carried over by
``models/convert.py::params_from_jax``.

One module-scoped JAX reference (an ``LMTiny`` with ``moe_every=2``, ``num_experts=4``,
plain attention, f32): its hidden states and logits, ``make_fused_lm_loss``'s loss with
its ``moe_load_balance`` and ``moe_router_z``, one ``TrainEngine`` step with
``optax.adamw``, and greedy ``generate`` (the capacity-free decode). Then the entries:
``FUSED_CE=0`` with MoE logs the JAX warning and keeps the fused loss; ``train_lm.py``
trains an MoE LMTiny for an epoch with the MoE metrics in its record, its telemetry's
``epoch_end`` and its TensorBoard scalars, and ``eval_lm.py``
evaluates and samples its checkpoint; ``utils/flops.py`` counts the MoE step's products
(the dispatch and combine einsums with the experts'), and the memory preflight traces it.

Tolerances, f32: hidden states and logits 1e-4; the loss and both metrics 1e-5 relative;
the params after one AdamW step 1e-5, except each qkv bias's key block, whose gradient is
float noise that Adam scales to a few percent of the learning rate
(``tests/test_torch_train_engine.py``), held to twice the learning rate; greedy tokens
equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_training_pytorch_tpu.models import transformer_lm as jax_lm
from distributed_training_pytorch_tpu.parallel import mesh as jax_mesh
from distributed_training_pytorch_tpu.train import TrainEngine as JaxTrainEngine
from distributed_training_pytorch_tpu_torch.examples import eval_lm, train_lm
from distributed_training_pytorch_tpu_torch.memory import Preflight
from distributed_training_pytorch_tpu_torch.models import LMTiny, params_from_jax
from distributed_training_pytorch_tpu_torch.models.transformer_lm import generate, make_fused_lm_loss
from distributed_training_pytorch_tpu_torch.parallel import moe
from distributed_training_pytorch_tpu_torch.telemetry.events import load_run_events
from distributed_training_pytorch_tpu_torch.train import TrainEngine, TrainState
from distributed_training_pytorch_tpu_torch.utils.flops import step_flops
from distributed_training_pytorch_tpu_torch.utils.tensorboard import read_scalars

VOCAB, MAX_LEN, E = 64, 48, 4
B, T, LR = 4, 24, 1e-3
KW = dict(moe_every=2, num_experts=E)


def _batch(seed=0):
    w = np.random.RandomState(seed).randint(0, VOCAB, size=(B, T + 1)).astype(np.int32)
    return {"image": w[:, :-1], "label": w[:, 1:]}


@pytest.fixture(scope="module")
def ref():
    model = jax_lm.LMTiny(vocab_size=VOCAB, max_len=MAX_LEN, attention_impl="plain", **KW)
    params = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    batch = _batch()
    x = jnp.asarray(batch["image"])
    apply = jax.jit(lambda p, toks, hidden: model.apply({"params": p}, toks, return_hidden=hidden), static_argnums=2)
    loss_fn = jax_lm.make_fused_lm_loss(model)
    loss, (metrics, _) = jax.jit(lambda p, b: loss_fn(p, {}, b, None, False))(params, batch)
    mesh = jax_mesh.create_mesh(devices=jax.devices()[:1])
    engine = JaxTrainEngine(loss_fn, optax.adamw(LR, weight_decay=0.1, b1=0.9, b2=0.95), mesh)
    state = engine.init_state(jax.random.key(1), lambda rng: {"params": params})
    state, step_metrics = engine.train_step(state, engine.shard_batch(batch))
    prompt = jnp.asarray(np.random.RandomState(2).randint(0, VOCAB, size=(2, 5)).astype(np.int32))
    tokens = jax_lm.generate(model, {"params": params}, prompt, 12, jax.random.key(3))
    as_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return {"params": as_np(params), "batch": batch, "hidden": np.asarray(apply(params, x, True)),
            "logits": np.asarray(apply(params, x, False)), "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()}, "after": as_np(state.params),
            "step_loss": float(step_metrics["loss"]), "prompt": np.asarray(prompt), "tokens": np.asarray(tokens)}


def _port(ref):
    model = LMTiny(vocab_size=VOCAB, max_len=MAX_LEN, device="cpu", **KW)
    model.load_state_dict(params_from_jax(ref["params"]))
    return model


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_hidden_states_and_logits_match_jax(ref):
    model = _port(ref)
    assert [b.use_moe for b in model.blocks] == [False, True]
    with torch.no_grad():
        hidden, aux = model(torch.from_numpy(ref["batch"]["image"]), return_hidden=True, return_aux=True)
        logits = model(torch.from_numpy(ref["batch"]["image"]))
    assert len(aux) == 1 and set(aux[0]) == {"load_balance_loss", "router_z_loss"}
    np.testing.assert_allclose(hidden.numpy(), ref["hidden"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=1e-4, rtol=0)


def test_fused_loss_and_moe_metrics_match_jax(ref):
    model = _port(ref)
    with torch.no_grad():
        loss, metrics = make_fused_lm_loss(model)(model, _torch_batch(ref["batch"]), False)
    assert set(metrics) == set(ref["metrics"]) == {"loss", "nll", "ppl", "moe_load_balance", "moe_router_z"}
    assert float(loss) == pytest.approx(ref["loss"], rel=1e-5)
    for name, want in ref["metrics"].items():
        assert float(metrics[name]) == pytest.approx(want, rel=1e-5), name
    assert float(metrics["loss"]) > float(metrics["nll"])  # the auxiliary losses are in the objective


def test_one_engine_step_matches_jax_grad_and_adamw(ref):
    model = _port(ref)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)
    engine = TrainEngine(make_fused_lm_loss(model), schedule=lambda step: LR)
    state, metrics = engine.train_step(TrainState(model=model, optimizer=opt), _torch_batch(ref["batch"]))
    assert float(metrics["loss"]) == pytest.approx(ref["step_loss"], rel=1e-5)
    want = params_from_jax(ref["after"])
    for name, value in want.items():
        got, exp = state.model.state_dict()[name].numpy(), value.numpy()
        if name.endswith("qkv.bias"):
            d = got.shape[0] // 3
            np.testing.assert_allclose(got[d : 2 * d], exp[d : 2 * d], atol=2 * LR, err_msg=name)
            got, exp = np.concatenate([got[:d], got[2 * d :]]), np.concatenate([exp[:d], exp[2 * d :]])
        np.testing.assert_allclose(got, exp, atol=1e-5, rtol=0, err_msg=name)


def test_greedy_generate_equals_jax(ref):
    model = _port(ref)
    got = generate(model, torch.tensor(ref["prompt"]), 12)
    np.testing.assert_array_equal(got.numpy(), ref["tokens"])


def _moe_block_flops(s, d, h, e, capacity):
    """One MoE block's products in a train step, as the einsum route runs them: the
    forward's router, dispatch, two expert and combine products, and their backward (two
    products each; one for the dispatch, whose one-hot needs no gradient)."""
    router, dispatch = 2 * s * d * e, 2 * e * capacity * s * d
    experts, combine = 2 * 2 * e * capacity * d * h, 2 * s * e * capacity * d
    return 3 * router + 2 * dispatch + 3 * experts + 3 * combine


def test_flop_count_includes_dispatch_and_combine(ref):
    batch = _torch_batch(ref["batch"])
    moe_model = _port(ref)
    dense = LMTiny(vocab_size=VOCAB, max_len=MAX_LEN, device="cpu")
    got = step_flops(moe_model, make_fused_lm_loss(moe_model), batch)
    base = step_flops(dense, make_fused_lm_loss(dense), batch)
    s, d, h = B * T, 32, 64
    capacity = moe.capacity_for(s, E, 2, 1.25)
    dense_mlp = 3 * 2 * 2 * s * d * h  # the dense block's two products, forward and backward
    assert got - base == _moe_block_flops(s, d, h, E, capacity) - dense_mlp


@pytest.fixture
def lm_corpus(tmp_path, monkeypatch):
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(bytes(np.random.RandomState(4).randint(32, 127, size=4000).astype(np.uint8)))
    monkeypatch.setenv("LM_CORPUS", str(corpus))
    monkeypatch.setenv("DTYPE", "fp32")
    monkeypatch.delenv("PALLAS", raising=False)
    return str(corpus)


class _Recorded(train_lm.LMTrainer):
    def __init__(self, **kw):
        self.record = {"train": [], "val": []}
        super().__init__(**kw)

    def train_epoch(self, epoch):
        self.record["train"].append(super().train_epoch(epoch))
        return self.record["train"][-1]

    def validate(self):
        self.record["val"].append(super().validate())
        return self.record["val"][-1]


def _lm_trainer(tmp_path, **kw):
    return _Recorded(seq_len=16, base_lr=1e-3, size="tiny", moe_every=2, max_epoch=1, batch_size=16,
                              save_folder=str(tmp_path / "run"), device="cpu", async_checkpoint=False, **kw)


def test_fused_ce_off_warns_and_keeps_the_fused_loss(lm_corpus, tmp_path, monkeypatch):
    monkeypatch.setenv("FUSED_CE", "0")
    logged = []

    class Logger:
        def log(self, msg, log_type="info"):
            logged.append((log_type, msg))

    trainer = _lm_trainer(tmp_path, logger=Logger())
    assert ("warning", "FUSED_CE=0 ignored: MoE models need the fused loss (router aux losses ride it)") in logged
    batch = next(iter(trainer.device_batches(trainer.train_dataloader)))
    _, metrics = trainer.engine.loss_fn(trainer.model, batch, True)
    assert {"moe_load_balance", "moe_router_z"} <= set(metrics)


def test_moe_trains_through_train_lm_and_evaluates_through_eval_lm(lm_corpus, tmp_path):
    trainer = _lm_trainer(tmp_path, have_validate=True, save_best_for=("nll", "leq"), save_period=1,
                          preflight=Preflight(capacity_bytes=1 << 50), telemetry=True,
                          tensorboard_dir=str(tmp_path / "tb"))
    assert sum(isinstance(m, moe.MoEMlp) for m in trainer.model.modules()) == 1
    trainer.train()
    assert trainer.memory_report is not None and trainer.memory_report.predicted_peak_bytes > 0
    train = trainer.record["train"][0]
    assert np.isfinite(train["loss"]) and {"moe_load_balance", "moe_router_z"} <= set(train)
    assert {"moe_load_balance", "moe_router_z"} <= set(trainer.record["val"][0])
    ends = [e for e in load_run_events(str(tmp_path / "run")) if e.get("event") == "epoch_end"]  # telemetry
    assert len(ends) == 1 and {"moe_load_balance", "moe_router_z"} <= set(ends[0])
    (tb_file,) = [os.path.join(tmp_path / "tb", f) for f in os.listdir(tmp_path / "tb")]
    assert {"train/moe_load_balance", "train/moe_router_z"} <= set(read_scalars(tb_file))
    ckpt = str(tmp_path / "run" / "weights" / "last")
    loaded = eval_lm.load_params(ckpt, "tiny", 16, moe_every=2, device="cpu")
    result = eval_lm.evaluate(ckpt, lm_corpus, size="tiny", seq_len=16, batch=32, moe_every=2, loaded=loaded)
    assert np.isfinite(result["nll"]) and result["n_windows"] > 0
    texts = eval_lm.sample(ckpt, b"the ", size="tiny", seq_len=16, gen_steps=8, temperature=0.8, moe_every=2,
                           loaded=loaded)
    assert all(len(t) == 12 for t in texts.values())


def test_inference_engine_serves_and_swaps_an_moe_lm(ref):
    """``InferEngine`` serves the MoE forward with capacity routing over the padded
    bucket, as the JAX engine's ``apply`` does: the answers are the eager forward's on the
    same bucket; a swap installs other weights of the same tree."""
    from distributed_training_pytorch_tpu_torch.serving import InferEngine

    model = _port(ref).eval()
    engine = InferEngine(lambda p, x: torch.func.functional_call(model, p, (x,)), device="cpu", buckets=(4,))
    engine.swap_params(model.state_dict(), version="v1")
    rows = ref["batch"]["image"][:3]
    got, version = engine.predict(rows)
    padded = np.concatenate([rows, rows[-1:]])  # the bucket of 4, the last row repeated
    with torch.no_grad():
        want = model(torch.tensor(padded))[:3].numpy()
    assert version == "v1"
    np.testing.assert_array_equal(got, want)
    other = {k: v * 0.5 if k.endswith("w_in") else v for k, v in model.state_dict().items()}
    engine.swap_params(other, version="v2")
    moved, version = engine.predict(rows)
    assert version == "v2" and not np.array_equal(moved, got)
