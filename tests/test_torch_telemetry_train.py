"""The telemetry that rides the port's training step, against the JAX engine, on the CPU.

* ``TrainEngine(stats=True)``: after one step of LMTiny on converted weights (f32, AdamW,
  the fused LM loss), ``grad_norm``, ``param_norm`` and ``update_ratio`` within 1e-5
  (relative) of the JAX ``TrainEngine(stats=True)``'s, and the loss as without stats;
* the FLOP probe (``utils/flops.py``, the meta device) against the JAX step's
  ``hlo_flops.executed_matmul_flops`` (plain attention) for LMTiny and a narrow VGG16,
  within 2 %. LMTiny's counts are equal (22,020,096). VGG16's differs by 1.4 %, in the
  convolutions (32,292,864 counted here against XLA's 31,801,344: XLA lowers some of the
  small-map convolutions of the last stages differently; the dots agree within the
  adaptive pool's backward, which XLA writes as two small dots);
* stats on leave the params bit-equal to stats off, single steps and chained windows (the
  loop form on the CPU), under the non-finite guard too;
* the goodput counters ride a SIGTERM's mid-epoch save and come back bit-identical in the
  resumed trainer, which then books its restore to ``restart_rollback``; ``meta.json``
  carries the attempt id.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from distributed_training_pytorch_tpu.models import transformer_lm as jax_lm
from distributed_training_pytorch_tpu.models import vgg as jax_vgg
from distributed_training_pytorch_tpu.ops.losses import cross_entropy_loss as jax_ce
from distributed_training_pytorch_tpu.parallel import mesh as jax_mesh
from distributed_training_pytorch_tpu.train import TrainEngine as JaxTrainEngine
from distributed_training_pytorch_tpu.train import make_supervised_loss
from distributed_training_pytorch_tpu.utils import hlo_flops
from distributed_training_pytorch_tpu_torch.data import ArrayDataSource
from distributed_training_pytorch_tpu_torch.fault import FaultPlan
from distributed_training_pytorch_tpu_torch.models import VGG16, LMTiny, params_from_jax
from distributed_training_pytorch_tpu_torch.models.transformer_lm import make_fused_lm_loss
from distributed_training_pytorch_tpu_torch.ops.losses import cross_entropy_loss
from distributed_training_pytorch_tpu_torch.train import TrainEngine, TrainState
from distributed_training_pytorch_tpu_torch.trainer import Trainer
from distributed_training_pytorch_tpu_torch.utils.flops import step_flops

SEQ, BATCH, LR = 32, 4, 1e-3
NARROW = dict(stage_features=(4, 8, 8, 16, 16), classifier_widths=(32, 24), dropout_rate=0.0)


def _random_params(model, example):
    """Seeded random params of ``model``'s shapes (no init program to compile)."""
    rng = np.random.RandomState(0)
    shapes = jax.eval_shape(model.init, jax.random.key(0), example)
    return jax.tree.map(lambda s: jnp.asarray(0.05 * rng.randn(*s.shape), s.dtype), shapes)


@pytest.fixture(scope="module")
def lm_step():
    """One JAX step of LMTiny with stats on: the probe's compiled program (the executable
    ``step_cost_analysis`` counts) run once, so one compile gives the FLOPs and the stats."""
    model = jax_lm.LMTiny(vocab_size=256, attention_impl="plain")
    params = _random_params(model, jnp.zeros((1, SEQ), jnp.int32))["params"]
    rng = np.random.RandomState(0)
    w = rng.randint(0, 256, size=(BATCH, SEQ + 1)).astype(np.int32)
    batch = {"image": w[:, :-1], "label": w[:, 1:]}
    engine = _jax_engine(jax_lm.make_fused_lm_loss(model), stats=True)
    state = engine.init_state(jax.random.key(1), lambda rng: {"params": params})
    compiled = engine.compile_step_probe(state, batch)
    _, metrics = compiled(state, batch)
    return params, batch, hlo_flops.executed_matmul_flops(compiled), metrics


def _jax_engine(loss, stats=False):
    return JaxTrainEngine(loss, optax.adamw(LR, weight_decay=0.1, b1=0.9, b2=0.95),
                          jax_mesh.create_mesh(devices=jax.devices()[:1]), stats=stats)


def _port_lm(params, stats=False):
    model = LMTiny(device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)
    return TrainEngine(make_fused_lm_loss(model), stats=stats), TrainState(model=model, optimizer=opt)


def test_health_stats_match_the_jax_engine(lm_step):
    params, batch, _, ref = lm_step
    eng, st = _port_lm(params, stats=True)
    _, got = eng.train_step(st, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("grad_norm", "param_norm", "update_ratio"):
        np.testing.assert_allclose(float(got[key]), float(ref[key]), rtol=1e-5, err_msg=key)
    assert float(got["nonfinite"]) == float(ref["nonfinite"]) == 0.0
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), rtol=1e-5)
    assert eng._health.snapshot_bytes == 4 * sum(p.numel() for p in st.model.parameters())


def test_flop_probe_matches_the_jax_hlo_count_lm(lm_step):
    _, batch, ref, _ = lm_step
    model = LMTiny(device="cpu")
    got = step_flops(model, make_fused_lm_loss(model), {k: torch.from_numpy(v).long() for k, v in batch.items()})
    assert ref and abs(got - ref) / ref < 0.02, (got, ref)


def test_flop_probe_matches_the_jax_hlo_count_vgg():
    jax_model = jax_vgg.VGG16(num_classes=10, **NARROW)
    image = np.zeros((8, 32, 32, 3), np.float32)
    batch = {"image": image, "label": np.zeros(8, np.int32)}
    variables = _random_params(jax_model, image[:1])
    engine = _jax_engine(make_supervised_loss(jax_model, lambda out, b: (jax_ce(out, b["label"]), {})))
    state = engine.init_state(jax.random.key(1), lambda rng: dict(variables))
    ref = hlo_flops.executed_matmul_flops(engine.compile_step_probe(state, batch))
    model = VGG16(num_classes=10, **NARROW, device="cpu")

    def loss_fn(net, b, train):
        loss = cross_entropy_loss(net(b["image"]), b["label"])
        return loss, {"ce_loss": loss}

    got = step_flops(model, loss_fn, {"image": torch.zeros(8, 3, 32, 32), "label": torch.zeros(8, dtype=torch.long)})
    assert ref and abs(got - ref) / ref < 0.02, (got, ref)


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.body = nn.Sequential(nn.Linear(6, 16), nn.BatchNorm1d(16), nn.ReLU(), nn.Linear(16, 3))

    def forward(self, x):
        return self.body(x)


def _run(stats, chained):
    torch.manual_seed(0)
    model = _Net()
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9, weight_decay=1e-4)
    engine = TrainEngine(lambda m, b, t: (F.cross_entropy(m(b["image"]), b["label"]), {}), nan_guard=True,
                         schedule=lambda step: 0.1 * 0.9**step, stats=stats)
    state = TrainState(model=model, optimizer=opt)
    rng = np.random.RandomState(1)
    image = rng.randn(4, 8, 6).astype(np.float32)
    image[2, 0, 0] = np.nan  # the third step is skipped by the guard
    window = {"image": torch.from_numpy(image), "label": torch.from_numpy(rng.randint(0, 3, size=(4, 8)))}
    metrics = []
    if chained:
        for w in range(2):
            state, m = engine.train_steps_chained(state, {k: v[2 * w:2 * w + 2] for k, v in window.items()}, 2)
            metrics.append(m)
    else:
        for i in range(4):
            state, m = engine.train_step(state, {k: v[i] for k, v in window.items()})
            metrics.append(m)
    return state, metrics


@pytest.mark.parametrize("chained", [False, True], ids=["eager", "chained"])
def test_stats_leave_params_bit_equal(chained):
    on, m_on = _run(True, chained)
    off, _ = _run(False, chained)
    for (name, a), b in zip(on.model.state_dict().items(), off.model.state_dict().values(), strict=True):
        assert torch.equal(a, b), name
    flags = torch.cat([m["nonfinite"].reshape(-1) for m in m_on]).tolist()
    assert flags == [0.0, 0.0, 1.0, 0.0]  # the guard's flag wins
    ratios = torch.cat([m["update_ratio"].reshape(-1) for m in m_on]).tolist()
    assert ratios[2] == 0.0 and all(r > 0 for i, r in enumerate(ratios) if i != 2)


class _Tiny(Trainer):
    def build_train_dataset(self):
        rng = np.random.RandomState(0)
        return ArrayDataSource(image=rng.randn(60, 6).astype(np.float32), label=rng.randint(0, 3, 60))

    def build_model(self):
        torch.manual_seed(0)
        return _Net()

    def build_criterion(self):
        return lambda logits, batch: (F.cross_entropy(logits, batch["label"].long()), {})

    def build_optimizer(self, schedule):
        return torch.optim.AdamW(self.model.parameters(), lr=1e-2)

    def build_scheduler(self):
        return 1e-2


def test_goodput_counters_survive_a_sigterm_resume(tmp_path):
    first = _Tiny(max_epoch=2, batch_size=8, save_folder=str(tmp_path), num_workers=0, device="cpu", save_period=1,
                  log_every=2, telemetry="on", fault_plan=FaultPlan().add("sigterm", epoch=1, step=3))
    first.train()
    assert first.preempted
    with open(os.path.join(str(tmp_path), "weights", "last", "meta.json")) as f:
        meta = json.load(f)
    saved = meta["telemetry"]["goodput"]
    assert meta["attempt"] == 1 and meta["loop"] == {"step_in_epoch": 3}
    second = _Tiny(max_epoch=2, batch_size=8, save_folder=str(tmp_path), num_workers=0, device="cpu", save_period=1,
                   log_every=2, telemetry="on", snapshot_path="latest_valid")
    resumed = second.goodput.to_state()
    for bucket, value in saved.items():
        if bucket != "restart_rollback":
            assert resumed[bucket] == value, bucket  # bit-identical
    assert resumed["restart_rollback"] > saved["restart_rollback"]
    second.train()
    from distributed_training_pytorch_tpu_torch.telemetry import load_run_events

    evs = load_run_events(str(tmp_path))
    kinds = [e["event"] for e in evs]
    assert kinds.count("run_start") == 2 and "preemption" in kinds and "checkpoint_restore" in kinds
    assert [e["attempt"] for e in evs if e["event"] == "run_start"] == [1, 2]
    injected = [e for e in evs if e["event"] == "fault_injection"]
    assert [(e["kind"], e["epoch"], e["step"]) for e in injected] == [("sigterm", 1, 3)]
