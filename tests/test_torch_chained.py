"""Chained steps in the port (``TrainEngine.train_steps_chained``, ``Trainer(chain_steps=)``,
``data.prefetch.device_prefetch_chained``) on the CPU, where a window runs its steps as a
loop of the same step body the card captures as one CUDA graph.

* The engine's window of 4 is bit-equal to 4 ``train_step`` calls (SGD with momentum and
  a BatchNorm model under the non-finite guard; AdamW with 2 micro-batches), per-step
  metrics included, each with a leading axis of 4.
* Against the JAX engine's ``train_steps_chained`` (one device, f32, LMTiny from the same
  weights, AdamW on a warmup-cosine schedule, the fused LM loss, a window of 2): per-step
  loss within 1e-5 and lr within 1e-6 relative, params after the window within 1e-5, the
  tolerances of ``tests/test_torch_train_engine.py`` (each qkv bias's key block held to
  twice the summed learning rates, for the reason given there).
* A ``chain_steps=2`` epoch (windows, a tail single) gives the ``chain_steps=1`` run's
  per-step metrics and params, bit for bit; ``device_prefetch_chained`` gives the units
  JAX's gives (lead singles, windows, tail).
* The constructor's refusals and roundings match the JAX ``Trainer``'s
  (``_validate_chain_config``, run in a subprocess with a stand-in ``data.streaming``
  module, as ``tests/test_torch_trainer_lm.py`` runs it): ``log_every`` not a multiple of
  ``chain_steps``, ``chain_steps < 1`` and a ``train_step`` override raise the same error
  with the same message; ``preemption_check_every`` is rounded up with the same warning,
  and ``step_timeout`` logs the same line.
* A NaN batch inside a window: its step reports ``nonfinite`` 1 and leaves params,
  optimizer state and BatchNorm buffers as they were; in the trainer a ``nan_loss`` fault
  sends its window to single steps, and the epoch counts one non-finite step.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from distributed_training_pytorch_tpu.models import transformer_lm as jax_lm
from distributed_training_pytorch_tpu.parallel import mesh as jax_mesh
from distributed_training_pytorch_tpu.train import TrainEngine as JaxTrainEngine
from distributed_training_pytorch_tpu_torch.data import ArrayDataSource
from distributed_training_pytorch_tpu_torch.data.prefetch import device_prefetch_chained
from distributed_training_pytorch_tpu_torch.fault import FaultPlan
from distributed_training_pytorch_tpu_torch.models import LMTiny, params_from_jax
from distributed_training_pytorch_tpu_torch.models.transformer_lm import make_fused_lm_loss
from distributed_training_pytorch_tpu_torch.ops.schedules import warmup_cosine_lr
from distributed_training_pytorch_tpu_torch.train import TrainEngine, TrainState
from distributed_training_pytorch_tpu_torch.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, BATCH, LR, WINDOW, JAX_WINDOW = 40, 8, 1e-3, 4, 2
CHAIN_CASES = [
    # chain_steps, log_every, preemption_check_every, step_timeout, custom train_step
    (1, 50, 20, None, False),
    (4, 8, 20, None, False),
    (4, 8, 10, None, False),
    (3, 9, 7, 2.5, False),
    (4, 6, 20, None, False),
    (2, 0, 0, None, False),
    (0, 50, 20, None, False),
    (2, 4, 20, None, True),
]

_JAX_SIDE = textwrap.dedent(
    """
    import json, sys, types

    stub = types.ModuleType("distributed_training_pytorch_tpu.data.streaming")
    def _unavailable(*a, **k):
        raise RuntimeError("data/streaming is not in this tree")
    for name in ("DecodePool", "ReaderState", "StreamingLoader", "shard_array_source"):
        setattr(stub, name, _unavailable)
    sys.modules[stub.__name__] = stub
    from distributed_training_pytorch_tpu.trainer import Trainer

    class Plain(Trainer):
        pass

    class Custom(Trainer):
        def train_step(self, state, batch):
            return super().train_step(state, batch)

    out = []
    for chain, log_every, pce, timeout, custom in json.loads(sys.argv[1]):
        obj = object.__new__(Custom if custom else Plain)
        logs = []
        obj.log = lambda msg, log_type="info", logs=logs: logs.append([log_type, msg])
        obj.chain_steps, obj.log_every, obj.preemption_check_every, obj.step_timeout = chain, log_every, pce, timeout
        try:
            obj._validate_chain_config()
            out.append({"preemption_check_every": obj.preemption_check_every, "logs": logs})
        except Exception as e:
            out.append({"error": type(e).__name__, "message": str(e)})
    print(json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def jax_chain_config():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    done = subprocess.run([sys.executable, "-c", _JAX_SIDE, json.dumps(CHAIN_CASES)], cwd=REPO, env=env,
                          check=True, capture_output=True, text=True, timeout=600)
    return json.loads(done.stdout.strip().splitlines()[-1])


def _port_chain_config(chain, log_every, pce, timeout, custom):
    class Plain(Trainer):
        pass

    class Custom(Trainer):
        def train_step(self, state, batch):
            return super().train_step(state, batch)

    obj = object.__new__(Custom if custom else Plain)
    logs = []
    obj.log = lambda msg, log_type="info": logs.append([log_type, msg])
    obj.chain_steps, obj.log_every, obj.preemption_check_every, obj.step_timeout = chain, log_every, pce, timeout
    try:
        obj._validate_chain_config()
        return {"preemption_check_every": obj.preemption_check_every, "logs": logs}
    except Exception as e:  # noqa: BLE001 — the exception is the answer
        return {"error": type(e).__name__, "message": str(e)}


def test_chain_config_refusals_and_roundings_match_jax(jax_chain_config):
    got = [_port_chain_config(*case) for case in CHAIN_CASES]
    assert got == jax_chain_config
    assert jax_chain_config[2]["preemption_check_every"] == 12  # rounded up to a window boundary
    assert jax_chain_config[4]["error"] == "ValueError"


# -- the engine ---------------------------------------------------------------


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.body = nn.Sequential(nn.Linear(6, 16), nn.BatchNorm1d(16), nn.ReLU(), nn.Linear(16, 3))

    def forward(self, x):
        return self.body(x)


def _criterion(logits, batch):
    loss = F.cross_entropy(logits.float(), batch["label"].long())
    return loss, {"ce": loss}


def _net_engine(kind):
    torch.manual_seed(0)
    model = _Net()
    if kind == "sgd":
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9, weight_decay=1e-4)
        engine = TrainEngine(lambda m, b, t: _criterion(m(b["image"]), b), nan_guard=True,
                             schedule=lambda step: 0.1 * 0.9**step)
    else:
        opt = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=0.1)
        engine = TrainEngine(lambda m, b, t: _criterion(m(b["image"]), b), accum_steps=2,
                             schedule=lambda step: 1e-2 / (1 + step))
    return engine, TrainState(model=model, optimizer=opt)


def _window(seed=1, n=WINDOW, rows=BATCH, poison_at=None):
    rng = np.random.RandomState(seed)
    image = rng.randn(n, rows, 6).astype(np.float32)
    if poison_at is not None:
        image[poison_at] = np.nan
    return {"image": torch.from_numpy(image), "label": torch.from_numpy(rng.randint(0, 3, size=(n, rows)))}


def _snapshot(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            [{k: v.clone() for k, v in s.items()} for s in state.optimizer.state.values()])


def _assert_same(a, b):
    (pa, oa), (pb, ob) = a, b
    assert pa.keys() == pb.keys()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    assert len(oa) == len(ob)
    for sa, sb in zip(oa, ob, strict=True):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("kind, poison_at", [("sgd", None), ("sgd", 2), ("adamw", None)])
def test_window_is_bit_equal_to_sequential_steps(kind, poison_at):
    window = _window(poison_at=poison_at)
    eng_a, seq = _net_engine(kind)
    per_step = []
    for i in range(WINDOW):
        seq, m = eng_a.train_step(seq, {k: v[i] for k, v in window.items()})
        per_step.append(m)
    eng_b, chained = _net_engine(kind)
    chained, metrics = eng_b.train_steps_chained(chained, window, WINDOW)
    assert chained.step == seq.step == WINDOW
    assert set(metrics) == set(per_step[0])
    for k, v in metrics.items():
        assert v.shape == (WINDOW,), k
        torch.testing.assert_close(v, torch.stack([m[k] for m in per_step]), rtol=0, atol=0, equal_nan=True,
                                   msg=k)
    _assert_same(_snapshot(chained), _snapshot(seq))
    with pytest.raises(ValueError, match="steps, not 3"):
        eng_b.train_steps_chained(chained, window, 3)


@pytest.mark.parametrize("choice", [{}, {"fused": True}, {"foreach": True}, {"foreach": False}, {"fused": False}])
def test_an_explicit_optimizer_form_is_overridden_with_a_warning(choice):
    """The engine runs SGD's fused form whatever the caller chose; overriding an explicit
    ``foreach``/``fused`` warns once, and the steps equal those of a default SGD."""
    import warnings

    eng_ref, ref = _net_engine("sgd")
    window = _window()
    ref, _ = eng_ref.train_steps_chained(ref, window, WINDOW)
    torch.manual_seed(0)
    model = _Net()
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9, weight_decay=1e-4, **choice)
    engine = TrainEngine(lambda m, b, t: _criterion(m(b["image"]), b), nan_guard=True,
                         schedule=lambda step: 0.1 * 0.9**step)
    state = TrainState(model=model, optimizer=opt)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(WINDOW):
            state, _ = engine.train_step(state, {k: v[i] for k, v in window.items()})
    overridden = [w for w in caught if "runs the fused form" in str(w.message)]
    assert len(overridden) == (0 if choice.get("fused") is True or not choice else 1), caught
    assert all(g["fused"] is True and g["foreach"] is False for g in opt.param_groups)
    _assert_same(_snapshot(state), _snapshot(ref))


def test_a_nan_step_inside_a_window_is_skipped_and_counted():
    eng, state = _net_engine("sgd")
    clean = _window(seed=1)
    state, _ = eng.train_steps_chained(state, {k: v[:2] for k, v in clean.items()}, 2)
    before = _snapshot(state)
    poisoned = _window(seed=1, n=2, poison_at=0)
    state, metrics = eng.train_steps_chained(state, poisoned, 2)
    assert metrics["nonfinite"].tolist() == [1.0, 0.0]
    assert state.step == 4
    # The skipped step left everything, BatchNorm's running statistics included, as it
    # was: replaying the window's good step alone from `before` gives the same state.
    eng_ref, ref = _net_engine("sgd")
    ref, _ = eng_ref.train_steps_chained(ref, {k: v[:2] for k, v in clean.items()}, 2)
    _assert_same(_snapshot(ref), before)
    ref.step += 1  # the skipped step still advanced the schedule
    ref, _ = eng_ref.train_step(ref, {k: v[1] for k, v in poisoned.items()})
    _assert_same(_snapshot(state), _snapshot(ref))


@pytest.fixture(scope="module")
def jax_lm_init():
    model = jax_lm.LMTiny(vocab_size=256)
    params = model.init(jax.random.key(0), jnp.zeros((1, SEQ), jnp.int32))["params"]
    return model, params


def test_window_matches_the_jax_chained_window(jax_lm_init):
    jax_model, params = jax_lm_init
    schedule = optax.warmup_cosine_decay_schedule(0.0, LR, 1, 6, 0.0)
    engine = JaxTrainEngine(jax_lm.make_fused_lm_loss(jax_model), optax.adamw(schedule, weight_decay=0.1, b1=0.9,
                            b2=0.95), jax_mesh.create_mesh(devices=jax.devices()[:1]), schedule=schedule)
    state = engine.init_state(jax.random.key(1), lambda rng: {"params": params})
    rng = np.random.RandomState(0)
    w = rng.randint(0, 256, size=(JAX_WINDOW, BATCH, SEQ + 1)).astype(np.int32)
    window = {"image": w[..., :-1], "label": w[..., 1:]}
    state, metrics = engine.train_steps_chained(state, window, JAX_WINDOW)

    port_schedule = warmup_cosine_lr(LR, total_epochs=1, steps_per_epoch=6, warmup_epochs=0)
    model = LMTiny(device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    opt = torch.optim.AdamW(model.parameters(), lr=port_schedule(0), betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)
    port = TrainEngine(make_fused_lm_loss(model), schedule=port_schedule)
    port_state, port_metrics = port.train_steps_chained(
        TrainState(model=model, optimizer=opt), {k: torch.from_numpy(v) for k, v in window.items()}, JAX_WINDOW)
    np.testing.assert_allclose(port_metrics["loss"].numpy(), np.asarray(metrics["loss"]), atol=1e-5)
    np.testing.assert_allclose(port_metrics["lr"].numpy(), np.asarray(metrics["lr"]), rtol=1e-6)
    assert port_state.step == int(state.step) == JAX_WINDOW
    ref = params_from_jax(jax.tree.map(np.asarray, state.params))
    key_bias_atol = 2 * sum(port_schedule(i) for i in range(JAX_WINDOW))
    for name, value in ref.items():
        a, b = port_state.model.state_dict()[name].numpy(), value.numpy()
        if name.endswith("qkv.bias"):
            d = a.shape[0] // 3
            np.testing.assert_allclose(a[d : 2 * d], b[d : 2 * d], atol=key_bias_atol, err_msg=name)
            a, b = np.concatenate([a[:d], a[2 * d :]]), np.concatenate([b[:d], b[2 * d :]])
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name)


# -- the trainer ----------------------------------------------------------------


class _Tiny(Trainer):
    """60 rows of 6 features, 3 classes, batch 8: 7 steps an epoch."""

    def build_train_dataset(self):
        rng = np.random.RandomState(0)
        return ArrayDataSource(image=rng.randn(60, 6).astype(np.float32), label=rng.randint(0, 3, 60))

    def build_model(self):
        torch.manual_seed(0)
        return _Net()

    def build_criterion(self):
        return _criterion

    def build_optimizer(self, schedule):
        return torch.optim.SGD(self.model.parameters(), lr=0.1, momentum=0.9)

    def build_scheduler(self):
        return lambda step: 0.1 * 0.95**step

    def build_loss_fn(self):
        criterion = self.criterion
        return lambda model, batch, train: criterion(model(batch["image"]), batch)


def _recorded_run(tmp_path, chain, **kw):
    trainer = _Tiny(max_epoch=2, batch_size=BATCH, save_folder=str(tmp_path), num_workers=0, device="cpu",
                    chain_steps=chain, log_every=2, logger=_Quiet(), **kw)
    steps, engine = [], trainer.engine
    single, chained = engine.train_step, engine.train_steps_chained

    def record_single(state, batch):
        state, m = single(state, batch)
        if not in_window:  # off the card a window loops over train_step itself
            steps.append({k: float(v) for k, v in m.items()})
        return state, m

    def record_window(state, batch, n):
        in_window.append(n)
        try:
            state, m = chained(state, batch, n)
        finally:
            in_window.clear()
        steps.extend({k: float(v[i]) for k, v in m.items()} for i in range(n))
        units.append(n)
        return state, m

    units: list = []
    in_window: list = []
    engine.train_step, engine.train_steps_chained = record_single, record_window
    trainer.train()
    return trainer, steps, units


class _Quiet:
    def __init__(self):
        self.lines = []

    def log(self, msg, log_type="info"):
        self.lines.append((log_type, msg))


def test_a_chained_epoch_gives_the_unchained_per_step_metrics(tmp_path):
    one, steps_one, units_one = _recorded_run(tmp_path / "one", 1)
    two, steps_two, units_two = _recorded_run(tmp_path / "two", 2)
    assert units_one == [] and units_two == [2, 2, 2] * 2  # 7 steps an epoch: 3 windows and a tail single
    assert len(steps_two) == len(steps_one) == 14
    assert steps_two == steps_one
    assert two.state.step == one.state.step == 14
    _assert_same(_snapshot(two.state), _snapshot(one.state))


def test_a_nan_fault_sends_its_window_to_single_steps(tmp_path):
    runs = {}
    for chain in (1, 2):
        plan = FaultPlan().add("nan_loss", epoch=0, step=3)
        runs[chain] = _recorded_run(tmp_path / str(chain), chain, nan_policy="skip", fault_plan=plan)
        assert plan.count_fired("nan_loss") == 1
    (one, steps_one, _), (two, steps_two, units_two) = runs[1], runs[2]
    assert units_two == [2, 2] + [2, 2, 2]  # epoch 0's window [2, 4) ran as two single steps
    assert [s["nonfinite"] for s in steps_two] == [s["nonfinite"] for s in steps_one]
    assert sum(s["nonfinite"] for s in steps_two) == 1.0 and steps_two[3]["nonfinite"] == 1.0
    assert one.nonfinite_steps == two.nonfinite_steps == 1
    _assert_same(_snapshot(two.state), _snapshot(one.state))


def test_device_prefetch_chained_units():
    batches = [{"x": np.full((2,), i)} for i in range(9)]
    units = list(device_prefetch_chained(iter(batches), "cpu", 3, lead_singles=2))
    assert [n for n, _ in units] == [1, 1, 3, 3, 1]
    assert units[2][1]["x"].tolist() == [[2, 2], [3, 3], [4, 4]]
    assert units[4][1]["x"].tolist() == [8, 8]
    assert [n for n, _ in device_prefetch_chained(iter(batches), "cpu", 1)] == [1] * 9
    with pytest.raises(ValueError):
        device_prefetch_chained(iter(batches), "cpu", 0)
