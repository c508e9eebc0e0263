"""The port's memory preflight (``memory/analysis.py``, ``memory/preflight.py``,
``memory/live.py``) against the JAX package's and against counts it does not make itself.

* ``state_class_bytes``/``batch_class_bytes`` of LMTiny with AdamW equal the JAX package's
  for the same model, exactly, apart from the scalar bookkeeping: JAX keeps one int32
  ``count`` a transform, a step and an rng key; the port one f32 ``step`` a parameter.
* The trace's peak on a hand-built MLP is a hand count, to the byte (exact and in the
  caching allocator's 512-byte blocks); on the digits MLP its transient bytes equal the
  CPU allocator's own count (``scripts/torch_memory_probe.py``).
* ``_recommend``, with the JAX package's ``_predict`` and the port's patched to one
  monotone peak function, gives the same batch, accumulation factor and trial count.
* The JAX memory tests' cases (``tests/test_memory.py``): the fit under a huge capacity,
  the bisection's boundary, ``action="warn"``, no capacity off the card, the knob's specs,
  the accumulation twin; through the trainer, the preflight on and off leave the params
  bit-equal and one ``memory_preflight`` event, a short epoch predicts the single step, a
  predicted OOM raises before any step, a ``train_step`` override skips it.
* On meta tensors the kernels' wrappers take the allocation twins under the route and the
  plain versions outside it: the FLOP count of GPT-2-small is unchanged (4.089668e13), a
  narrow ResNet-50's nine 1x1s (K4 and its dz pass) run their twins, and no launch is
  counted.

The card-only test (``tests/test_torch_memory_card.py``, no JAX) runs the memory probe
against ``max_memory_allocated``.
"""

import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from distributed_training_pytorch_tpu.memory import analysis as jax_analysis
from distributed_training_pytorch_tpu.memory import preflight as jax_preflight
from distributed_training_pytorch_tpu.models import transformer_lm as jax_lm
from distributed_training_pytorch_tpu.parallel import mesh as jax_mesh
from distributed_training_pytorch_tpu.train import TrainEngine as JaxTrainEngine
from distributed_training_pytorch_tpu_torch.examples import train_lm
from distributed_training_pytorch_tpu_torch.memory import (
    BUFFER_CLASSES,
    Preflight,
    PreflightOOMError,
    analyze_step_memory,
    batch_class_bytes,
    device_capacity_bytes,
    is_oom_error,
    live_memory_fields,
    memory_skew,
    resolve_preflight,
    run_preflight,
    state_class_bytes,
)
from distributed_training_pytorch_tpu_torch.memory import preflight as port_preflight
from distributed_training_pytorch_tpu_torch.models import LMTiny, params_from_jax
from distributed_training_pytorch_tpu_torch.models.transformer_lm import make_fused_lm_loss
from distributed_training_pytorch_tpu_torch.ops import conv1x1 as k4
from distributed_training_pytorch_tpu_torch.ops import dispatch
from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa
from distributed_training_pytorch_tpu_torch.ops.losses import cross_entropy_loss
from distributed_training_pytorch_tpu_torch.train import TrainEngine, TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, BATCH = 32, 4


@pytest.fixture(autouse=True)
def _fresh_dispatch_records():
    """The models built here record their kernel policy; another test's event log must not
    receive those records, nor miss its own as already seen."""
    yield
    dispatch.reset()


def _mlp_engine(width=64):
    torch.manual_seed(0)
    net = nn.Sequential(nn.Flatten(), nn.Linear(64, width), nn.ReLU(), nn.Linear(width, 10))
    opt = torch.optim.SGD(net.parameters(), lr=0.1, momentum=0.9)

    def loss_fn(model, batch, train):
        loss = cross_entropy_loss(model(batch["image"]), batch["label"])
        return loss, {"loss": loss}

    return TrainEngine(loss_fn, schedule=lambda step: 0.1), TrainState(model=net, optimizer=opt)


def _mlp_batch(n):
    return {"image": torch.zeros(n, 8, 8, 1), "label": torch.zeros(n, dtype=torch.long)}


@pytest.fixture(scope="module")
def lm_states():
    """LMTiny with AdamW in both packages, from the same weights; the port's after one
    step (torch makes AdamW's state at its first step; optax's init makes it)."""
    jax_model = jax_lm.LMTiny(vocab_size=256)
    params = jax_model.init(jax.random.key(0), jnp.zeros((1, SEQ), jnp.int32))["params"]
    opt = optax.adamw(1e-3, weight_decay=0.1, b1=0.9, b2=0.95)
    engine = JaxTrainEngine(jax_lm.make_fused_lm_loss(jax_model), opt, jax_mesh.create_mesh(devices=jax.devices()[:1]))
    jax_state = engine.init_state(jax.random.key(1), lambda rng: {"params": params})
    model = LMTiny(device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    port_opt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)
    port = TrainEngine(make_fused_lm_loss(model), schedule=lambda step: 1e-3)
    state = TrainState(model=model, optimizer=port_opt)
    rng = np.random.RandomState(0)
    w = rng.randint(0, 256, size=(BATCH, SEQ + 1)).astype(np.int32)
    batch = {"image": w[:, :-1], "label": w[:, 1:]}
    port.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return engine, jax_state, port, state, batch


def test_class_bytes_equal_the_jax_classes(lm_states):
    engine, jax_state, _, state, batch = lm_states
    ours = state_class_bytes(state)
    theirs = jax_analysis.state_class_bytes(jax_state)
    assert ours["params"] == theirs["params"]

    # The scalar bookkeeping, as each package's own class count sizes it.
    jax_scalars = sum(jax_analysis._tree_bytes(x) for x in jax.tree.leaves(
        (jax_state.opt_state, jax_state.step, jax_state.rng, jax_state.loss_scale)) if x.size == 1)
    port_scalars = sum(t.numel() * t.element_size() for st in state.optimizer.state.values() for t in st.values()
                       if torch.is_tensor(t) and t.numel() == 1)
    assert theirs["optimizer_state"] - jax_scalars == ours["optimizer_state"] - port_scalars == 2 * ours["params"]
    assert batch_class_bytes({k: torch.from_numpy(v) for k, v in batch.items()}) == jax_analysis.batch_class_bytes(batch)


@pytest.mark.parametrize("block", [1, 512])
def test_trace_peak_on_a_hand_built_mlp_is_the_hand_count(block):
    b, i, h, o = 32, 16, 64, 8
    torch.manual_seed(0)
    net = nn.Sequential(nn.Linear(i, h, bias=False), nn.ReLU(), nn.Linear(h, o, bias=False))

    def loss_fn(model, batch, train):
        return (model(batch["x"]) ** 2).mean(), {}

    profile = analyze_step_memory(TrainEngine(loss_fn), TrainState(model=net, optimizer=torch.optim.SGD(
        net.parameters(), lr=0.1)), {"x": torch.zeros(b, i)}, block_bytes=block)

    def blk(n):
        return -(-n // block) * block

    # At the peak, in the backward of the ReLU: the two weights, the device lr, the batch;
    # the ReLU's saved output, the gradient into it and the gradient out of it ([B, H]
    # each); the second weight's gradient; the loss and its seed gradient.
    f32 = 4
    hand = (blk(h * i * f32) + blk(o * h * f32) + blk(f32) + blk(b * i * f32) + 3 * blk(b * h * f32)
            + blk(o * h * f32) + 2 * blk(f32))
    assert profile.peak_bytes == hand
    assert sum(profile.bytes_by_class.values()) == profile.peak_bytes
    assert profile.bytes_by_class["gradients"] == blk(o * h * f32)
    assert profile.bytes_by_class["params"] == blk(h * i * f32) + blk(o * h * f32)
    assert profile.bytes_by_class["executable"] == 0


def _run_script(monkeypatch, capsys, *argv):
    monkeypatch.setattr(sys, "argv", ["torch_memory_probe.py", *argv])
    with pytest.raises(SystemExit) as done:
        runpy.run_path(os.path.join(REPO, "scripts", "torch_memory_probe.py"), run_name="__main__")
    return done.value.code, capsys.readouterr().out


@pytest.mark.parametrize("argv", [("--device", "cpu"), ("--device", "cpu", "--inject-oversize")])
def test_memory_probe_holds_the_trace_against_the_cpu_allocator(monkeypatch, capsys, argv):
    code, out = _run_script(monkeypatch, capsys, *argv)
    assert code == 0, out
    if "--inject-oversize" in argv:
        assert "failed with recommended batch" in out
    else:
        line = next(x for x in out.splitlines() if "predicted transient" in x)
        predicted, measured = (int(s.split()[0]) for s in line.split("transient ")[1].split("Total Allocated "))
        assert predicted == measured > 0


@pytest.mark.parametrize("usable_rows", [1.5, 40.0, 100.0])
def test_recommend_matches_the_jax_bisection(monkeypatch, lm_states, usable_rows):
    """One monotone peak for both packages: 1000 bytes a row of the micro-batch, 1e4 more."""
    engine, jax_state, port, state, batch = lm_states
    full = 96

    def peak_of(engine_, batch_):
        rows = next(iter(batch_.values())).shape[0] // max(1, int(engine_.accum_steps))
        return 10_000 + 1000 * rows

    def jax_predict(engine_, state_, batch_, chain_length, report):
        report.trials += 1
        return peak_of(engine_, batch_)

    def port_predict(engine_, state_, batch_, chain_length, report, staged_units):
        report.trials += 1
        return peak_of(engine_, batch_)

    monkeypatch.setattr(jax_preflight, "_predict", jax_predict)
    monkeypatch.setattr(port_preflight, "_predict", port_predict)
    usable = int(10_000 + 1000 * usable_rows)
    jax_batch = {k: jax.ShapeDtypeStruct((full, SEQ), jnp.int32) for k in batch}
    port_batch = {k: torch.empty(full, SEQ, dtype=torch.int32, device="meta") for k in batch}
    results = []
    for module, eng, st, b, extra in ((jax_preflight, engine, jax_state, jax_batch, ()),
                                      (port_preflight, port, state, port_batch, (0,))):
        report = module.PreflightReport(predicted_peak_bytes=peak_of(eng, b), batch_size=full, profile=None,
                                        usable_bytes=usable)
        module._recommend(eng, st, b, module.Preflight(), report, None, *extra)
        results.append((report.recommended_batch, report.recommended_accum, report.recommended_fsdp, report.trials))
    assert results[0] == results[1]


def test_preflight_fits_under_huge_capacity():
    engine, state = _mlp_engine()
    report = run_preflight(engine, state, _mlp_batch(32), Preflight(capacity_bytes=1 << 50))
    assert report.fits is True and report.recommended_batch is None and report.recommended_accum is None
    assert report.batch_size == 32 and report.predicted_peak_bytes == report.profile.peak_bytes
    assert set(report.profile.bytes_by_class) == set(BUFFER_CLASSES)
    assert abs(sum(report.profile.fractions().values()) - 1.0) < 1e-12


def test_preflight_bisection_monotonic_boundary():
    engine, state = _mlp_engine(width=256)
    small = analyze_step_memory(engine, state, _mlp_batch(1), top_k=0).peak_bytes
    full = analyze_step_memory(engine, state, _mlp_batch(32), top_k=0).peak_bytes
    assert small < full
    with pytest.raises(PreflightOOMError) as err:
        run_preflight(engine, state, _mlp_batch(32), Preflight(capacity_bytes=(small + full) // 2, headroom=0.0))
    report = err.value.report
    rec = report.recommended_batch
    assert rec is not None and 1 <= rec < 32
    fit = analyze_step_memory(engine, state, _mlp_batch(rec), top_k=0).peak_bytes
    over = analyze_step_memory(engine, state, _mlp_batch(rec + 1), top_k=0).peak_bytes
    assert fit <= report.usable_bytes < over
    assert report.trials <= Preflight().max_trials
    assert f"batch {rec}" in str(err.value)


def test_preflight_warn_and_unknown_capacity():
    engine, state = _mlp_engine()
    seen = []
    report = run_preflight(engine, state, _mlp_batch(32), Preflight(capacity_bytes=1000, action="warn",
                                                                    recommend=False),
                           log=lambda msg, log_type="info": seen.append((log_type, msg)))
    assert report.fits is False and report.trials == 0
    assert any(t == "warning" and "predicted OOM" in m for t, m in seen)
    report = run_preflight(engine, state, _mlp_batch(32), Preflight())  # the CPU has no capacity to read
    assert report.fits is None and report.capacity_bytes is None and report.predicted_peak_bytes > 0


def test_resolve_preflight_specs():
    assert resolve_preflight(None) is None and resolve_preflight(False) is None and resolve_preflight("off") is None
    for spec in (True, "on", "check"):
        assert isinstance(resolve_preflight(spec), Preflight)
    config = Preflight(headroom=0.2)
    assert resolve_preflight(config) is config
    with pytest.raises(ValueError):
        resolve_preflight("sideways")
    with pytest.raises(TypeError):
        resolve_preflight(3.14)
    with pytest.raises(ValueError):
        Preflight(action="explode")
    with pytest.raises(ValueError):
        Preflight(headroom=1.5)


def test_engine_with_accum_twin_shares_nothing():
    engine, state = _mlp_engine(width=512)
    engine.train_step(state, _mlp_batch(256))
    twin = engine.with_accum(2)
    assert twin is not engine and twin.accum_steps == 2
    assert twin.loss_fn is engine.loss_fn and twin.mesh is engine.mesh and twin._prepared is None
    single = analyze_step_memory(engine, state, _mlp_batch(256), top_k=0).peak_bytes
    halves = analyze_step_memory(twin, state, _mlp_batch(256), top_k=0).peak_bytes  # activations of 128 rows
    assert 0 < halves < single
    with pytest.raises(ValueError):
        engine.with_accum(0)


def test_a_chained_window_counts_its_static_inputs():
    engine, state = _mlp_engine()
    single = analyze_step_memory(engine, state, _mlp_batch(32))
    window = analyze_step_memory(engine, state, _mlp_batch(32), chain_length=4)
    step_bytes = batch_class_bytes(_mlp_batch(32))
    # the window's stacked batch and the graph's static copy of it, in blocks
    assert window.bytes_by_class["input_batch"] >= 2 * 4 * step_bytes > single.bytes_by_class["input_batch"]
    assert window.chain_length == 4 and window.peak_bytes > single.peak_bytes


def test_flop_count_and_kernel_twins_on_meta():
    from distributed_training_pytorch_tpu_torch.models import GPTSmall
    from distributed_training_pytorch_tpu_torch.models.resnet import ResNet
    from distributed_training_pytorch_tpu_torch.utils.flops import step_flops

    gpt = GPTSmall(vocab_size=256, dtype=torch.bfloat16, max_len=1024, device="meta")
    gpt_batch = {"image": torch.empty(64, 1024, dtype=torch.long, device="meta"),
                 "label": torch.empty(64, 1024, dtype=torch.long, device="meta")}
    assert step_flops(gpt, make_fused_lm_loss(gpt), gpt_batch) == pytest.approx(4.089668e13, rel=1e-6)
    fa.reset_launches()
    k4.reset_launches()
    profile = analyze_step_memory(TrainEngine(make_fused_lm_loss(gpt)), TrainState(
        model=gpt, optimizer=torch.optim.AdamW(gpt.parameters(), lr=1e-4)), gpt_batch, top_k=50)
    # K1's twin: no [B, H, T, T] scores live at the peak (the plain version's f32 scores are 3.2 GB a layer)
    assert not [r for r in profile.top_buffers if r["shape"][-2:] == [1024, 1024]]
    assert profile.peak_bytes < 30e9
    resnet = ResNet(num_classes=10, width=8, dtype=torch.bfloat16, pallas=True, device="meta")
    calls = {"fwd": 0, "dz": 0}
    real = {"fwd": k4._launch_kernel, "dz": k4._launch_bwd_dz}

    def counted(kind):
        def run(*args, **kwargs):
            calls[kind] += 1
            return real[kind](*args, **kwargs)

        return run

    k4._launch_kernel, k4._launch_bwd_dz = counted("fwd"), counted("dz")
    try:
        def loss_fn(model, batch, train):
            loss = cross_entropy_loss(model(batch["image"]), batch["label"])
            return loss, {"loss": loss}

        analyze_step_memory(TrainEngine(loss_fn), TrainState(model=resnet, optimizer=torch.optim.SGD(
            resnet.parameters(), lr=0.1, momentum=0.9)), {"image": torch.empty(2, 3, 224, 224),
                                                          "label": torch.zeros(2, dtype=torch.long)})
    finally:
        k4._launch_kernel, k4._launch_bwd_dz = real["fwd"], real["dz"]
    assert calls == {"fwd": 9, "dz": 9}  # ResNet-50's nine 1x1s at 56x56, each way
    assert not any(fa.launches.values()) and not any(k4.launches.values())
    assert not dispatch.allocation_route_active()


def test_live_fields_off_the_card_and_the_oom_test():
    assert live_memory_fields("cpu") == {} and memory_skew(["cpu", "cpu"]) == {}
    assert device_capacity_bytes("cpu") is None
    assert is_oom_error(torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert is_oom_error(RuntimeError("CUDA out of memory. Tried to allocate 20.00 MiB"))
    assert not is_oom_error(MemoryError("host")) and not is_oom_error(ValueError("out of memory"))


# -- through the trainer --------------------------------------------------------


@pytest.fixture()
def lm_env(monkeypatch):
    windows = train_lm.load_windows(SEQ)[:96]
    monkeypatch.setattr(train_lm, "load_windows", lambda seq_len, path=None: windows)
    monkeypatch.setenv("DTYPE", "fp32")
    for knob in ("PALLAS", "FUSED_CE", "LM_CORPUS", "TELEMETRY", "CHAIN_STEPS"):
        monkeypatch.delenv(knob, raising=False)


def _lm(tmp_path, tag, **kw):
    kw = {"telemetry": True, "log_every": 4, **kw}
    return train_lm.LMTrainer(seq_len=SEQ, base_lr=1e-3, size="tiny", moe_every=0, max_epoch=1,
                              batch_size=kw.pop("batch_size", 8), save_folder=str(tmp_path / tag), device="cpu", **kw)


def _events(trainer, kind):
    from distributed_training_pytorch_tpu_torch.telemetry import load_run_events

    return [e for e in load_run_events(trainer.save_folder) if e["event"] == kind]


def test_trainer_preflight_parity_and_event(lm_env, tmp_path):
    torch.manual_seed(0)
    off = _lm(tmp_path, "off", chain_steps=4)
    off.train()
    torch.manual_seed(0)
    on = _lm(tmp_path, "on", chain_steps=4, preflight=Preflight(capacity_bytes=1 << 50))
    on.train()
    for (name, a), (_, b) in zip(off.model.state_dict().items(), on.model.state_dict().items(), strict=True):
        assert torch.equal(a, b), name
    assert off.memory_report is None and on.memory_report.fits is True
    (record,) = _events(on, "memory_preflight")
    assert record["chain_length"] == 4 and record["fits"] is True and record["top_buffers"]
    assert record["predicted_peak_bytes"] == on.memory_report.predicted_peak_bytes
    assert abs(sum(record["fractions"].values()) - 1.0) < 1e-3
    assert not _events(off, "memory_preflight")
    assert all("live_bytes" not in w for w in _events(on, "window"))  # the CPU has no allocator counters


def test_trainer_preflight_short_epoch_predicts_the_single_step(lm_env, tmp_path):
    trainer = _lm(tmp_path, "short", batch_size=32, chain_steps=4, preflight=Preflight(capacity_bytes=1 << 50))
    assert len(trainer.train_dataloader) < 4
    trainer.train()
    assert trainer.memory_report.chain_length is None and trainer.memory_report.fits is True


def test_trainer_preflight_oom_raises_before_any_step(lm_env, tmp_path):
    trainer = _lm(tmp_path, "oom", preflight=Preflight(capacity_bytes=2048))
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    with pytest.raises(PreflightOOMError) as err:
        trainer.train()
    assert err.value.report.fits is False and trainer.state.step == 0
    assert trainer.engine._prepared is None  # no step was ever run
    assert all(torch.equal(v, before[k]) for k, v in trainer.model.state_dict().items())


def test_trainer_preflight_skipped_under_a_custom_train_step(lm_env, tmp_path):
    class Custom(train_lm.LMTrainer):
        def train_step(self, state, batch):
            return super().train_step(state, batch)

    seen = []
    trainer = Custom(seq_len=SEQ, base_lr=1e-3, size="tiny", moe_every=0, max_epoch=1, batch_size=8,
                     save_folder=str(tmp_path / "custom"), device="cpu", preflight="on",
                     logger=type("L", (), {"log": staticmethod(lambda msg, log_type="info": seen.append(msg))})())
    trainer.train()
    assert trainer.memory_report is None
    assert any("memory preflight skipped" in m for m in seen)
