"""Dynamic loss scaling in the port (``distributed_training_pytorch_tpu_torch/precision/
loss_scale.py``, the engine's scale/unscale/skip, the Trainer's ``loss_scale`` knob and the
checkpoint's scale state) held against the JAX package's ``DynamicScale`` through its
``TrainEngine``.

* The trace: one linear layer, SGD (lr 0.1, momentum 0.9), f32 arithmetic with a
  ``DynamicScale`` of ``growth_interval=2`` on both sides, over a forced sequence: an
  overflow (an infinite input), 3 clean steps, an overflow, 2 clean steps. The scale each
  step used, the ``nonfinite`` flag, and the state after each step (scale, growth counter,
  skipped steps) are exactly equal; the params within 1e-6 (f32 in other summation
  orders). Once with one micro-batch, once with 2.
* The refusals of the ``Trainer``'s ``loss_scale`` knob are held against the JAX
  ``Trainer``'s in ``tests/test_torch_digits.py``, whose JAX subprocess builds that trainer
  already.
* fp16 on the port: the preset, a forced overflow skipped with params and buffers
  bit-equal and the scale halved, a save and restore carrying the scale and the counter,
  and K1–K4 refusing float16 by name rather than running their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_training_pytorch_tpu.parallel import mesh as jax_mesh
from distributed_training_pytorch_tpu.precision.loss_scale import DynamicScale as JaxDynamicScale
from distributed_training_pytorch_tpu.train import TrainEngine as JaxTrainEngine
from distributed_training_pytorch_tpu_torch.checkpoint import LAST, CheckpointManager
from distributed_training_pytorch_tpu_torch.ops import conv1x1 as k4
from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa
from distributed_training_pytorch_tpu_torch.precision import (
    DynamicScale,
    NoOpScale,
    get_policy,
    is_dynamic,
    resolve_loss_scale,
)
from distributed_training_pytorch_tpu_torch.train import TrainEngine, TrainState

IN, OUT, ROWS, LR = 5, 3, 8, 0.1
SEQUENCE = ["overflow", "clean", "clean", "clean", "overflow", "clean", "clean"]


def _batches():
    rng = np.random.RandomState(0)
    out = []
    for kind in SEQUENCE:
        x = rng.randn(ROWS, IN).astype(np.float32)
        if kind == "overflow":
            x[1, 2] = np.inf
        out.append({"x": x, "y": rng.randn(ROWS, OUT).astype(np.float32)})
    return out


def _jax_trace(accum):
    def loss_fn(params, model_state, batch, rng, train):
        pred = batch["x"] @ params["w"] + params["b"]
        loss = jnp.mean((pred - batch["y"]) ** 2)
        return loss, ({"mse": loss}, model_state)

    rng = np.random.RandomState(1)
    init = {"w": rng.randn(IN, OUT).astype(np.float32) * 0.3, "b": rng.randn(OUT).astype(np.float32) * 0.1}
    mesh = jax_mesh.create_mesh(devices=jax.devices()[:1])
    engine = JaxTrainEngine(loss_fn, optax.sgd(LR, momentum=0.9), mesh, accum_steps=accum,
                            loss_scale=JaxDynamicScale.create(growth_interval=2))
    state = engine.init_state(jax.random.key(0), lambda r: {"params": {k: jnp.asarray(v) for k, v in init.items()}})
    trace = []
    for batch in _batches():
        state, m = engine.train_step(state, engine.shard_batch(batch))
        s = state.loss_scale
        trace.append({"used": float(m["loss_scale"]), "nonfinite": float(m["nonfinite"]), "scale": float(s.scale),
                      "counter": int(s.growth_counter), "skipped": int(s.skipped_steps),
                      "w": np.asarray(state.params["w"]), "b": np.asarray(state.params["b"])})
    return init, trace


class _Linear(torch.nn.Module):
    def __init__(self, init):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(init["w"].copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(init["b"].copy()))

    def forward(self, x):
        return x @ self.w + self.b


def _port_loss(model, batch, train):
    loss = ((model(batch["x"]) - batch["y"]) ** 2).mean()
    return loss, {"mse": loss}


@pytest.mark.parametrize("accum", [1, 2])
def test_the_scale_trace_matches_the_jax_dynamic_scale(accum):
    init, ref = _jax_trace(accum)
    model = _Linear(init)
    engine = TrainEngine(_port_loss, accum_steps=accum)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9),
                       loss_scale=DynamicScale.create(growth_interval=2))
    for i, batch in enumerate(_batches()):
        state, m = engine.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        s, r = state.loss_scale, ref[i]
        got = {"used": float(m["loss_scale"]), "nonfinite": float(m["nonfinite"]), "scale": float(s.scale),
               "counter": int(s.growth_counter), "skipped": int(s.skipped_steps)}
        assert got == {k: r[k] for k in got}, (i, got, r)
        np.testing.assert_allclose(model.w.detach().numpy(), r["w"], atol=1e-6, err_msg=f"step {i}")
        np.testing.assert_allclose(model.b.detach().numpy(), r["b"], atol=1e-6, err_msg=f"step {i}")
    assert [t["scale"] for t in ref] == [2.0**14, 2.0**14, 2.0**15, 2.0**15, 2.0**14, 2.0**14, 2.0**15]
    assert ref[-1]["skipped"] == 2 and state.step == len(SEQUENCE)


def test_adjust_keeps_the_limits_and_reads_nothing_back():
    s = DynamicScale.create(2.0**24, growth_interval=1)
    s = s.adjust(torch.tensor(True))
    assert float(s.scale) == 2.0**24 and int(s.growth_counter) == 0  # capped at max_scale
    low = DynamicScale.create(1.0)
    low = low.adjust(torch.tensor(False))
    assert float(low.scale) == 1.0 and int(low.skipped_steps) == 1  # floored at min_scale
    assert s.scale.dtype == torch.float32 and s.growth_counter.dtype == s.skipped_steps.dtype == torch.int32
    with pytest.raises(ValueError, match="initial_scale"):
        DynamicScale.create(0.0)
    assert resolve_loss_scale(None, get_policy("fp16")).scale.item() == 2.0**15
    assert resolve_loss_scale(None, get_policy("bf16")) is None
    assert isinstance(resolve_loss_scale("none", get_policy(None)), NoOpScale)
    assert is_dynamic(resolve_loss_scale("dynamic", get_policy(None)))


class _Small(torch.nn.Module):
    """A conv, BatchNorm and a head computing in fp16 over f32 params, as the port's models do."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)
        self.bn = torch.nn.BatchNorm2d(4)
        self.head = torch.nn.Linear(4, 3)

    def forward(self, x):
        h = torch.nn.functional.conv2d(x.half(), self.conv.weight.half(), self.conv.bias.half(), padding=1)
        h = self.bn(h.float()).half().relu().mean(dim=(2, 3))
        return torch.nn.functional.linear(h, self.head.weight.half(), self.head.bias.half())


def test_fp16_overflow_is_skipped_and_the_scale_survives_a_checkpoint(tmp_path):
    policy = get_policy("fp16")
    assert (policy.param_dtype, policy.compute_dtype, policy.output_dtype) == (
        torch.float32, torch.float16, torch.float32)
    model = _Small()

    def loss_fn(m, batch, train):
        loss = torch.nn.functional.cross_entropy(m(batch["image"]).float(), batch["label"])
        return loss, {"ce_loss": loss}

    engine = TrainEngine(loss_fn, precision="fp16")
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
                       loss_scale=resolve_loss_scale(None, policy))
    rng = np.random.RandomState(2)
    batch = {"image": torch.from_numpy(rng.randn(6, 3, 8, 8).astype(np.float32)), "label": torch.tensor([0, 1, 2] * 2)}
    for _ in range(2):
        state, m = engine.train_step(state, batch)
        assert float(m["nonfinite"]) == 0.0 and float(m["loss_scale"]) == 2.0**15
    before = {k: v.clone() for k, v in model.state_dict().items()}
    huge = dict(batch, image=torch.full_like(batch["image"], 7e4))  # past fp16's 65504
    state, m = engine.train_step(state, huge)
    assert float(m["nonfinite"]) == 1.0 and float(m["loss_scale"]) == 2.0**15
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())  # BN buffers too
    s = state.loss_scale
    assert (float(s.scale), int(s.growth_counter), int(s.skipped_steps)) == (2.0**14, 0, 1)
    state, m = engine.train_step(state, batch)
    assert float(m["nonfinite"]) == 0.0

    manager = CheckpointManager(str(tmp_path))
    manager.save(LAST, state, 1)
    assert manager.read_meta(LAST)["loss_scale"] == "DynamicScale"
    fresh = _Small()
    target = TrainState(fresh, torch.optim.SGD(fresh.parameters(), lr=0.05, momentum=0.9),
                        loss_scale=DynamicScale.create())
    restored, _ = manager.restore(LAST, target)
    r = restored.loss_scale
    assert (float(r.scale), int(r.growth_counter), int(r.skipped_steps)) == (2.0**14, 1, 1)
    # a checkpoint without a scale keeps the target's fresh one
    plain = TrainState(_Small(), torch.optim.SGD(model.parameters(), lr=0.1))
    CheckpointManager(str(tmp_path / "plain")).save(LAST, plain, 1)
    target = TrainState(fresh, torch.optim.SGD(fresh.parameters(), lr=0.1), loss_scale=DynamicScale.create())
    restored, _ = CheckpointManager(str(tmp_path / "plain")).restore(LAST, target)
    assert float(restored.loss_scale.scale) == 2.0**15


def test_the_hand_kernels_refuse_float16_by_name():
    """On an fp16 path K1–K4 raise, naming the kernel, where they would launch: never the
    plain version in silence (the check runs before any card is touched)."""
    x = torch.zeros(2, 4, 4, 64, dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="K4"):
        k4._launch_kernel(x, torch.zeros(64, 64), torch.ones(64), torch.zeros(64), None, torch.float16)
    with pytest.raises(NotImplementedError, match="K4"):
        k4._launch_bwd_dz(torch.zeros(8, 64, dtype=torch.float16), None, torch.ones(64), None, torch.float16)
    q = torch.zeros(1, 8, 2, 64, dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="K1 forward, K2 dq, K3 dk/dv"):
        fa._check_kernel_inputs((("q", q), ("k", q), ("v", q)))
