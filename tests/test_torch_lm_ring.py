"""The port's ``TransformerLM`` with ``attention_impl="ring"`` over a ``seq`` axis of 4, all
shards in one process, held against the JAX package's on a ``{seq: 4}`` mesh of the
virtual CPU devices, from the same weights (``models/convert.py::params_from_jax``): the
logits, one training step through each package's ``TrainEngine`` (loss, gradients,
updated params), the ``pallas=`` knob's precedence over ``"ring"``, and the mesh-spec
grammar.

Both rings run their dense form here (CPU tensors; JAX's ``"auto"`` off a TPU). Tolerances,
f32: logits atol 2e-4, as ``tests/test_transformer_lm.py`` holds the ring LM against the
plain one; gradients atol 5e-4, as ``tests/test_parallel.py`` holds ring gradients (the
JAX engine's gradients are read back from its SGD step, to about 1e-6); the loss 1e-5 and the params after one SGD step 1e-5 (the step moves each param by the
learning rate times its gradient, so the gradients' float differences, at most a few 1e-7
here, scaled by 0.1). SGD, not AdamW: Adam's per-parameter normalisation turns the float
noise of gradients that are 0 in exact arithmetic (each qkv bias's key block) into whole
steps, different on each side (``tests/test_torch_train_engine.py``).
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
from distributed_training_pytorch_tpu_torch.ops import dispatch
from distributed_training_pytorch_tpu_torch.parallel import MeshConfig, mesh_config_from_spec
from distributed_training_pytorch_tpu_torch.train import TrainEngine, TrainState

VOCAB, SEQ, BATCH, LR = 64, 32, 4, 0.1
LOGIT_ATOL, GRAD_ATOL, STEP_ATOL = 2e-4, 5e-4, 1e-5


@pytest.fixture(scope="module")
def jax_side():
    mesh = jax_mesh.create_mesh({jax_mesh.SEQ_AXIS: 4}, devices=jax.devices()[:4])
    model = jax_lm.LMTiny(vocab_size=VOCAB, attention_impl="ring", mesh=mesh)
    params = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, SEQ), jnp.int32))["params"]
    return mesh, model, params


def _port(params, **kw):
    model = LMTiny(vocab_size=VOCAB, device="cpu", **kw)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return model


def _batch(seed=0):
    w = np.random.RandomState(seed).randint(0, VOCAB, size=(BATCH, SEQ + 1)).astype(np.int32)
    return {"image": w[:, :-1], "label": w[:, 1:]}


def test_ring_logits_match_jax(jax_side):
    mesh, model, params = jax_side
    toks = _batch(1)["image"]
    ref = jax.jit(model.apply)({"params": params}, jnp.asarray(toks))
    port = _port(params, attention_impl="ring", mesh=MeshConfig(seq=4).build()).eval()
    with torch.inference_mode():
        out = port(torch.from_numpy(toks))
    assert out.shape == (BATCH, SEQ, VOCAB) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_ATOL)


def test_ring_training_step_matches_the_jax_engine(jax_side):
    mesh, model, params = jax_side
    batch = _batch(2)
    loss_fn = jax_lm.make_fused_lm_loss(model)
    engine = JaxTrainEngine(loss_fn, optax.sgd(LR), mesh)
    state = engine.init_state(jax.random.key(1), lambda rng: {"params": params})
    state, metrics = engine.train_step(state, engine.shard_batch(batch))
    before = params_from_jax(jax.tree.map(np.asarray, params))
    ref = params_from_jax(jax.tree.map(np.asarray, state.params))
    # SGD's step is -LR * grad: the JAX gradients, read back from it (to about 1e-6)
    ref_grads = {name: (before[name] - ref[name]) / LR for name in ref}

    port = _port(params, attention_impl="ring", mesh=MeshConfig(seq=4).build())
    port_engine = TrainEngine(make_fused_lm_loss(port))
    port_state = TrainState(model=port, optimizer=torch.optim.SGD(port.parameters(), lr=LR))
    port_state, port_metrics = port_engine.train_step(port_state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(port_metrics["loss"]), float(metrics["loss"]), atol=STEP_ATOL)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(), atol=GRAD_ATOL, err_msg=name)
    for name, value in port.state_dict().items():
        np.testing.assert_allclose(value.numpy(), ref[name].numpy(), atol=STEP_ATOL, err_msg=name)
    assert port_state.step == int(state.step) == 1


@pytest.mark.parametrize("pallas, path", [(True, "flash"), (False, "plain"), (None, "ring")])
def test_pallas_knob_takes_precedence_over_ring(jax_side, pallas, path):
    _, _, params = jax_side
    dispatch.reset()
    toks = torch.from_numpy(_batch(3)["image"])
    with torch.inference_mode():
        got = _port(params, attention_impl="ring", mesh=MeshConfig(seq=4).build(), pallas=pallas).eval()(toks)
        want = _port(params, attention_impl=path, mesh=MeshConfig(seq=4).build()).eval()(toks)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    lm_paths = {r["path"] for r in dispatch.records() if r["model"] == "transformer_lm"}
    # "flash" and "plain" both record under the attention policy; "ring" records itself.
    assert ("ring" in lm_paths) == (path == "ring")
    if path == "plain":
        assert lm_paths == {"plain"}


@pytest.mark.parametrize("spec", ["sp4", "dp2sp2", "sp4x2", "dp8", "dp4sp2", "tp2x4", "fsdp2x2", "dp2fsdp2tp2",
                                  "fsdp8", "ep4x2", "dp2ep2"])
def test_mesh_grammar_matches_jax(spec):
    ref = jax_mesh.mesh_config_from_spec(spec)
    got = mesh_config_from_spec(spec)
    fields = ("data", "fsdp", "pipe", "expert", "seq", "tensor")
    assert tuple(getattr(got, f) for f in fields) == tuple(getattr(ref, f) for f in fields)
    assert ref.pipe == 1


@pytest.mark.parametrize("spec", ["dp2pp2", "pp4x2", "pp2x4", "dp2pp4"])
def test_mesh_grammar_raises_for_axes_still_to_port(spec):
    """The pipe axis, which raised here until the pipeline was ported, now parses as the
    JAX grammar parses it."""
    ref = jax_mesh.mesh_config_from_spec(spec)
    got = mesh_config_from_spec(spec)
    fields = ("data", "fsdp", "pipe", "expert", "seq", "tensor")
    assert tuple(getattr(got, f) for f in fields) == tuple(getattr(ref, f) for f in fields)
    assert got.pipe > 1


def test_mesh_grammar_rejects_what_jax_rejects():
    for spec in ("", "sp", "dp2dp2", "xx4"):
        with pytest.raises(ValueError):
            jax_mesh.mesh_config_from_spec(spec)
        with pytest.raises(ValueError):
            mesh_config_from_spec(spec)


def test_the_entrys_ring_trainer_runs_the_ring_over_the_mesh(monkeypatch, tmp_path):
    """``examples/train_lm.py::RingLMTrainer`` through the entry's ``build_trainer`` with
    ``MESH=sp4``: all four shards in this process, the model's attention the ring (also
    with ``PALLAS=1``, which it does not read), and the first batch's loss equal to the
    entry's own dense model's on the same weights (f32; 2e-5, the ring's forward atol)."""
    from distributed_training_pytorch_tpu_torch.examples import train_lm

    windows = np.random.RandomState(4).randint(0, 256, size=(40, SEQ + 1)).astype(np.int32)
    monkeypatch.setattr(train_lm, "load_windows", lambda seq_len, path=None: windows)
    for knob, value in dict(LM_SIZE="tiny", SEQ_LEN=str(SEQ), BATCH="8", EPOCHS="1", DTYPE="fp32", MESH="sp4",
                            PALLAS="1", SAVE_DIR=str(tmp_path)).items():
        monkeypatch.setenv(knob, value)
    for knob in ("FUSED_CE", "LM_CORPUS", "SNAPSHOT"):
        monkeypatch.delenv(knob, raising=False)
    dispatch.reset()
    ring = train_lm.build_trainer("cpu", trainer_cls=train_lm.RingLMTrainer)
    assert ring.mesh.shape == {"data": 1, "seq": 4} and ring.mesh.seq_local
    assert {r["path"] for r in dispatch.records() if r["model"] == "transformer_lm"} == {"ring"}
    monkeypatch.setenv("PALLAS", "0")
    monkeypatch.delenv("MESH")
    dense = train_lm.build_trainer("cpu")
    dense.model.load_state_dict(ring.model.state_dict())
    batch = ring.to_device(next(iter(ring.train_dataloader)))
    with torch.no_grad():
        got = float(ring.engine.loss_fn(ring.model, batch, False)[0])
        want = float(dense.engine.loss_fn(dense.model, batch, False)[0])
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, atol=2e-5)
