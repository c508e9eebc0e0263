"""The port's pipeline (``distributed_training_pytorch_tpu_torch/parallel/pipeline.py``)
with all four pipe shards in one process, held against the JAX package's
``pipeline_apply`` on a ``{pipe: 4}`` mesh of the virtual CPU devices.

The same inputs, from numpy with a seed, go to both; stacked stage weights reach the port
through ``models.convert.stage_params_from_jax``. Every JAX reference (output and
``jax.grad`` of ``sum(out * w)``) is computed once, on first use, through a module-scoped
fixture: a JAX ``pipeline_apply`` compile takes seconds here.

Tolerances, f32: forward atol 1e-5 (DecoderBlocks 2e-4) and gradients atol 2e-4, as
``tests/test_pipeline.py`` holds the JAX pipeline against sequential stages; ``remat``
within 1e-5 of no ``remat`` (the same arithmetic, recomputed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu.parallel import mesh as jax_mesh
from distributed_training_pytorch_tpu.parallel import pipeline as jax_pipeline
from distributed_training_pytorch_tpu_torch.models.convert import block_params_from_jax, stage_params_from_jax
from distributed_training_pytorch_tpu_torch.parallel import (
    MeshConfig,
    bubble_fraction,
    pipeline_apply,
    schedule_stats,
    stack_stage_params,
)
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


FWD_ATOL, BLOCK_ATOL, GRAD_ATOL, REMAT_ATOL = 1e-5, 2e-4, 2e-4, 1e-5
D, HIDDEN, VOCAB, S = 8, 16, 16, 4

# name: (virtual stages, n_virtual, micro-batches, feed, first/last)
CASES = {
    "v1-sharded": (4, 1, 8, "sharded", False),
    "v1-replicated": (4, 1, 6, "replicated", False),
    "v2-sharded": (8, 2, 8, "sharded", False),
    "v2-replicated": (8, 2, 8, "replicated", False),
    "ends-sharded-head": (4, 1, 8, "sharded", True),
    "ends-replicated": (4, 1, 6, "replicated", True),
    "single-microbatch": (4, 1, 1, "auto", False),
}


def _jax_stage(p, x):
    return x + jax.nn.gelu(x @ p["w1"]) @ p["w2"]


def _port_stage(p, x):
    return x + torch.nn.functional.gelu(x @ p["w1"], approximate="tanh") @ p["w2"]


def _case_inputs(name):
    n, _, m, _, ends = CASES[name]
    rng = np.random.RandomState(len(name))
    stages = {"w1": rng.randn(n, D, HIDDEN).astype(np.float32) * 0.2,
              "w2": rng.randn(n, HIDDEN, D).astype(np.float32) * 0.2}
    arrays = {"stages": stages, "w": rng.randn(m, 2, 3, VOCAB if ends else D).astype(np.float32)}
    if ends:
        arrays["ids"] = rng.randint(0, VOCAB, size=(m, 2, 3)).astype(np.int32)
        arrays["embed"] = rng.randn(VOCAB, D).astype(np.float32) * 0.3
        arrays["head"] = rng.randn(D, VOCAB).astype(np.float32) * 0.3
    else:
        arrays["micro"] = rng.randn(m, 2, 3, D).astype(np.float32)
    return arrays


def _jax_case(name, mesh):
    _, v, _, feed, ends = CASES[name]
    a = _case_inputs(name)

    def loss(stages, micro, embed, head):
        kw = {}
        if ends:  # the embedding and the tied head: `embed` in both ends
            kw = dict(first=({"t": embed}, lambda p, ids: p["t"][ids]),
                      last=({"w": head, "t": embed}, lambda p, x: x @ p["w"] + x @ p["t"].T))
        out = jax_pipeline.pipeline_apply(stages, micro, _jax_stage, mesh, n_virtual=v, feed=feed, **kw)
        return jnp.sum(out * a["w"]), out

    micro = a["ids"] if ends else a["micro"]
    embed, head = a.get("embed", np.zeros(1, np.float32)), a.get("head", np.zeros(1, np.float32))
    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 2, 3) if ends else (0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, a["stages"]), jnp.asarray(micro), jnp.asarray(embed), jnp.asarray(head))
    return np.asarray(out), jax.tree.map(np.asarray, grads)


def _port_case(name, mesh, remat=False, grads=True):
    _, v, _, feed, ends = CASES[name]
    a = _case_inputs(name)
    stages = {k: t.requires_grad_() for k, t in stage_params_from_jax(a["stages"]).items()}
    kw, extra = {}, []
    if ends:
        embed, head = (torch.tensor(a[k], requires_grad=True) for k in ("embed", "head"))
        kw = dict(first=({"t": embed}, lambda p, ids: p["t"][ids.long()]),
                  last=({"w": head, "t": embed}, lambda p, x: x @ p["w"] + x @ p["t"].T))
        micro, extra = torch.from_numpy(a["ids"]), [embed, head]
    else:
        micro = torch.tensor(a["micro"], requires_grad=True)
        extra = [micro]
    out = pipeline_apply(stages, micro, _port_stage, mesh, n_virtual=v, feed=feed, remat=remat, **kw)
    if not grads:
        return out.numpy(), None
    grad = torch.autograd.grad((out * torch.from_numpy(a["w"])).sum(), [*stages.values(), *extra])
    return out.detach().numpy(), [g.numpy() for g in grad]


def _jax_blocks(mesh):
    from distributed_training_pytorch_tpu.models import DecoderBlock

    block = DecoderBlock(num_heads=2, mlp_dim=16, attention_impl="plain")
    rng = np.random.RandomState(6)
    x0 = jnp.asarray(rng.randn(3, 10, 8), jnp.float32)
    stacked = jax_pipeline.stack_stage_params([block.init(jax.random.key(i), x0)["params"] for i in range(4)])
    micro = rng.randn(5, 3, 10, 8).astype(np.float32)
    w = rng.randn(*micro.shape).astype(np.float32)

    def loss(stacked, micro):
        out = jax_pipeline.pipeline_apply(stacked, micro, lambda p, x: block.apply({"params": p}, x), mesh)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(stacked, jnp.asarray(micro))
    return {"stacked": jax.tree.map(np.asarray, stacked), "micro": micro, "w": w, "out": np.asarray(out),
            "grads": jax.tree.map(np.asarray, grads)}


@pytest.fixture(scope="module")
def jax_refs():
    """Each JAX reference, computed on first use and kept for the module: a worker that
    runs some of the module's tests compiles only theirs."""
    mesh = jax_mesh.create_mesh({jax_mesh.PIPE_AXIS: S}, devices=jax.devices()[:S])
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _jax_blocks(mesh) if name == "blocks" else _jax_case(name, mesh)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def port_mesh():
    return MeshConfig(pipe=S).build()


def _flat_grads(name, grads):
    """The JAX grads of ``_jax_case`` in the port's order: w1, w2, then the micro-batches
    or the embedding and head."""
    stages, *rest = grads
    return [stages["w1"], stages["w2"], *rest]


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_matches_jax_forward_and_gradients(jax_refs, port_mesh, name):
    ref_out, ref_grads = jax_refs(name)
    out, grads = _port_case(name, port_mesh)
    np.testing.assert_allclose(out, ref_out, atol=FWD_ATOL)
    with torch.no_grad():  # the same forward, keeping no stage's graph
        np.testing.assert_array_equal(_port_case(name, port_mesh, grads=False)[0], out)
    for i, (got, want) in enumerate(zip(grads, _flat_grads(name, ref_grads), strict=True)):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, err_msg=f"{name} grad {i}")


@pytest.mark.parametrize("name", ["v1-sharded", "v2-replicated", "ends-sharded-head"])
def test_remat_matches_no_remat(port_mesh, name):
    out, grads = _port_case(name, port_mesh)
    out_r, grads_r = _port_case(name, port_mesh, remat=True)
    np.testing.assert_allclose(out_r, out, atol=REMAT_ATOL)
    for got, want in zip(grads_r, grads, strict=True):
        np.testing.assert_allclose(got, want, atol=REMAT_ATOL)


def test_decoder_blocks_as_stages_match_jax(jax_refs, port_mesh):
    """Four DecoderBlocks (``attention_impl="plain"``) as the stages, their weights
    carried over by ``stage_params_from_jax(..., block_params_from_jax)``; each stage runs
    ``torch.func.functional_call`` of one template block."""
    from distributed_training_pytorch_tpu_torch.models import DecoderBlock

    ref = jax_refs("blocks")
    block = DecoderBlock(8, 2, 16, attention_impl="plain", device="cpu")
    stacked = {k: t.requires_grad_() for k, t in stage_params_from_jax(ref["stacked"], block_params_from_jax).items()}
    micro = torch.tensor(ref["micro"], requires_grad=True)
    out = pipeline_apply(stacked, micro, lambda p, x: torch.func.functional_call(block, p, (x,)), port_mesh)
    np.testing.assert_allclose(out.detach().numpy(), ref["out"], atol=BLOCK_ATOL)
    grads = torch.autograd.grad((out * torch.from_numpy(ref["w"])).sum(), [*stacked.values(), micro])
    want = stage_params_from_jax(ref["grads"][0], block_params_from_jax)
    for (name, got) in zip(stacked, grads, strict=False):
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), atol=GRAD_ATOL, err_msg=name)
    np.testing.assert_allclose(grads[-1].numpy(), ref["grads"][1], atol=GRAD_ATOL)


def _refusal(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_refusals_match_jax(port_mesh):
    jmesh = jax_mesh.create_mesh({jax_mesh.PIPE_AXIS: S}, devices=jax.devices()[:S])
    rng = np.random.RandomState(0)
    three, four, eight = ({"w1": rng.randn(n, D, D).astype(np.float32), "w2": rng.randn(n, D, D).astype(np.float32)}
                          for n in (3, 4, 8))
    # 3 stages on 4 shards; n_virtual=2 with M % S != 0; a sharded feed with M % S != 0; a feed
    # that is neither sharded nor replicated
    for stages, m, kw in [(three, 2, {}), (eight, 6, {"n_virtual": 2}), (four, 6, {"feed": "sharded"}),
                          (four, 4, {"feed": "ring"})]:
        micro = np.ones((m, 2, D), np.float32)
        want = _refusal(lambda: jax_pipeline.pipeline_apply(jax.tree.map(jnp.asarray, stages), jnp.asarray(micro),
                                                            _jax_stage, jmesh, **kw))
        got = _refusal(lambda: pipeline_apply({k: torch.from_numpy(v) for k, v in stages.items()},
                                              torch.from_numpy(micro), _port_stage, port_mesh, **kw))
        assert got == want
    stages = {k: torch.from_numpy(v) for k, v in four.items()}
    for kw in ({"extra_manual_axes": ("expert",)}, {"stage_param_specs": {"w1": None, "w2": None}}):
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            pipeline_apply(stages, torch.ones(4, 2, D), _port_stage, port_mesh, **kw)


def test_schedule_arithmetic_matches_jax():
    for m in (1, 3, 4, 8, 12):
        for s in (1, 2, 4):
            for v in (1, 2, 3):
                assert bubble_fraction(m, s, v) == jax_pipeline.bubble_fraction(m, s, v)
                assert schedule_stats(m, s, v) == jax_pipeline.schedule_stats(m, s, v)
    assert np.isclose(bubble_fraction(8, 4, 2), 3 / 19) and bubble_fraction(8, 4, 2) < bubble_fraction(8, 4, 1)


def test_stack_stage_params_matches_jax():
    rng = np.random.RandomState(3)
    stages = [{"w1": rng.randn(2, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)} for _ in range(4)]
    want = jax_pipeline.stack_stage_params([jax.tree.map(jnp.asarray, st) for st in stages])
    got = stack_stage_params([{k: torch.from_numpy(v) for k, v in st.items()} for st in stages])
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_pipeline_training_step_through_engine(port_mesh):
    """The port's ``TrainEngine`` trains through ``pipeline_apply``: the stacked stage
    params are module parameters, the loss routes the batch through the pipe, and 25 Adam
    steps halve the loss (``tests/test_pipeline.py::test_pipeline_training_step_through_engine``)."""
    from distributed_training_pytorch_tpu_torch.train import TrainEngine, TrainState

    rng = np.random.RandomState(12)

    class Piped(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w1 = torch.nn.Parameter(torch.tensor(rng.randn(4, D, HIDDEN) * 0.2, dtype=torch.float32))
            self.w2 = torch.nn.Parameter(torch.tensor(rng.randn(4, HIDDEN, D) * 0.2, dtype=torch.float32))
            self.head = torch.nn.Parameter(torch.tensor(rng.randn(D, 1) * 0.3, dtype=torch.float32))

    def loss_fn(model, batch, train):
        out = pipeline_apply({"w1": model.w1, "w2": model.w2}, batch["image"], _port_stage, port_mesh)
        loss = torch.mean(((out @ model.head)[..., 0] - batch["label"]) ** 2)
        return loss, {"loss": loss}

    model = Piped()
    engine = TrainEngine(loss_fn, mesh=port_mesh)
    state = TrainState(model=model, optimizer=torch.optim.Adam(model.parameters(), lr=3e-3))
    batch = {"image": torch.tensor(rng.randn(6, 4, D), dtype=torch.float32),
             "label": torch.tensor(rng.randn(6, 4), dtype=torch.float32)}
    losses = []
    for _ in range(25):
        state, metrics = engine.train_step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.5, losses


@pytest.mark.parametrize("pipe, n_virtual, remat", [(2, 1, False), (1, 2, True)])
def test_pipelined_lm_matches_the_lm(pipe, n_virtual, remat):
    """``models/pipelined_lm.py``: an LMTiny's weights laid out over the pipe axis give the
    LM's loss and, mapped back by ``lm_state_dict``, every gradient of the LM (f32, 1e-6:
    the same arithmetic, each weight gradient summed over micro-batches)."""
    from distributed_training_pytorch_tpu_torch.models import LMTiny
    from distributed_training_pytorch_tpu_torch.models.pipelined_lm import PipelinedLM, lm_logits_loss

    rng = np.random.RandomState(19)
    batch = {k: torch.from_numpy(rng.randint(0, 256, size=(8, 32))) for k in ("image", "label")}
    lm = LMTiny(device="cpu")
    piped = PipelinedLM(lm, MeshConfig(pipe=pipe).build(), n_micro=4, n_virtual=n_virtual, remat=remat)
    losses, grads = [], []
    for model in (lm, piped):
        loss, _ = lm_logits_loss(model, batch, True)
        names, params = zip(*model.named_parameters())
        losses.append(float(loss.detach()))
        grads.append(dict(zip(names, torch.autograd.grad(loss, params), strict=True)))
    np.testing.assert_allclose(losses[1], losses[0], atol=1e-6)
    got = piped.lm_state_dict(grads[1])
    assert set(got) == set(grads[0])
    for name, want in grads[0].items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), atol=1e-6, err_msg=name)
