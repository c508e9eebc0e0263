"""The port's Ulysses attention (``parallel/ring_attention.py::ulysses_attention``) with all
four sequence shards in one process, held against the JAX package's ``ulysses_attention``
on a ``{seq: 4}`` mesh of the virtual CPU devices, against the port's own ring, and its
flash route (the plain wrappers on CPU tensors) against its plain block.

The same inputs, from numpy with a seed, go to both. Tolerances, f32: forward atol 2e-5,
as ``tests/test_parallel.py`` holds JAX's Ulysses against dense attention and the ring;
q/k/v gradients atol 1e-4 (sums over the whole sequence in another order); flash against
plain 2e-4, as ``tests/test_parallel.py`` holds the two JAX routes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu.parallel import mesh as jax_mesh
from distributed_training_pytorch_tpu.parallel.ring_attention import ulysses_attention as jax_ulysses
from distributed_training_pytorch_tpu_torch.ops import dispatch
from distributed_training_pytorch_tpu_torch.parallel import MeshConfig, ring_attention, ulysses_attention
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


FWD_ATOL, GRAD_ATOL, ROUTE_ATOL = 2e-5, 1e-4, 2e-4
SHAPE = (2, 32, 8, 8)  # B, T, H, D: two heads a group on 4 shards


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*SHAPE).astype(np.float32) for _ in range(4)]


def _port(fn, arrays, **kw):
    q, k, v, w = (torch.from_numpy(a) for a in arrays)
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    o = fn(q, k, v, MeshConfig(seq=4).build(), **kw)
    grads = torch.autograd.grad((o * w).sum(), (q, k, v))
    return o.detach().numpy(), [g.numpy() for g in grads]


@pytest.fixture(scope="module")
def jax_refs():
    mesh = jax_mesh.create_mesh({jax_mesh.SEQ_AXIS: 4}, devices=jax.devices()[:4])
    refs = {}
    for causal in (False, True):
        arrays = _inputs(5 + causal)

        def loss(q, k, v, w, causal=causal):
            o = jax_ulysses(q, k, v, mesh, causal=causal, use_flash=False)
            return jnp.sum(o * w), o

        (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(*map(jnp.asarray, arrays))
        refs[causal] = (arrays, np.asarray(o), [np.asarray(g) for g in grads])
    return refs


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax_forward_and_gradients(jax_refs, causal):
    arrays, ref_o, ref_grads = jax_refs[causal]
    dispatch.reset()
    o, grads = _port(ulysses_attention, arrays, causal=causal)
    np.testing.assert_allclose(o, ref_o, atol=FWD_ATOL)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref_grads, strict=True):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, err_msg=name)
    (decision,) = [r for r in dispatch.records() if r["model"] == "ulysses_attention"]
    assert decision["path"] == "plain" and decision["seq_shards"] == 4  # auto on CPU tensors


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_the_ring(causal):
    arrays = _inputs(7)
    o, grads = _port(ulysses_attention, arrays, causal=causal)
    ring_o, ring_grads = _port(ring_attention, arrays, causal=causal, impl="dense")
    np.testing.assert_allclose(o, ring_o, atol=FWD_ATOL)
    for got, want in zip(grads, ring_grads, strict=True):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL)


def test_ulysses_flash_route_matches_plain_on_cpu_tensors():
    for causal in (False, True):
        arrays = _inputs(11 + causal)
        o_f, g_f = _port(ulysses_attention, arrays, causal=causal, use_flash=True)
        o_p, g_p = _port(ulysses_attention, arrays, causal=causal, use_flash=False)
        np.testing.assert_allclose(o_f, o_p, atol=ROUTE_ATOL)
        for got, want in zip(g_f, g_p, strict=True):
            np.testing.assert_allclose(got, want, atol=ROUTE_ATOL)


def test_ulysses_rejects_a_head_count_the_shards_do_not_divide():
    q = np.zeros((1, 64, 6, 4), np.float32)
    jmesh = jax_mesh.create_mesh({jax_mesh.SEQ_AXIS: 4}, devices=jax.devices()[:4])
    with pytest.raises(ValueError) as want:
        jax_ulysses(*(jnp.asarray(q),) * 3, jmesh)
    with pytest.raises(ValueError) as got:
        ulysses_attention(*(torch.from_numpy(q),) * 3, MeshConfig(seq=4).build())
    assert str(got.value) == str(want.value) == "num_heads 6 not divisible by seq devices 4"
    with pytest.raises(ValueError, match="mesh has no axis 'rows'"):
        ulysses_attention(*(torch.from_numpy(q),) * 3, MeshConfig(seq=4).build(), axis="rows")
