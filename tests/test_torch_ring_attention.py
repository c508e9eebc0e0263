"""The port's ring attention (``distributed_training_pytorch_tpu_torch/parallel/
ring_attention.py``) with all four sequence shards in one process, and its block entry
points K5 (``ops/flash_attention.py::flash_block_fwd``/``flash_block_bwd``), held against
the JAX package's ``ring_attention`` on a ``{seq: 4}`` mesh of the virtual CPU devices and
its ``flash_block_fwd``/``flash_block_bwd`` (Pallas in interpret mode).

The same inputs, from numpy with a seed, go to both. The port's ``"flash"`` ring runs the
plain K5 here (CPU tensors), the JAX ``"flash"`` ring its interpret-mode K5; each
``"dense"`` ring its own block softmax. Tolerances, f32: forward atol 2e-5, as
``tests/test_parallel.py`` holds JAX's flash ring against its dense ring; gradients atol
5e-4, as it holds their gradients (blockwise sums over the ring in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu.ops import pallas as jax_pallas
from distributed_training_pytorch_tpu.parallel import mesh as jax_mesh
from distributed_training_pytorch_tpu.parallel import ring_attention as jax_ring_attention
from distributed_training_pytorch_tpu_torch.ops import dispatch
from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa
from distributed_training_pytorch_tpu_torch.parallel import MeshConfig, ring_attention

FWD_ATOL, GRAD_ATOL = 2e-5, 5e-4
SHAPE = (2, 32, 4, 8)  # B, T, H, D: shards of 8 rows on a ring of 4


def _inputs(shape, seed, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def jax_seq_mesh():
    return jax_mesh.create_mesh({jax_mesh.SEQ_AXIS: 4}, devices=jax.devices()[:4])


def _port_ring(arrays, mesh, **kw):
    q, k, v, w = (torch.from_numpy(a) for a in arrays)
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    o = ring_attention(q, k, v, mesh, **kw)
    grads = torch.autograd.grad((o * w).sum(), (q, k, v))
    return o.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_ring_matches_jax_ring_forward_and_gradients(jax_seq_mesh, impl, causal):
    arrays = _inputs(SHAPE, seed=3 + causal)

    def loss(q, k, v, w):
        o = jax_ring_attention(q, k, v, jax_seq_mesh, causal=causal, impl=impl)
        return jnp.sum(o * w), o

    (_, ref_o), ref_grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *map(jnp.asarray, arrays)
    )
    o, grads = _port_ring(arrays, MeshConfig(seq=4).build(), causal=causal, impl=impl)
    np.testing.assert_allclose(o, np.asarray(ref_o), atol=FWD_ATOL)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref_grads, strict=True):
        np.testing.assert_allclose(got, np.asarray(want), atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_ring_of_one_shard_is_flash_attention(impl, causal):
    arrays = _inputs((2, 24, 3, 8), seed=9)
    o, grads = _port_ring(arrays, MeshConfig(seq=1).build(), causal=causal, impl=impl)
    q, k, v, w = (torch.from_numpy(a).requires_grad_(i < 3) for i, a in enumerate(arrays))
    ref = fa.flash_attention(q, k, v, causal=causal)
    ref_grads = torch.autograd.grad((ref * w).sum(), (q, k, v))
    np.testing.assert_allclose(o, ref.detach().numpy(), atol=FWD_ATOL)
    for got, want in zip(grads, ref_grads, strict=True):
        np.testing.assert_allclose(got, want.numpy(), atol=GRAD_ATOL)


@pytest.mark.parametrize("tq, tk, causal", [(24, 40, False), (40, 16, False), (32, 32, True)])
def test_block_entry_points_match_jax(tq, tk, causal):
    """K5 at Tq != Tk, with an external lse/delta standing for a q shard's global
    statistics (the block's own lse plus an offset, as after a merge with other blocks)."""
    b, h, d = 2, 3, 8
    rng = np.random.RandomState(tq + tk)
    q, do = (rng.randn(b, tq, h, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, tk, h, d).astype(np.float32) for _ in range(2))
    ref_o, ref_lse = jax_pallas.flash_block_fwd(*map(jnp.asarray, (q, k, v)), causal=causal)
    o, lse = fa.flash_block_fwd(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), atol=FWD_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=FWD_ATOL)
    glse = np.asarray(ref_lse) + rng.uniform(0.1, 1.0, size=(b, h, tq)).astype(np.float32)
    delta = rng.randn(b, h, tq).astype(np.float32) * 0.1
    ref = jax_pallas.flash_block_bwd(*map(jnp.asarray, (q, k, v, do, glse, delta)), causal=causal)
    got = fa.flash_block_bwd(*map(torch.from_numpy, (q, k, v, do, glse, delta)), causal=causal)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref, strict=True):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL, err_msg=name)


def test_sequence_not_divisible_by_the_ring_raises_in_both(jax_seq_mesh):
    q = _inputs((1, 30, 2, 8), seed=1, n=1)[0]
    with pytest.raises(ValueError):
        jax_ring_attention(*(jnp.asarray(q),) * 3, jax_seq_mesh)
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention(*(torch.from_numpy(q),) * 3, MeshConfig(seq=4).build())


@pytest.mark.parametrize("causal, blocks", [(True, 10), (False, 16)])
def test_flash_ring_calls_k5_once_per_visible_block(monkeypatch, causal, blocks):
    """A causal ring of s = 4 skips the blocks that come after their q shard: s(s+1)/2 =
    10 block calls each way; a non-causal ring makes all s^2 = 16."""
    calls = {"fwd": [], "bwd": []}
    block_fwd, block_bwd = fa.flash_block_fwd, fa.flash_block_bwd

    def counted_fwd(q, k, v, *, causal):
        calls["fwd"].append(causal)
        return block_fwd(q, k, v, causal=causal)

    def counted_bwd(q, k, v, do, lse, delta, *, causal):
        calls["bwd"].append(causal)
        return block_bwd(q, k, v, do, lse, delta, causal=causal)

    monkeypatch.setattr(fa, "flash_block_fwd", counted_fwd)
    monkeypatch.setattr(fa, "flash_block_bwd", counted_bwd)
    before = dict(fa.launches)
    _port_ring(_inputs(SHAPE, seed=2), MeshConfig(seq=4).build(), causal=causal, impl="flash")
    assert len(calls["fwd"]) == len(calls["bwd"]) == blocks
    # the 4 diagonal blocks run causal within the block; the others see every key
    assert sum(calls["fwd"]) == sum(calls["bwd"]) == (4 if causal else 0)
    assert fa.launches == before  # CPU tensors launch no kernel


def test_auto_resolves_by_device_and_is_recorded():
    dispatch.reset()
    arrays = _inputs(SHAPE, seed=4)
    auto, _ = _port_ring(arrays, MeshConfig(seq=4).build(), causal=True)
    dense, _ = _port_ring(arrays, MeshConfig(seq=4).build(), causal=True, impl="dense")
    np.testing.assert_array_equal(auto, dense)
    paths = {(r["model"], r["path"]) for r in dispatch.records()}
    assert ("ring_attention", "dense") in paths and ("ring_attention", "flash") not in paths
    with pytest.raises(ValueError, match="impl"):
        ring_attention(*(torch.zeros(1, 8, 1, 8),) * 3, MeshConfig(seq=4).build(), impl="ulysses")
