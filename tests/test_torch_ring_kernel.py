"""K5, the ring's block entry points (``ops/flash_attention.py::flash_block_fwd`` /
``flash_block_bwd``, over the CUDA kernels of ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu``), against their plain PyTorch version, and the flash ring against
the dense ring (f32) and against the kernels over the whole sequence (bf16), on the card.

Every test here carries the ``cuda`` marker and skips without a card: the kernels have no
CPU mode. This file imports neither JAX nor the JAX package, so it runs where only the
port is installed:

    python -m pytest --noconftest tests/test_torch_ring_kernel.py -m cuda -q

Tolerances: f32 (TF32 off) 1e-4 on o and lse, 2e-4 on the gradients (the same f32 sums in
other orders); bf16 2e-2 of the largest magnitude (each side rounds its outputs, and p and
ds before their products, to bf16, and may land one bf16 ulp apart).
"""

import pytest
import torch

from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa
from distributed_training_pytorch_tpu_torch.parallel import MeshConfig, ring_attention


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels behind K5 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, atol_f32):
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=atol_f32, rtol=0)
    else:
        bound = 2e-2 * ref.float().abs().max().item()
        assert (got.float() - ref.float()).abs().max().item() <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_block_entry_points_match_plain(cuda_device, causal, dtype):
    """One ring block at Tq = Tk = 1024 (the diagonal block causal, a visible block not),
    its backward given an external lse/delta: a q shard's global statistics."""
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    b, t, h, d = 2, 1024, 4, 64
    q, k, v, do = (torch.randn(b, t, h, d, device=cuda_device, generator=gen).to(dtype) for _ in range(4))
    before = dict(fa.launches)
    o, lse = fa.flash_block_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches["fwd"] == before["fwd"] + 1  # K5's launches count under K1-K3's names
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal=causal)
    _close(o, o_ref, 1e-4)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    glse = lse_ref + torch.rand(b, h, t, device=cuda_device, generator=gen)
    delta = 0.1 * torch.randn(b, h, t, device=cuda_device, generator=gen)
    grads = fa.flash_block_bwd(q, k, v, do, glse, delta, causal=causal)
    torch.cuda.synchronize()
    assert (fa.launches["bwd_dq"], fa.launches["bwd_dkv"]) == (before["bwd_dq"] + 1, before["bwd_dkv"] + 1)
    refs = fa.flash_attention_bwd_plain(q, k, v, None, glse, do, causal=causal, delta=delta)
    for g, r in zip(grads, refs, strict=True):
        assert g.dtype == dtype and torch.isfinite(g.float()).all()
        _close(g, r, 2e-4)


def _ring_and_grads(x, causal, attention):
    q, k, v = (t.clone().requires_grad_() for t in x[:3])
    fa.reset_launches()
    o = attention(q, k, v)
    o.backward(x[3])
    torch.cuda.synchronize()
    return [o.detach(), q.grad, k.grad, v.grad], dict(fa.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_flash_ring_matches_dense_ring(cuda_device, causal):
    """Four shards on the card, f32: the flash ring (K5 on the kernels) against the dense
    ring, forward and gradients, with 10 (causal) or 16 block launches each way."""
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    mesh = MeshConfig(seq=4).build()
    x = [torch.randn(2, 1024, 4, 64, device=cuda_device, generator=gen) for _ in range(4)]
    blocks = 10 if causal else 16
    flash, launches = _ring_and_grads(x, causal, lambda q, k, v: ring_attention(q, k, v, mesh, causal=causal, impl="flash"))
    assert launches == {"fwd": blocks, "bwd_dq": blocks, "bwd_dkv": blocks}
    dense, launches = _ring_and_grads(x, causal, lambda q, k, v: ring_attention(q, k, v, mesh, causal=causal, impl="dense"))
    assert launches == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
    for got, ref in zip(flash, dense, strict=True):
        assert torch.isfinite(got).all()
        _close(got, ref, 2e-4)


@pytest.mark.cuda
def test_bf16_flash_ring_matches_flash_attention(cuda_device):
    """bf16, causal, four shards: the ring against the kernels run once over the whole
    sequence (the dense ring rounds its logits to bf16, which neither kernel path does)."""
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    mesh = MeshConfig(seq=4).build()
    x = [torch.randn(2, 1024, 4, 64, device=cuda_device, generator=gen).to(torch.bfloat16) for _ in range(4)]
    ring, launches = _ring_and_grads(x, True, lambda q, k, v: ring_attention(q, k, v, mesh, causal=True))
    assert launches == {"fwd": 10, "bwd_dq": 10, "bwd_dkv": 10}
    full, launches = _ring_and_grads(x, True, lambda q, k, v: fa.flash_attention(q, k, v, causal=True))
    assert launches == {"fwd": 1, "bwd_dq": 1, "bwd_dkv": 1}
    for got, ref in zip(ring, full, strict=True):
        assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
        _close(got, ref, 2e-4)


@pytest.mark.cuda
def test_auto_ring_launches_the_kernels(cuda_device):
    """On CUDA tensors "auto" is the flash ring: no quiet fall-back to the dense one."""
    q = torch.randn(1, 512, 2, 64, device=cuda_device, dtype=torch.bfloat16)
    fa.reset_launches()
    ring_attention(q, q, q, MeshConfig(seq=4).build(), causal=True)
    torch.cuda.synchronize()
    assert fa.launches["fwd"] == 10
