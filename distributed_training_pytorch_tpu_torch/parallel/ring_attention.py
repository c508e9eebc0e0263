"""Sequence parallelism: exact ring attention and Ulysses attention over the ``seq`` axis
of a mesh.

Counterpart of ``distributed_training_pytorch_tpu/parallel/ring_attention.py``
(``ring_attention``, ``_block_attn``, the dense ring and the flash ring with its
ring-level custom VJP, ``ulysses_attention``). Each of the ``s`` sequence shards keeps its q rows while the k/v
blocks travel one hop around the ring per step, and the per-block results merge by the
online softmax; the sequence is ``[B, T, H, D]`` with ``T`` divisible by ``s``.

* ``impl="dense"``: each step materialises the ``[B, H, Tq, Tk]`` block logits in plain
  PyTorch, differentiated by autograd.
* ``impl="flash"``: each step runs K5 (``ops.flash_attention.flash_block_fwd`` /
  ``flash_block_bwd``: the flash kernels on CUDA tensors) and merges the blocks' lse with
  ``logaddexp``; the backward is a second, reverse ring in which dq stays home and dk/dv
  ride the ring with their blocks, all accumulated in f32. One ``torch.autograd.Function``
  owns both rings; autograd never sees inside the kernels. Under ``causal``, a block whose
  owner comes after the q shard is skipped and launches nothing, so a ring launches
  ``s(s+1)/2`` blocks each way.
* ``impl="auto"``: the port's dispatch policy (``ops/dispatch.py``): flash for CUDA
  tensors, dense for CPU tensors, recorded as a ``kernel_dispatch`` decision. (The JAX
  package picks flash on a TPU above a per-shard T tuned there.)

The schedule is written once, over the shards this process holds (``Mesh.seq_shards``).
Only the hop differs between the two placements: a hand-over between local shards when
one process holds them all (the JAX package's single controller, and how one card runs
the ring), and ``batch_isend_irecv`` to the next rank of the seq group when each rank
holds one. In both, the op takes the full ``[B, T, H, D]`` (replicated over the seq
group, as the JAX op takes a global array) and returns the full output: a rank computes
its shard, and the outputs are gathered. The gradient crosses that boundary the other way:
each rank takes its slice of the incoming (replicated) gradient, and the shards' dq, dk
and dv are gathered back, so every rank holds the whole, once-counted gradient of the
replicated inputs.

:func:`ulysses_attention` (DeepSpeed-Ulysses) trades the sequence shards for head groups:
shard ``j`` gets the whole sequence of heads ``j * H/s`` to ``(j + 1) * H/s``, attends
over it densely, and trades back. In the one-process placement a head group is a view of
the full tensors (``[B, T, H/s, D]`` with the full tensor's strides, which the wgmma
kernels' TMA reads in place for ``D`` a multiple of 8); between ranks the trade is
``all_to_all_single`` over the seq group, whose gradient is the reverse trade. Each head
group's attention is ``ops.flash_attention.flash_attention`` (K1 forward, K2 and K3
backward: ``s`` launches of each a call) or the plain block of the dense ring.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from distributed_training_pytorch_tpu_torch.ops import dispatch
from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa
from distributed_training_pytorch_tpu_torch.parallel.mesh import SEQ_AXIS, AxisRing, Mesh

__all__ = ["ring_attention", "ulysses_attention"]

_NEG_INF = -1e30
_SKIP, _DIAGONAL, _VISIBLE = 0, 1, 2


def _block_attn(q, k, v, scale, bias=None):
    """One q block x k block: ``(unnormalised o, row max, row sum of exp)`` for the online
    merge, in f32 (``o`` ``[B, Tq, H, D]``, the statistics ``[B, H, Tq]``)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if bias is not None:
        logits = logits + bias
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).float()
    return o, m, l


def _block_type(owner: int, me: int, causal: bool) -> int:
    """Causal classification of the block ``owner`` visiting q shard ``me``: its keys all
    come after the shard's queries (skip), share their positions (diagonal: causal within
    the block), or all come before them (fully visible)."""
    if not causal:
        return _VISIBLE
    return _DIAGONAL if owner == me else (_VISIBLE if owner < me else _SKIP)


class _Hop(torch.autograd.Function):
    """One hop along the ring between ranks (to the next, from the previous); its
    gradient takes the hop back. Counterpart of ``lax.ppermute`` and its transpose."""

    @staticmethod
    def forward(ctx, x, ring, direction):
        ctx.ring, ctx.direction = ring, direction
        return ring.p2p(x, direction)

    @staticmethod
    def backward(ctx, g):
        return ctx.ring.p2p(g, -ctx.direction), None, None


class _Scatter(torch.autograd.Function):
    """This rank's shard of a tensor replicated over the seq group; the gradient of the
    replicated input is the shards' gradients gathered (whole, each counted once)."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return ring.local_slice(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.ring.all_gather(g), None


class _Gather(torch.autograd.Function):
    """The shards gathered into the full tensor on every rank; each rank's gradient is its
    slice of the (replicated) incoming gradient."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return ring.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.ring.local_slice(g), None


class _Ring(AxisRing):
    """The ``s`` shards of a sequence over a mesh's seq axis, and the shards this process
    holds (``shards``). ``split``, ``hop`` and ``gather`` act on the list of this
    process's shards, in the order of ``shards``; they are differentiable."""

    def __init__(self, mesh: Mesh, t: int, axis: str = SEQ_AXIS):
        super().__init__(mesh, axis)
        if t % self.s:
            raise ValueError(f"sequence length {t} is not divisible by the {self.s} shards of the {axis} axis")
        self.t_local = t // self.s

    def rows(self, shard: int) -> slice:
        return slice(shard * self.t_local, (shard + 1) * self.t_local)

    # -- between ranks ------------------------------------------------------

    def local_slice(self, x):
        return x[:, self.rows(self.shards[0])].contiguous()

    def all_gather(self, x):
        parts = [torch.empty_like(x) for _ in range(self.s)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=1)

    # -- over this process's shards ----------------------------------------

    def split(self, x):
        """``x`` ``[B, T, ...]`` -> this process's shards ``[B, T/s, ...]`` (views when
        it holds them all)."""
        if self.local:
            return [x[:, self.rows(j)] for j in self.shards]
        return [_Scatter.apply(x, self)]

    def hop(self, blocks):
        """Each shard's block moves to the next shard (``i -> i+1 mod s``)."""
        if self.local:
            return blocks[-1:] + blocks[:-1]
        return [_Hop.apply(blocks[0], self, 1)]

    def gather(self, parts):
        """This process's shards -> the full ``[B, T, ...]`` tensor."""
        if self.local:
            return torch.cat(parts, dim=1)
        return _Gather.apply(parts[0], self)


def _dense_ring(q, k, v, ring: _Ring, causal: bool):
    scale = q.shape[-1] ** -0.5
    qs, k_blk, v_blk = ring.split(q), ring.split(k), ring.split(v)
    tl = ring.t_local
    pos = torch.arange(tl, device=q.device)
    acc = []
    for step in range(ring.s):
        if step:
            k_blk, v_blk = ring.hop(k_blk), ring.hop(v_blk)
        for i, me in enumerate(ring.shards):
            bias = None
            if causal:
                owner = (me - step) % ring.s
                visible = (me * tl + pos)[:, None] >= (owner * tl + pos)[None, :]
                bias = torch.where(visible, 0.0, _NEG_INF)[None, None]
            o_b, m_b, l_b = _block_attn(qs[i], k_blk[i], v_blk[i], scale, bias)
            if step == 0:
                acc.append((o_b, m_b, l_b))
                continue
            o, m, l = acc[i]
            m_new = torch.maximum(m, m_b)  # the online-softmax merge
            alpha, beta = torch.exp(m - m_new), torch.exp(m_b - m_new)
            o = o * alpha.transpose(1, 2)[..., None] + o_b * beta.transpose(1, 2)[..., None]
            acc[i] = (o, m_new, l * alpha + l_b * beta)
    outs = [(o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]).to(q.dtype) for o, _, l in acc]
    return ring.gather(outs)


def _flash_ring_fwd(qs, ks, vs, ring: _Ring, causal: bool):
    """The forward ring over this process's q shards: ``(o, lse)`` per shard, ``o`` in
    the input dtype and ``lse`` f32 ``[B, H, T/s]``."""
    accs = []
    k_blk, v_blk = list(ks), list(vs)
    for step in range(ring.s):
        if step:
            k_blk, v_blk = ring.hop(k_blk), ring.hop(v_blk)
        for i, me in enumerate(ring.shards):
            kind = _block_type((me - step) % ring.s, me, causal)
            if kind == _SKIP:
                # A skipped block is o = 0, lse = -1e30: merging it leaves (o, lse) as they
                # are, bit for bit (exp(-1e30 - lse) is 0), so nothing is merged or launched.
                continue
            o_b, lse_b = fa.flash_block_fwd(qs[i], k_blk[i], v_blk[i], causal=kind == _DIAGONAL)
            if step == 0:  # the own block, never skipped: its merge into (0, -1e30) is exact
                accs.append((o_b.float(), lse_b))
                continue
            o, lse = accs[i]
            lse_new = torch.logaddexp(lse, lse_b)
            w_old = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
            w_new = torch.exp(lse_b - lse_new).transpose(1, 2)[..., None]
            accs[i] = (o * w_old + o_b.float() * w_new, lse_new)
    return [o.to(qs[0].dtype) for o, _ in accs], [lse for _, lse in accs]


def _flash_ring_bwd(qs, ks, vs, gs, os_, lses, ring: _Ring, causal: bool):
    """The reverse ring: per shard ``(dq, dk, dv)`` in the input dtype. dq accumulates at
    home; dk/dv accumulate on f32 buffers that travel with their k/v blocks and come home
    after one more hop."""
    deltas = [(g.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous() for g, o in zip(gs, os_, strict=True)]
    f32 = torch.float32
    k_blk, v_blk = list(ks), list(vs)
    dq = [torch.zeros(q.shape, dtype=f32, device=q.device) for q in qs]
    dk = [torch.zeros(k.shape, dtype=f32, device=k.device) for k in ks]
    dv = [torch.zeros(v.shape, dtype=f32, device=v.device) for v in vs]
    for step in range(ring.s):
        if step:
            k_blk, v_blk = ring.hop(k_blk), ring.hop(v_blk)
            dk, dv = ring.hop(dk), ring.hop(dv)
        for i, me in enumerate(ring.shards):
            kind = _block_type((me - step) % ring.s, me, causal)
            if kind == _SKIP:  # contributes zeros
                continue
            dq_c, dk_c, dv_c = fa.flash_block_bwd(
                qs[i], k_blk[i], v_blk[i], gs[i], lses[i], deltas[i], causal=kind == _DIAGONAL
            )
            dq[i] = dq[i] + dq_c.float()
            dk[i] = dk[i] + dk_c.float()
            dv[i] = dv[i] + dv_c.float()
    if ring.s > 1:  # s - 1 hops so far; one more brings each dk/dv block home
        dk, dv = ring.hop(dk), ring.hop(dv)
    dtype = qs[0].dtype
    return [x.to(dtype) for x in dq], [x.to(dtype) for x in dk], [x.to(dtype) for x in dv]


class _FlashRing(torch.autograd.Function):
    """The flash ring, forward and backward: the counterpart of the ``custom_vjp`` around
    the JAX package's two shard_maps (``ring_attention.py:305-316``)."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal):
        qs, ks, vs = ring.split(q), ring.split(k), ring.split(v)
        os_, lses = _flash_ring_fwd(qs, ks, vs, ring, causal)
        o = ring.gather(os_)
        ctx.ring, ctx.causal = ring, causal
        ctx.save_for_backward(q, k, v, o, *lses)
        return o

    @staticmethod
    def backward(ctx, g):
        ring = ctx.ring
        q, k, v, o, *lses = ctx.saved_tensors
        qs, ks, vs, os_, gs = (ring.split(x) for x in (q, k, v, o, g))
        dq, dk, dv = _flash_ring_bwd(qs, ks, vs, gs, os_, lses, ring, ctx.causal)
        return ring.gather(dq), ring.gather(dk), ring.gather(dv), None, None


def ring_attention(q, k, v, mesh: Mesh, *, causal: bool = False, impl: str = "auto"):
    """Exact attention over a sequence split on the mesh's ``seq`` axis: ``[B, T, H, D]``
    in, ``[B, T, H, D]`` out (scale ``D**-0.5``); ``T`` must divide by the axis extent.
    Differentiable. ``impl``: ``"dense"``, ``"flash"`` or ``"auto"`` (see the module
    docstring)."""
    if impl not in ("auto", "dense", "flash"):
        raise ValueError(f"impl must be auto|dense|flash, got {impl!r}")
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"expected matching [B,T,H,D] q/k/v, got {q.shape}/{k.shape}/{v.shape}")
    ring = _Ring(mesh, q.shape[1])
    if impl == "auto":
        if q.device.type == "cuda":
            impl, reason = "flash", "auto: cuda tensors -> K5 on the flash kernels"
        else:
            impl, reason = "dense", f"auto: {q.device.type} tensors -> the dense ring"
    else:
        reason = f"impl={impl}"
    dispatch.record("ring_attention", "ring_block", impl, reason=reason, seq_shards=ring.s)
    if impl == "flash":
        return _FlashRing.apply(q, k, v, ring, causal)
    return _dense_ring(q, k, v, ring, causal)


# -- Ulysses -------------------------------------------------------------------------


def _seq_to_heads(x, ring: _Ring):
    """``[B, T/s, H, D]`` (this rank's sequence shard, every head) -> ``[B, T, H/s, D]``
    (the whole sequence of this rank's head group): one ``all_to_all_single``."""
    b, tl, h, d = x.shape
    s = ring.s
    send = x.reshape(b, tl, s, h // s, d).permute(2, 0, 1, 3, 4).contiguous()  # [s, B, T/s, H/s, D]
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=ring.group)  # recv[i]: shard i's rows of my heads
    return recv.permute(1, 0, 2, 3, 4).reshape(b, s * tl, h // s, d)


def _heads_to_seq(x, ring: _Ring):
    """The reverse trade: ``[B, T, H/s, D]`` -> ``[B, T/s, H, D]``."""
    b, t, hs, d = x.shape
    s = ring.s
    send = x.reshape(b, s, t // s, hs, d).permute(1, 0, 2, 3, 4).contiguous()  # [s, B, T/s, H/s, D]
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=ring.group)  # recv[i]: head group i of my rows
    return recv.permute(1, 2, 0, 3, 4).reshape(b, t // s, s * hs, d)


class _SeqToHeads(torch.autograd.Function):
    """The trade of sequence shards for head groups between ranks; its gradient is the
    reverse trade (the transpose of ``lax.all_to_all``)."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return _seq_to_heads(x, ring)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.ring), None


class _HeadsToSeq(torch.autograd.Function):
    """The trade back of head groups for sequence shards; its gradient is the forward
    trade."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return _heads_to_seq(x, ring)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.ring), None


def ulysses_attention(q, k, v, mesh: Mesh, *, axis: str = SEQ_AXIS, causal: bool = False,
                      use_flash: "bool | None" = None):
    """DeepSpeed-Ulysses sequence parallelism: ``[B, T, H, D]`` in and out (scale
    ``D**-0.5``), ``T`` split on ``axis``, ``H`` divisible by its extent; each head group
    attends over the whole sequence (see the module docstring). ``use_flash``: True runs
    each head group through ``flash_attention`` (the kernels on CUDA tensors, their plain
    versions on CPU tensors), False through the plain block, None picks by device: flash
    for CUDA tensors, plain for CPU tensors, recorded as a ``kernel_dispatch`` decision (the
    JAX package picks flash on a TPU above a sequence length tuned there).
    Differentiable."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r}")
    s = mesh.shape[axis]
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"expected matching [B,T,H,D] q/k/v, got {q.shape}/{k.shape}/{v.shape}")
    if q.shape[2] % s:
        raise ValueError(f"num_heads {q.shape[2]} not divisible by seq devices {s}")
    ring = _Ring(mesh, q.shape[1], axis)
    flash = use_flash
    if flash is None:
        flash = q.device.type == "cuda"
        reason = f"auto: {q.device.type} tensors -> {'the flash kernels' if flash else 'the plain block'}"
    else:
        reason = f"use_flash={flash}"
    dispatch.record("ulysses_attention", "attention", "flash" if flash else "plain", reason=reason, seq_shards=s)
    scale = q.shape[-1] ** -0.5

    def attend(qh, kh, vh):
        if flash:
            return fa.flash_attention(qh, kh, vh, causal=causal)
        bias = None
        if causal:
            pos = torch.arange(qh.shape[1], device=qh.device)
            bias = torch.where(pos[:, None] >= pos[None, :], 0.0, _NEG_INF)[None, None]
        o, _, l = _block_attn(qh, kh, vh, scale, bias)
        return (o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]).to(q.dtype)

    if ring.local:  # every head group here: a view of the full tensors, whole sequence
        hs = q.shape[2] // s
        groups = [slice(j * hs, (j + 1) * hs) for j in range(s)]
        return torch.cat([attend(q[:, :, g], k[:, :, g], v[:, :, g]) for g in groups], dim=2)
    qh, kh, vh = (_SeqToHeads.apply(ring.split(x)[0], ring) for x in (q, k, v))
    return ring.gather([_HeadsToSeq.apply(attend(qh, kh, vh), ring)])
