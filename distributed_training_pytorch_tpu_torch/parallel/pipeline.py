"""Pipeline parallelism over the ``pipe`` axis of a mesh.

Counterpart of ``distributed_training_pytorch_tpu/parallel/pipeline.py``
(``stack_stage_params``, ``bubble_fraction``, ``schedule_stats``, ``pipeline_apply``).
The trunk is a stack of ``S * n_virtual`` homogeneous virtual stages whose parameters lead
with ``[S * n_virtual, ...]``; virtual stage ``k`` is chunk ``k // S`` on pipe shard
``k % S`` (the interleaved placement). One schedule of ``T = M * v + S - 1`` ticks runs
every micro-batch through them: at each tick a shard applies one of its stages to its
current activation and passes the result to the next shard; the chunk round-robin advances
every ``S`` ticks, and the last shard's last chunk emits. With ``feed="sharded"`` shard
``d`` holds the micro-batches ``m % S == d`` (after ``first``) and a one-slot ring delivers
each to shard 0 just in time; ``feed="replicated"`` indexes the whole feed there.
``last`` runs over the pipe group's scatter of the emitted outputs when ``M % S == 0``.

The schedule is written once, over the shards this process holds (``Mesh.pipe_shards``),
and one ``torch.autograd.Function`` owns its forward ticks and its reverse tick loop, as
``ring_attention._FlashRing`` owns both of the ring's passes: autograd through
point-to-point hops would not fix the order in which two rings' backward hops run on
different ranks, and mismatched orders deadlock. In the reverse loop each active tick's
stage graph is walked with ``torch.autograd.backward`` (under ``remat`` the stage was run
under ``torch.utils.checkpoint``, so the walk recomputes it), and the input gradient goes
back one hop, in the same order on every rank. Only the hop differs between the two
placements: a hand-over between local stages when one process holds them all (the JAX
package's single controller, and how one card runs the pipeline), and ``batch_isend_irecv``
to the next rank of the pipe group when each rank holds one.

A (shard, tick) pair outside its active window launches nothing: the JAX body applies the
stage to a zero carry there and masks the result, which gives the same outputs and
gradients. So a stage's kernels run exactly once per micro-batch each way (a 12-block trunk
of ``DecoderBlock`` s on the card: K1, K2 and K3 ``12 * M`` times a step, whatever ``S``
and ``v`` are).

As the port's ring does, the op takes the full, replicated inputs and returns the full
``[M, mb, ...]`` output on every rank of the pipe group, and the gradients of its inputs
(the stacked parameters, ``first``'s and ``last``'s parameters, the micro-batches) come
back whole and once-counted on every rank. A parameter that appears in both ``first`` and
``last`` (a tied embedding) receives the sum of its two gradients.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from distributed_training_pytorch_tpu_torch.parallel.mesh import PIPE_AXIS, AxisRing, Mesh

__all__ = ["PIPE_AXIS", "bubble_fraction", "pipeline_apply", "schedule_stats", "stack_stage_params"]

_LATER_ITEM = "ROADMAP.md Queue 1 item 6"


def stack_stage_params(params_list) -> "dict[str, torch.Tensor]":
    """Stack per-stage ``{name: tensor}`` dicts into one ``{name: [n_stages, ...]}`` dict
    (what :func:`pipeline_apply` takes). With ``n_virtual > 1`` pass all ``S * n_virtual``
    virtual stages in network order: virtual stage ``k`` is chunk ``k // S`` on shard
    ``k % S``."""
    params_list = list(params_list)
    return {name: torch.stack([p[name] for p in params_list]) for name in params_list[0]}


def bubble_fraction(n_micro: int, n_stages: int, n_virtual: int = 1) -> float:
    """Idle fraction of the schedule, ``1 - useful_ticks / total_ticks``: every shard is
    busy for ``n_micro * n_virtual`` of the ``n_micro * n_virtual + n_stages - 1`` ticks,
    so in stage-time units the bubble is ``((S-1)/v) / (M + (S-1)/v)``, GPipe's
    ``(S-1)/(M+S-1)`` at ``v=1``."""
    total = n_micro * n_virtual + n_stages - 1
    return 1.0 - (n_micro * n_virtual) / total


def schedule_stats(n_micro: int, n_stages: int, n_virtual: int = 1) -> dict:
    """Count the (shard x tick) grid of the schedule, the counted counterpart of
    :func:`bubble_fraction`: shard ``d`` is active at tick ``t`` iff
    ``0 <= t - d < n_micro * n_virtual``."""
    M, S, v = n_micro, n_stages, n_virtual
    total_ticks = M * v + S - 1
    active = sum(1 for d in range(S) for t in range(total_ticks) if 0 <= t - d < M * v)
    total = S * total_ticks
    return {
        "total_ticks": total_ticks,
        "device_ticks": total,
        "active_device_ticks": active,
        "bubble_fraction": 1.0 - active / total,
    }


def _identity_end(params, x):
    return x


class _Pipe(AxisRing):
    """The ``s`` shards of a mesh's pipe axis and the shards this process holds
    (``shards``). ``hop`` moves a value a shard along the ring (``+1``: shard ``d`` to
    ``d + 1 mod s``) over the list of this process's shards, in the order of ``shards``."""

    @property
    def last_rank(self) -> int:
        return self.ranks[self.s - 1]

    def hop(self, values, direction: int, like: torch.Tensor):
        """Each shard's value (a tensor, or None for nothing) moves one shard along the
        ring. Between ranks a None is sent as zeros of ``like``'s shape, and what comes in
        is always a tensor."""
        if self.local:
            return values[-1:] + values[:-1] if direction > 0 else values[1:] + values[:1]
        return [self.p2p(values[0] if values[0] is not None else torch.zeros_like(like), direction)]


class _Schedule:
    """The tick arithmetic of the JAX body (``pipeline.py:246-293``) for ``M`` micro-batches
    over ``S`` shards of ``v`` chunks."""

    def __init__(self, M: int, S: int, v: int, sharded: bool):
        self.M, self.S, self.v, self.sharded = M, S, v, sharded
        self.VS, self.Mq, self.T = S * v, M // S, M * v + S - 1

    def chunk(self, t: int, d: int):
        """Shard ``d``'s chunk at tick ``t``, or None outside its active window."""
        tau = t - d
        if not 0 <= tau < self.M * self.v:
            return None
        return (tau // self.S) % self.v

    def refill(self, t: int, d: int):
        """The sharded feed's row that shard ``d`` loads into its slot at tick ``t`` (every
        ``S`` ticks), or None."""
        if t % self.S:
            return None
        return min(max((t + d) // self.VS, 0), self.Mq - 1)

    def fed(self, t: int) -> int:
        """The micro-batch shard 0 takes from the replicated feed at tick ``t``."""
        return min(max((t // self.VS) * self.S + t % self.S, 0), self.M - 1)

    def emitted(self, t: int):
        """The micro-batch the last shard's last chunk emits at tick ``t``, or None."""
        e = t - (self.VS - 1)
        if e < 0:
            return None
        e = min(e, self.M * self.v - 1)
        r = e % self.VS
        m = (e // self.VS) * self.S + r
        return m if r < self.S and m < self.M else None


class _PipelineRun(torch.autograd.Function):
    """The trunk's ticks, forward and backward. Inputs: this process's feeds (sharded: one
    ``[M/S, mb, ...]`` a held shard; replicated: the one ``[M, mb, ...]``, which only shard
    0 reads) and the stacked parameters; output: the emitted ``[M, mb, ...]``, real where
    the last shard is held and zeros elsewhere. ``track``: keep each stage's graph for the
    backward (off under ``torch.no_grad``)."""

    @staticmethod
    def forward(ctx, pipe, sched, stage_fn, names, remat, track, n_feeds, *inputs):
        feeds, stacked = list(inputs[:n_feeds]), inputs[n_feeds:]
        S, shards = sched.S, pipe.shards
        like = feeds[0][0]
        wants = [p.requires_grad for p in stacked]
        ring_in = [None] * len(shards)
        slot = [None] * len(shards)
        outputs = torch.zeros((sched.M,) + tuple(like.shape), dtype=like.dtype, device=like.device)
        graphs = {}
        for t in range(sched.T):
            ys = [None] * len(shards)
            for i, d in enumerate(shards):
                if sched.sharded:
                    q = sched.refill(t, d)
                    if q is not None:
                        slot[i] = feeds[i][q]
                c = sched.chunk(t, d)
                if c is None:
                    continue  # outside the active window: nothing is launched
                if d == 0 and c == 0:
                    x = slot[i] if sched.sharded else feeds[0][sched.fed(t)]
                else:
                    x = ring_in[i]
                k = c * S + d
                x_leaf = x.detach().requires_grad_(track)
                leaves = [p.detach()[k].requires_grad_(w and track) for p, w in zip(stacked, wants, strict=True)]
                params = dict(zip(names, leaves, strict=True))
                with torch.set_grad_enabled(track):
                    if remat and track:
                        y = checkpoint(stage_fn, params, x_leaf, use_reentrant=False)
                    else:
                        y = stage_fn(params, x_leaf)
                if y.shape != x.shape:
                    raise ValueError(f"stage_fn must keep the activation's shape: {tuple(x.shape)} -> {tuple(y.shape)}")
                if track:
                    graphs[(t, i)] = (x_leaf, leaves, y)
                ys[i] = y.detach()
                if d == S - 1:
                    m = sched.emitted(t)
                    if m is not None:
                        outputs[m] = ys[i]
            ring_in = pipe.hop(ys, 1, like)
            if sched.sharded:
                slot = pipe.hop(slot, -1, like)
        ctx.pipe, ctx.sched, ctx.graphs = pipe, sched, graphs
        ctx.feed_shapes = [f.shape for f in feeds]
        ctx.like = like
        ctx.stacked_meta = [(p.shape, p.dtype, p.device) for p in stacked]
        return outputs

    @staticmethod
    def backward(ctx, g_out):
        pipe, sched, graphs = ctx.pipe, ctx.sched, ctx.graphs
        S, shards, like = sched.S, pipe.shards, ctx.like
        g_feeds = [torch.zeros(shape, dtype=like.dtype, device=like.device) for shape in ctx.feed_shapes]
        g_stacked = [torch.zeros(shape, dtype=dtype, device=dev) for shape, dtype, dev in ctx.stacked_meta]
        g_ring = [None] * len(shards)  # the gradient of ring_in at tick t + 1, before its hop back
        g_slot = [None] * len(shards)  # the gradient of the slot entering tick t + 1
        for t in reversed(range(sched.T)):
            if t < sched.T - 1:
                g_y = pipe.hop(g_ring, -1, like)
                g_used = pipe.hop(g_slot, 1, like) if sched.sharded else [None] * len(shards)
            else:
                g_y, g_used = [None] * len(shards), [None] * len(shards)
            g_ring, g_slot = [None] * len(shards), [None] * len(shards)
            for i, d in enumerate(shards):
                gy, gs = g_y[i], g_used[i]
                if d == S - 1:
                    m = sched.emitted(t)
                    if m is not None:
                        gy = g_out[m] if gy is None else gy + g_out[m]
                c = sched.chunk(t, d)
                if c is not None:
                    x_leaf, leaves, y = graphs.pop((t, i))
                    if gy is not None and y.requires_grad:
                        torch.autograd.backward(y, gy)
                    k = c * S + d
                    for g, leaf in zip(g_stacked, leaves, strict=True):
                        if leaf.grad is not None:
                            g[k] += leaf.grad
                    gx = x_leaf.grad
                    if not (d == 0 and c == 0):
                        g_ring[i] = gx
                    elif gx is not None and sched.sharded:
                        gs = gx if gs is None else gs + gx
                    elif gx is not None:
                        g_feeds[0][sched.fed(t)] += gx
                if sched.sharded:
                    q = sched.refill(t, d)
                    if q is None:
                        g_slot[i] = gs
                    elif gs is not None:
                        g_feeds[i][q] += gs
        ctx.graphs = None
        return (None, None, None, None, None, None, None, *g_feeds, *g_stacked)


# -- the collectives around the trunk between ranks (the JAX shard_map's in/out specs) --


class _SumGrads(torch.autograd.Function):
    """Tensors replicated over the pipe group, each used by part of the computation on
    each rank: the identity forward, and one all-reduce of all their gradients backward
    (the transpose of a replicated ``shard_map`` input). One node, so one collective, in
    the same place on every rank."""

    @staticmethod
    def forward(ctx, pipe, *xs):
        ctx.pipe = pipe
        ctx.metas = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(s, dtype=dt, device=dev) if g is None else g
              for g, (s, dt, dev) in zip(gs, ctx.metas, strict=True)]
        by_dtype: "dict[torch.dtype, list[int]]" = {}
        for j, g in enumerate(gs):
            by_dtype.setdefault(g.dtype, []).append(j)
        out = list(gs)
        for idx in by_dtype.values():
            flat = torch.cat([gs[j].reshape(-1) for j in idx])
            dist.all_reduce(flat, group=ctx.pipe.group)
            for j, part in zip(idx, flat.split([gs[j].numel() for j in idx]), strict=True):
                out[j] = part.view_as(gs[j])
        return (None, *out)


class _TakeShard(torch.autograd.Function):
    """This rank's feed rows ``x[d::S]`` of the replicated ``[M, ...]`` micro-batches; the
    gradient is every rank's rows gathered back into ``[M, ...]``."""

    @staticmethod
    def forward(ctx, x, pipe):
        ctx.pipe = pipe
        return x[pipe.shards[0]::pipe.s].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _interleave(_all_gather(g, ctx.pipe)), None


class _ScatterFromLast(torch.autograd.Function):
    """The last shard's emitted ``[M, ...]`` scattered over the pipe group: rank ``d`` gets
    rows ``d::S`` (the JAX ``psum_scatter`` of outputs that are zero off the last shard).
    The gradient goes back to the last rank (zeros elsewhere)."""

    @staticmethod
    def forward(ctx, x, pipe):
        ctx.pipe = pipe
        mine = torch.empty_like(x[pipe.shards[0]::pipe.s])
        parts = [x[j::pipe.s].contiguous() for j in range(pipe.s)] if pipe.shards[0] == pipe.s - 1 else None
        dist.scatter(mine, parts, src=pipe.last_rank, group=pipe.group)
        return mine

    @staticmethod
    def backward(ctx, g):
        pipe = ctx.pipe
        g = g.contiguous()
        is_last = pipe.shards[0] == pipe.s - 1
        parts = [torch.empty_like(g) for _ in range(pipe.s)] if is_last else None
        dist.gather(g, parts, dst=pipe.last_rank, group=pipe.group)
        if not is_last:
            return torch.zeros((g.shape[0] * pipe.s,) + tuple(g.shape[1:]), dtype=g.dtype, device=g.device), None
        return _interleave(parts), None


class _FromLast(torch.autograd.Function):
    """The last shard's emitted outputs on every rank of the pipe group (the JAX ``psum`` of
    outputs that are zero off the last shard). Every rank then computes the same loss from
    them, so the incoming gradient is replicated: each rank keeps its own (the last rank's
    reaches the emission), counted once."""

    @staticmethod
    def forward(ctx, x, pipe):
        x = x.contiguous().clone()
        dist.broadcast(x, src=pipe.last_rank, group=pipe.group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherStrided(torch.autograd.Function):
    """Each rank's ``[M/S, ...]`` rows ``d::S`` gathered into the full ``[M, ...]`` on
    every rank; each rank's gradient is its rows of the (replicated) incoming gradient."""

    @staticmethod
    def forward(ctx, x, pipe):
        ctx.pipe = pipe
        return _interleave(_all_gather(x, pipe))

    @staticmethod
    def backward(ctx, g):
        pipe = ctx.pipe
        return g[pipe.shards[0]::pipe.s].contiguous(), None


def _all_gather(x, pipe: _Pipe) -> "list[torch.Tensor]":
    parts = [torch.empty_like(x) for _ in range(pipe.s)]
    dist.all_gather(parts, x.contiguous(), group=pipe.group)
    return parts


def _interleave(parts) -> torch.Tensor:
    """``S`` tensors of rows ``j::S`` -> the ``[M, ...]`` they are the strided parts of."""
    stacked = torch.stack(parts, dim=1)  # [M/S, S, ...]: row [q, j] is micro-batch q * S + j
    return stacked.reshape((-1,) + tuple(stacked.shape[2:]))


def _per_micro(fn, params, x) -> torch.Tensor:
    """``fn(params, m)`` for each micro-batch ``m`` of ``x``, stacked: the JAX ``vmap``."""
    return torch.stack([fn(params, m) for m in x])


def pipeline_apply(
    stage_params: "dict[str, torch.Tensor]",
    microbatches: torch.Tensor,
    stage_fn: "Callable[[dict, torch.Tensor], torch.Tensor]",
    mesh: Mesh,
    *,
    axis: str = PIPE_AXIS,
    n_virtual: int = 1,
    feed: str = "auto",
    first: "tuple[dict, Callable] | None" = None,
    last: "tuple[dict, Callable] | None" = None,
    remat: bool = False,
    extra_manual_axes: "tuple[str, ...]" = (),
    stage_param_specs=None,
) -> torch.Tensor:
    """Run ``microbatches`` through the pipelined (virtual-)stage stack.

    ``stage_params``: ``{name: tensor}`` whose tensors lead with ``[S * n_virtual, ...]``
    (``S`` the mesh's ``axis`` extent). ``microbatches``: ``[M, mb, ...]`` inputs of the
    first stage (of ``first`` when given), the same on every rank of the pipe group.
    ``stage_fn(params_slice, x) -> y`` with ``y.shape == x.shape``, ``params_slice`` a
    ``{name: tensor}`` dict of one stage (for a module:
    ``torch.func.functional_call(block, params_slice, (x,))``). ``n_virtual``: chunks per
    shard (``> 1`` needs ``M % S == 0``). ``feed``: ``"sharded"`` (needs ``M % S == 0``),
    ``"replicated"`` or ``"auto"`` (sharded when divisible). ``first=(params, fn)`` runs
    over each shard's feed before the ring (``fn(params, mb) -> x0`` may change the
    trailing shape); ``last=(params, fn)`` over the emitted outputs after it, sharded over
    the pipe group when ``M % S == 0``. ``remat``: each stage application under
    ``torch.utils.checkpoint`` (the backward recomputes it).

    ``extra_manual_axes`` and ``stage_param_specs`` (the JAX package's data x expert x pipe
    composition) are not ported: a non-empty value raises ``NotImplementedError``.

    Returns the ``[M, mb, ...]`` outputs of the last virtual stage (after ``last`` if
    given) on every rank of the pipe group. Differentiable: see the module docstring."""
    if extra_manual_axes or stage_param_specs is not None:
        raise NotImplementedError(
            f"pipeline_apply(extra_manual_axes=..., stage_param_specs=...), the pipe axis beside the expert axis, is "
            f"not ported ({_LATER_ITEM})"
        )
    pipe = _Pipe(mesh, axis)
    S = pipe.s
    v = int(n_virtual)
    if v < 1:
        raise ValueError(f"n_virtual must be >= 1, got {v}")
    M = microbatches.shape[0]
    if M < 1:
        raise ValueError("need at least one microbatch")
    VS = S * v
    names = list(stage_params)
    stacked = [stage_params[n] for n in names]
    lead = stacked[0].shape[0]
    if lead != VS:
        raise ValueError(
            f"stage_params lead with {lead} stages but mesh axis {axis!r} has {S} devices x {v} virtual chunks = {VS}"
        )
    if v > 1 and M % S:
        raise ValueError(
            f"interleaved schedule (n_virtual={v}) needs n_micro % {S} == 0, got n_micro={M} — the chunk round-robin "
            "advances in groups of S"
        )
    if feed == "auto":
        feed = "sharded" if M % S == 0 else "replicated"
    if feed not in ("sharded", "replicated"):
        raise ValueError(f"feed must be sharded/replicated/auto, got {feed!r}")
    if feed == "sharded" and M % S:
        raise ValueError(f"sharded feed needs n_micro % {S} == 0, got {M}")
    sharded = feed == "sharded"
    first_params, first_fn = first if first is not None else ({}, _identity_end)
    last_params, last_fn = last if last is not None else ({}, _identity_end)
    sharded_head = last is not None and M % S == 0

    if not pipe.local:
        # The replicated inputs each rank uses a part of: their gradients are summed over
        # the pipe group, in one collective (only those that require grad: the same set on
        # every rank). `last` over all the outputs is replicated work whose gradients are
        # whole on every rank already.
        slots = [(stacked, j) for j in range(len(stacked))]
        first_params, last_params = dict(first_params), dict(last_params)
        slots += [(first_params, k) for k in first_params]
        if sharded_head:
            slots += [(last_params, k) for k in last_params]
        holder = {"micro": microbatches}
        if not sharded:
            slots.append((holder, "micro"))
        slots = [(box, key) for box, key in slots if box[key].requires_grad]
        if slots:
            for (box, key), x in zip(slots, _SumGrads.apply(pipe, *(box[key] for box, key in slots)), strict=True):
                box[key] = x
        microbatches = holder["micro"]

    # Each held shard's feed, `first` applied before the ring (shard 0 alone reads a
    # replicated feed; between ranks every rank applies it, as the JAX body does).
    if not sharded:
        rows = [microbatches]
    elif pipe.local:
        rows = [microbatches[d::S] for d in pipe.shards]
    else:
        rows = [_TakeShard.apply(microbatches, pipe)]
    feeds = [_per_micro(first_fn, first_params, r) for r in rows]

    sched = _Schedule(M, S, v, sharded)
    track = torch.is_grad_enabled()
    out = _PipelineRun.apply(pipe, sched, stage_fn, names, bool(remat), track, len(feeds), *feeds, *stacked)
    if sharded_head:
        mine = [out[d::S] for d in pipe.shards] if pipe.local else [_ScatterFromLast.apply(out, pipe)]
        done = [_per_micro(last_fn, last_params, m) for m in mine]
        return _interleave(done) if pipe.local else _GatherStrided.apply(done[0], pipe)
    if not pipe.local:
        out = _FromLast.apply(out, pipe)
    if last is not None:
        out = _per_micro(last_fn, last_params, out)
    return out
