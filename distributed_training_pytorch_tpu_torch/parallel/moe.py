"""Expert parallelism: a GShard-style Mixture-of-Experts FFN layer.

Counterpart of ``distributed_training_pytorch_tpu/parallel/moe.py``: top-k softmax gating
with a fixed per-expert capacity, two dispatch routes with the same routing, a
capacity-free decode, the Switch load-balance and router-z losses, and the expert axis
over ``torch.distributed``. The JAX layer is einsum algebra outside any Pallas kernel, so
this one is ``torch.einsum``, top-k, sorts and scatters too: no hand kernel.

Routing (the JAX ``_route_group``): per group of ``sg`` tokens, each expert takes at most
``capacity = max(1, ceil(sg * top_k / E * capacity_factor))`` of them. Capacity is claimed
choice-major (choice 0 of every token before any choice 1), in token order within a
choice; a choice past its expert's capacity is dropped (the other choice and the residual
still carry the token), and the kept gates of a token are renormalised to sum to 1.
``argmax`` takes the first maximal index, as JAX's does.

* ``dispatch_impl="einsum"``: the dispatch mask and the combine weights ``[G, sg, E, C]``
  and two einsums. The one-hot products run exactly as in JAX (their FLOPs are counted);
  the tensors grow as ``sg**2``.
* ``dispatch_impl="sort"``: a stable ``argsort`` of the choice-major expert ids, a
  ``cummax`` of the run starts for the positions, dropped entries to a trash row at
  ``E * C``, ``index_add`` into the ``[E, C, d]`` buffers and a gather back.
* ``dispatch_impl="auto"``: ``sort`` from :data:`SORT_DISPATCH_MIN_GROUP` tokens a group,
  ``einsum`` below; the group size is shape-derived, so the choice is static.

Everything is static in shape: no ``nonzero``, no boolean indexing, no host read. So the
layer runs on the meta device (the FLOP count and the memory preflight), inside a CUDA
graph (chained steps, the decode graph) and without a host sync.

Precision, as JAX rounds: the router is an f32 linear with a bias on f32 tokens and the
gates an f32 softmax; the expert weights are f32 parameters cast to the compute dtype at
each call; the dispatch one-hots and combine weights are cast to the compute dtype before
their einsums; the experts' activation is the tanh gelu (``jax.nn.gelu``).

:class:`MoEMlp.forward` returns ``(y, aux)`` with ``aux`` the two auxiliary losses of this
call, ``{"load_balance_loss", "router_z_loss"}`` (``None`` in decode): the caller adds them
to its objective. Nothing is kept on the module, which a graph capture would freeze.

**The expert axis.** ``parallel/layout.py`` splits ``w_in``/``w_out`` on dim 0 over the
expert group and sets :attr:`MoEMlp.expert_split`. The forward is then the ``psum`` form
that the JAX GSPMD path amounts to when the batch is not split over ``expert``: every rank
of the group holds the same tokens and computes the routing in full; it runs its local
experts on their slice of the dispatch; the partial outputs are summed over the group.
Two conjugate autograd functions bound that region: its inputs (the tokens and the gates)
pass through an identity whose backward all-reduces over the group, its output through an
all-reduce whose backward is the identity. The router, the auxiliary losses and everything
outside the layer stay replicated, with the same gradient on every rank of the group.

:func:`manual_expert_mlp` is the JAX function of that name over a process group: the
canonical GShard exchange (``all_to_all``: each rank routes its share of the groups, one
``all_to_all_single`` sends the dispatch buffers to the experts' ranks and one brings the
outputs back) or the ``psum`` form (:func:`manual_expert_ffn_local`).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from distributed_training_pytorch_tpu_torch.parallel.layout import (
    ExpertSplit,
    _all_gather,
    _CopyToTensorRegion,
    _GatherFn,
    _ReduceFromTensorRegion,
    _Split,
)

__all__ = [
    "MoEMlp",
    "SORT_DISPATCH_MIN_GROUP",
    "capacity_for",
    "load_balance_loss",
    "manual_expert_ffn_local",
    "manual_expert_mlp",
    "route_groups",
    "router_z_loss",
    "sort_dispatch",
]

# Group size (tokens) from which "auto" takes the sort route. The JAX constant (4096) is a
# v5e crossover; this one is the H100's, from chip_smoke.py's moe phase (PERF.md §6): at
# GPT-2-small's width, E=8, top-2, bf16, fwd+bwd of 16,384 tokens, sort was faster at every
# group size timed (1024: 4.57 against 5.04 ms; 16384: 4.21 against 30.42); below 1024 is
# not measured.
SORT_DISPATCH_MIN_GROUP = 1024

DISPATCH_IMPLS = ("auto", "einsum", "sort")


def router_z_loss(logits: torch.Tensor) -> torch.Tensor:
    """The mean squared log-partition of the router logits (ST-MoE eq. 5), in f32."""
    z = torch.logsumexp(logits.float(), dim=-1)
    return (z**2).mean()


def load_balance_loss(gates: torch.Tensor, dispatch_mask: torch.Tensor) -> torch.Tensor:
    """Switch-Transformer load balance: ``E * sum_e f_e * p_e``, ``f_e`` the fraction of
    tokens whose first choice is expert ``e`` (``dispatch_mask`` ``[S, E]``) and ``p_e``
    the mean gate probability."""
    f = dispatch_mask.float().mean(dim=0)
    p = gates.float().mean(dim=0)
    return gates.shape[-1] * (f * p).sum()


def capacity_for(group_size: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Each expert's buffer rows in a group of ``group_size`` tokens (the JAX formula)."""
    return max(1, int(math.ceil(group_size * top_k / num_experts * capacity_factor)))


def resolve_dispatch(dispatch_impl: str, group_size: int) -> str:
    """``"auto"`` to ``"sort"`` from :data:`SORT_DISPATCH_MIN_GROUP` tokens a group, else
    ``"einsum"``; an explicit route as it is; anything else raises ``ValueError``."""
    if dispatch_impl not in DISPATCH_IMPLS:
        raise ValueError(f"dispatch_impl must be auto|einsum|sort, got {dispatch_impl!r}")
    if dispatch_impl == "auto":
        return "sort" if group_size >= SORT_DISPATCH_MIN_GROUP else "einsum"
    return dispatch_impl


# -- routing ----------------------------------------------------------------


def _choices(gates: torch.Tensor, capacity: int, top_k: int) -> list:
    """Per choice, ``(expert [G, sg], position [G, sg], kept [G, sg], gate [G, sg])`` of
    ``[G, sg, E]`` gates: the einsum route's claim order (``_route_group``)."""
    e = gates.shape[-1]
    remaining = gates.detach()
    used = torch.zeros(gates.shape[0], e, dtype=torch.long, device=gates.device)
    out = []
    for _ in range(top_k):
        choice = remaining.argmax(dim=-1)
        onehot = F.one_hot(choice, e)
        pos = ((onehot.cumsum(dim=1) - onehot) * onehot).sum(dim=-1) + used.gather(1, choice)
        keep = pos < capacity
        gate = gates.gather(-1, choice[..., None])[..., 0] * keep
        used = used + (onehot * keep[..., None]).sum(dim=1)
        remaining = remaining * (1.0 - onehot)
        out.append((choice, pos, keep, gate))
    return out


def route_groups(gates: torch.Tensor, *, capacity: int, top_k: int):
    """The einsum route's routing of ``[G, sg, E]`` gates: ``(dispatch, combine)``, the
    bool dispatch mask and the f32 combine weights, both ``[G, sg, E, C]``. The combine is
    differentiable in the gates; each kept choice's weight is its gate over the sum of the
    token's kept gates (at least 1e-9), exactly as JAX divides."""
    g, sg, e = gates.shape
    choices = _choices(gates, capacity, top_k)
    gate_sum = choices[0][3]
    for c in choices[1:]:
        gate_sum = gate_sum + c[3]
    denom = torch.clamp(gate_sum, min=1e-9)
    trash = e * capacity  # a dropped choice's slot, cut off below
    slots = torch.stack([torch.where(keep, choice * capacity + pos, trash) for choice, pos, keep, _ in choices], -1)
    weights = torch.stack([gate / denom for *_, gate in choices], -1)
    dispatch = torch.zeros(g, sg, trash + 1, dtype=torch.bool, device=gates.device)
    dispatch.scatter_(-1, slots, True)
    combine = torch.zeros(g, sg, trash + 1, dtype=torch.float32, device=gates.device).scatter(-1, slots, weights)
    return dispatch[..., :trash].unflatten(-1, (e, capacity)), combine[..., :trash].unflatten(-1, (e, capacity))


def sort_dispatch(gates: torch.Tensor, tokens: torch.Tensor, *, capacity: int, top_k: int, dtype: torch.dtype):
    """The sort route's dispatch of ``[G, sg, d]`` tokens by ``[G, sg, E]`` gates:
    ``(expert_in [G, E, C, d], rows [G, k * sg], weights [G, k * sg])``, ``rows`` each
    choice-major entry's row of the flat ``[E * C]`` buffer (``E * C`` when dropped) and
    ``weights`` its renormalised kept gate."""
    g, sg, e = gates.shape
    d = tokens.shape[-1]
    gate_vals, choice = torch.topk(gates, top_k, dim=-1)  # [G, sg, k]
    ex_flat = choice.transpose(1, 2).reshape(g, top_k * sg)  # choice-major
    order = torch.argsort(ex_flat, dim=-1, stable=True)
    sorted_ex = ex_flat.gather(-1, order)
    ar = torch.arange(top_k * sg, device=gates.device).expand(g, -1)
    starts = torch.ones_like(sorted_ex, dtype=torch.bool)
    starts[:, 1:] = sorted_ex[:, 1:] != sorted_ex[:, :-1]
    pos_sorted = ar - torch.where(starts, ar, 0).cummax(dim=-1).values
    pos = torch.empty_like(pos_sorted).scatter_(-1, order, pos_sorted)
    keep = pos < capacity
    gate_kept = gate_vals * keep.view(g, top_k, sg).transpose(1, 2)
    weight = gate_kept / torch.clamp(gate_kept.sum(dim=-1, keepdim=True), min=1e-9)
    trash = e * capacity
    rows = torch.where(keep, ex_flat * capacity + pos, trash)
    src = tokens.to(dtype).repeat(1, top_k, 1)  # token_idx = tile(arange(sg), k)
    flat_rows = (rows + torch.arange(g, device=rows.device)[:, None] * (trash + 1)).reshape(-1)
    buf = torch.zeros(g * (trash + 1), d, dtype=dtype, device=tokens.device).index_add(0, flat_rows, src.reshape(-1, d))
    expert_in = buf.view(g, trash + 1, d)[:, :trash].unflatten(1, (e, capacity))
    return expert_in, rows, weight.transpose(1, 2).reshape(g, top_k * sg)


def _sort_combine(expert_out, rows, weights, *, top_k: int, lo: int, dtype):
    """Each kept entry's row of ``expert_out`` ``[G, E_local, C, d]`` (experts ``lo`` on)
    times its weight, summed over a token's choices -> ``[G, sg, d]``; an entry dropped or
    on another rank's experts adds 0."""
    g, e_loc, capacity, d = expert_out.shape
    flat = expert_out.reshape(g, e_loc * capacity, d)
    local = rows - lo * capacity
    mine = (local >= 0) & (local < e_loc * capacity)
    picked = flat.gather(1, local.clamp(0, e_loc * capacity - 1)[..., None].expand(-1, -1, d))
    contrib = picked * mine[..., None] * weights.to(dtype)[..., None]
    return contrib.view(g, top_k, -1, d).sum(dim=1)


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu is the tanh form


def _expert_ffn(tokens, gates, w_in, w_out, *, capacity: int, top_k: int, impl: str, lo: int, dtype):
    """The routed FFN of experts ``lo .. lo + E_local`` (``w_in`` ``[E_local, d, h]``,
    ``w_out`` ``[E_local, h, d]``) over ``[G, sg, d]`` tokens and ``[G, sg, E]`` gates:
    this rank's part of the output ``[G, sg, d]`` (the whole output when it holds every
    expert)."""
    e_loc = w_in.shape[0]
    if impl == "sort":
        expert_in, rows, weights = sort_dispatch(gates, tokens, capacity=capacity, top_k=top_k, dtype=dtype)
        expert_in = expert_in[:, lo : lo + e_loc]
    else:
        dispatch, combine = route_groups(gates, capacity=capacity, top_k=top_k)
        dispatch = dispatch[:, :, lo : lo + e_loc].to(dtype)
        expert_in = torch.einsum("gsec,gsd->gecd", dispatch, tokens.to(dtype))
    h = _gelu(torch.einsum("gecd,edh->gech", expert_in, w_in.to(dtype)))
    expert_out = torch.einsum("gech,ehd->gecd", h, w_out.to(dtype))
    if impl == "sort":
        return _sort_combine(expert_out, rows, weights, top_k=top_k, lo=lo, dtype=dtype)
    return torch.einsum("gsec,gecd->gsd", combine[:, :, lo : lo + e_loc].to(dtype), expert_out)


# -- the expert group ----------------------------------------------------------
# The region's conjugate pair is the tensor-parallel one of parallel/layout.py (Megatron's f
# and g): the same collectives over the expert group.


def _copy_to_experts(group, *xs):
    """Identity forward; each gradient all-reduced over the expert group (each rank's
    backward saw its own experts' part)."""
    return tuple(_CopyToTensorRegion.apply(x, group) for x in xs)


def _reduce_from_experts(x, group):
    """The sum of the ranks' partial outputs forward; identity backward."""
    return _ReduceFromTensorRegion.apply(x, group)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal parts along dim 0 over ``group``; its backward is the
    same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def _all_to_all(x, group):
    x = x.contiguous()
    if x.device.type == "meta":  # the memory trace allocates, it sends nothing
        return x.clone()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _SplitGroups(torch.autograd.Function):
    """This rank's share of dim 0 forward; every rank's share of the gradient gathered
    backward (the input is replicated over the group, and so must its gradient be). The
    conjugate of ``layout._GatherFn`` unsummed."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return split.part(x).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.split), None


# -- the layer -------------------------------------------------------------------


class MoEMlp(nn.Module):
    """Mixture-of-experts FFN ``[..., dim] -> [..., dim]`` (see the module docstring).

    ``num_experts`` E, ``hidden_dim`` each expert's FFN width, ``top_k`` experts a token,
    ``capacity_factor`` the buffers' slack, ``num_groups`` the routing groups (the token
    count must divide by it; capacity is per group), ``dispatch_impl`` ``"auto"``,
    ``"einsum"`` or ``"sort"``, ``dtype`` the compute dtype (params stay f32).
    ``expert_split`` (a ``parallel.layout.ExpertSplit``, set by the layout) makes the
    layer compute its rank's experts and sum over the group."""

    expert_split: "ExpertSplit | None" = None

    def __init__(
        self,
        dim: int,
        num_experts: int,
        hidden_dim: int,
        *,
        top_k: int = 2,
        capacity_factor: float = 1.25,
        num_groups: int = 1,
        dispatch_impl: str = "auto",
        dtype: torch.dtype = torch.float32,
        device="cuda",
    ):
        super().__init__()
        if dispatch_impl not in DISPATCH_IMPLS:
            raise ValueError(f"dispatch_impl must be auto|einsum|sort, got {dispatch_impl!r}")
        self.num_experts, self.hidden_dim, self.top_k = num_experts, hidden_dim, top_k
        self.capacity_factor, self.num_groups, self.dispatch_impl = capacity_factor, num_groups, dispatch_impl
        self.dtype = dtype
        self.router = nn.Linear(dim, num_experts, device=device)  # f32
        self.w_in = nn.Parameter(torch.empty(num_experts, dim, hidden_dim, device=device))
        self.w_out = nn.Parameter(torch.empty(num_experts, hidden_dim, dim, device=device))

    @torch.no_grad()
    def init_weights(self, generator: "torch.Generator | None" = None) -> None:
        """flax's: the router LeCun normal with a zero bias, the experts
        ``variance_scaling(2.0, "fan_in", "truncated_normal")`` with flax's fan-in of a
        ``[E, in, out]`` kernel, ``in * E``."""
        from distributed_training_pytorch_tpu_torch.models._init import lecun_normal_, variance_scaling_

        lecun_normal_(self.router.weight, self.router.in_features, generator)
        self.router.bias.zero_()
        for w in (self.w_in, self.w_out):
            variance_scaling_(w, 2.0, w.shape[0] * w.shape[1], generator)

    def _local(self) -> "tuple[int, object]":
        """The first expert this rank holds, and the expert group (None: all of them)."""
        split = self.expert_split
        if split is None:
            return 0, None
        return split.index * (self.num_experts // split.n), split.group

    def forward(self, x: torch.Tensor, *, decode: bool = False):
        shape = x.shape
        d = shape[-1]
        tokens = x.reshape(-1, d)
        logits = F.linear(tokens.float(), self.router.weight, self.router.bias)  # [S, E] f32
        gates = torch.softmax(logits, dim=-1)
        if decode:
            return self._decode(tokens, gates).view(shape), None
        s, g, e = tokens.shape[0], self.num_groups, self.num_experts
        if s % g:
            raise ValueError(f"{s} tokens not divisible by num_groups={g}")
        sg = s // g
        impl = resolve_dispatch(self.dispatch_impl, sg)
        capacity = capacity_for(sg, e, self.top_k, self.capacity_factor)
        aux = {
            "load_balance_loss": load_balance_loss(gates, F.one_hot(gates.argmax(dim=-1), e)),
            "router_z_loss": router_z_loss(logits),
        }
        lo, group = self._local()
        if group is not None:
            tokens, gates = _copy_to_experts(group, tokens, gates)
        out = _expert_ffn(tokens.view(g, sg, d), gates.view(g, sg, e), self.w_in, self.w_out, capacity=capacity,
                          top_k=self.top_k, impl=impl, lo=lo, dtype=self.dtype)
        if group is not None:
            out = _reduce_from_experts(out, group)
        return out.reshape(shape).to(self.dtype), aux

    def _decode(self, tokens, gates):
        """Capacity-free: each token's top-k experts' weights gathered (``[S, k, d, h]``)
        and applied, no buffers and no drops. Under an expert split a rank applies the
        choices among its experts and the outputs are summed over the group."""
        gate_vals, choice = torch.topk(gates, self.top_k, dim=-1)  # [S, k]
        weights = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
        lo, group = self._local()
        if group is not None:
            local = choice - lo
            mine = (local >= 0) & (local < self.w_in.shape[0])
            choice, weights = local.clamp(0, self.w_in.shape[0] - 1), weights * mine
        dt = self.dtype
        h = _gelu(torch.einsum("sd,skdh->skh", tokens.to(dt), self.w_in[choice].to(dt)))
        y = torch.einsum("skh,skhd->skd", h, self.w_out[choice].to(dt))
        out = torch.einsum("sk,skd->sd", weights.to(dt), y)
        return out if group is None else _reduce_from_experts(out, group)


# -- manual expert parallelism ------------------------------------------------------


def _expert_group(mesh) -> "tuple[int, int, object]":
    """``(n, index, group)`` of ``mesh``'s expert axis (``(1, 0, None)`` without one)."""
    if mesh is None or getattr(mesh, "expert_group", None) is None:
        return 1, 0, None
    return int(mesh.shape["expert"]), int(mesh.expert_index), mesh.expert_group


def _route_params(params):
    return params["router.weight"], params["router.bias"]


def manual_expert_ffn_local(params_local, grouped: torch.Tensor, *, num_experts: int, n_expert_shards: int = 1,
                            expert_index: int = 0, group=None, top_k: int = 2, capacity: "int | None" = None,
                            capacity_factor: float = 1.25, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The ``psum`` exchange over ``[G, sg, d]`` tokens replicated over the expert
    ``group``: routing in full on every rank, this rank's experts (``params_local``'s
    ``w_in``/``w_out``, ``[E / n, ...]``) on their slice of the dispatch, the partial
    outputs summed over the group. ``params_local``: ``router.weight`` ``[E, d]``,
    ``router.bias`` ``[E]``, ``w_in``, ``w_out``."""
    if capacity is None:
        capacity = capacity_for(grouped.shape[1], num_experts, top_k, capacity_factor)
    rw, rb = _route_params(params_local)
    gates = torch.softmax(F.linear(grouped.float(), rw, rb), dim=-1)
    if n_expert_shards > 1:
        grouped, gates = _copy_to_experts(group, grouped, gates)
    lo = expert_index * (num_experts // n_expert_shards)
    out = _expert_ffn(grouped, gates, params_local["w_in"], params_local["w_out"], capacity=capacity, top_k=top_k,
                      impl="einsum", lo=lo, dtype=dtype)
    return _reduce_from_experts(out, group) if n_expert_shards > 1 else out


def manual_expert_mlp(params, x: torch.Tensor, *, num_experts: int, top_k: int = 2, capacity_factor: float = 1.25,
                      num_groups: int = 1, mesh=None, exchange: str = "auto",
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The MoE FFN with the expert exchange written out (JAX ``manual_expert_mlp``), the
    einsum route's semantics, no auxiliary losses.

    ``params``: the layer's state dict with ``w_in``/``w_out`` this rank's slabs
    ``[E / n, ...]`` over the ``expert`` axis of ``mesh`` (a ``parallel.mesh.Mesh``; None
    or no expert axis: one rank holds every expert). ``x``: this batch shard's tokens
    ``[..., d]``, the same on every rank of the expert group; the result is too.

    * ``"all_to_all"`` (and ``"auto"``): the ``num_groups`` groups are shared out over the
      expert ranks; each routes its own, one ``all_to_all_single`` sends every expert's
      dispatch buffers to its rank, the local FFN runs on all their groups, a second
      exchange brings the outputs back, the combine is local, and the groups are gathered
      over the group. ``num_groups`` must divide by the expert extent.
    * ``"psum"``: :func:`manual_expert_ffn_local`.

    Differentiable: the exchanges carry their gradients back."""
    if exchange == "auto":
        exchange = "all_to_all"
    if exchange not in ("all_to_all", "psum"):
        raise ValueError(f"exchange must be all_to_all|psum|auto, got {exchange!r}")
    n, index, group = _expert_group(mesh)
    shape = x.shape
    d = shape[-1]
    tokens = x.reshape(-1, d)
    s, g, e = tokens.shape[0], num_groups, num_experts
    if s % g:
        raise ValueError(f"{s} tokens not divisible by num_groups={g}")
    need = n if exchange == "all_to_all" else 1
    if g % need:
        raise ValueError(f"num_groups={g} must divide by {need} shards ({exchange})")
    if e % n:
        raise ValueError(f"num_experts={e} not divisible by expert axis {n}")
    sg = s // g
    capacity = capacity_for(sg, e, top_k, capacity_factor)
    grouped = tokens.view(g, sg, d)
    if exchange == "psum":
        out = manual_expert_ffn_local(params, grouped, num_experts=e, n_expert_shards=n, expert_index=index,
                                      group=group, top_k=top_k, capacity=capacity, dtype=dtype)
        return out.reshape(shape).to(dtype)
    groups = _Split("expert", 0, 1, n, index, group)  # the token groups shared out over the expert ranks
    if n > 1:
        grouped = _SplitGroups.apply(grouped, groups)  # [G / n, sg, d]
    rw, rb = _route_params(params)
    gates = torch.softmax(F.linear(grouped.float(), rw, rb), dim=-1)
    dispatch, combine = route_groups(gates, capacity=capacity, top_k=top_k)
    expert_in = torch.einsum("gsec,gsd->gecd", dispatch.to(dtype), grouped.to(dtype))  # [G/n, E, C, d]
    g_loc, e_loc = grouped.shape[0], e // n
    if n > 1:  # experts -> groups: each rank receives its experts' buffers of every rank's groups
        sent = expert_in.unflatten(1, (n, e_loc)).movedim(1, 0)  # [n, G/n, E/n, C, d]
        expert_in = _AllToAll.apply(sent, group).flatten(0, 1)  # [G, E/n, C, d], groups in rank order
    h = _gelu(torch.einsum("gecd,edh->gech", expert_in, params["w_in"].to(dtype)))
    expert_out = torch.einsum("gech,ehd->gecd", h, params["w_out"].to(dtype))
    if n > 1:  # and back: each rank receives every expert's outputs of its groups
        back = _AllToAll.apply(expert_out.unflatten(0, (n, g_loc)), group)  # [n, G/n, E/n, C, d]
        expert_out = back.movedim(0, 1).flatten(1, 2)  # [G/n, E, C, d]
    out = torch.einsum("gsec,gecd->gsd", combine.to(dtype), expert_out)
    if n > 1:
        out = _GatherFn.apply(out, groups, False)  # every rank's groups; the gradient's own share back
    return out.reshape(shape).to(dtype)
