"""The port's Mixture-of-Experts layer (``distributed_training_pytorch_tpu_torch/parallel/
moe.py``) held against the JAX package's ``MoEMlp`` on the same numpy weights and tokens.

Both dispatch routes at top-k 1 and 2 and one and two groups: the output within 1e-5 and
the gradients (tokens, router, experts) within 1e-4 in f32; in bf16 the output within
3e-2 and the gradients within 5e-2 of JAX's largest value or of 1 where that is smaller (at top-1
the router's gradient is rounding noise, the renormalised gate being 1) (the experts' bf16 products
rounded in other orders by XLA and by PyTorch; the gaps measured on these inputs are below
a third of that). The dispatch mask is bit-equal to JAX's ``_route_group`` and the combine
weights too; the sort route keeps the same entries. Capacity drops, both auxiliary losses,
the capacity-free decode, ``"auto"`` and the errors; the experts' initial distribution
against flax's.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu.parallel import moe as jax_moe
from distributed_training_pytorch_tpu_torch.parallel import moe

D, H, E = 16, 32, 4
B, T = 2, 16
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (3e-2, 5e-2)}  # (output, gradients)


def _jax_layer(dtype="float32", **kw):
    kw.setdefault("top_k", 2)
    return jax_moe.MoEMlp(num_experts=E, hidden_dim=H, dtype=getattr(jnp, dtype), **kw)


@pytest.fixture(scope="module")
def params():
    variables = jax.jit(_jax_layer().init)(jax.random.key(3), jnp.zeros((B, T, D), jnp.float32))
    return jax.tree.map(np.asarray, variables["params"])


def _inputs(seed=0, b=B, t=T):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, D).astype(np.float32)
    return x, rng.randn(b, t, D).astype(np.float32)  # tokens, cotangent


def port_state(params) -> dict:
    return {
        "router.weight": torch.tensor(params["router"]["kernel"].T.copy()),
        "router.bias": torch.tensor(params["router"]["bias"]),
        "w_in": torch.tensor(params["w_in"]),
        "w_out": torch.tensor(params["w_out"]),
    }


def _port_layer(params, dtype="float32", **kw):
    kw.setdefault("top_k", 2)
    layer = moe.MoEMlp(D, E, H, dtype=getattr(torch, dtype), device="cpu", **kw)
    layer.load_state_dict(port_state(params))
    return layer


ROUTES = [(impl, k, g, 1.25) for impl in ("einsum", "sort") for k in (1, 2) for g in (1, 2)]
ROUTES += [(impl, 2, 2, 1e-9) for impl in ("einsum", "sort")]  # capacity 1: drops


def _route_inputs(top_k, num_groups, capacity_factor):
    return _inputs(seed=top_k + 2 * num_groups + (7 if capacity_factor < 1 else 0))


@pytest.fixture(scope="module")
def jax_refs(params):
    """``{(dtype, impl, top_k, num_groups, capacity_factor): (output, grads, aux)}`` of the
    JAX layer, each route's loss ``sum(out * cotangent)`` differentiated: one jit a dtype."""
    refs = {}
    for dtype in ("float32", "bfloat16"):
        def run_all(p, xs, cts, dtype=dtype):
            out = {}
            for route, xx, ct in zip(ROUTES, xs, cts, strict=True):
                impl, k, g, cf = route
                layer = _jax_layer(dtype, top_k=k, num_groups=g, dispatch_impl=impl, capacity_factor=cf)

                def loss(pp, x2, layer=layer, ct=ct):
                    o, state = layer.apply({"params": pp}, x2, mutable=["intermediates"])
                    return jnp.sum(o.astype(jnp.float32) * ct), (o.astype(jnp.float32), state["intermediates"])

                out[route] = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(p, xx)
            return out

        pairs = [_route_inputs(k, g, cf) for _, k, g, cf in ROUTES]
        results = jax.jit(run_all)(params, [jnp.asarray(x) for x, _ in pairs], [jnp.asarray(c) for _, c in pairs])
        for route, ((_, (o, inter)), (gp, gx)) in results.items():
            grads = {"x": np.asarray(gx), "router.weight": np.asarray(gp["router"]["kernel"]).T,
                     "router.bias": np.asarray(gp["router"]["bias"]), "w_in": np.asarray(gp["w_in"]),
                     "w_out": np.asarray(gp["w_out"])}
            refs[(dtype, *route)] = (np.asarray(o), grads, {k: float(v[0]) for k, v in inter.items()})
    return refs


def _port_run(params, x, ct, dtype="float32", **kw):
    layer = _port_layer(params, dtype, **kw)
    xt = torch.tensor(x, requires_grad=True)
    out, aux = layer(xt)
    (out.float() * torch.tensor(ct)).sum().backward()
    grads = {"x": xt.grad.numpy(), **{n: p.grad.numpy() for n, p in layer.named_parameters()}}
    return out.float().detach().numpy(), grads, {k: float(v.detach()) for k, v in aux.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_groups", [1, 2])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("impl", ["einsum", "sort"])
def test_routes_match_jax_output_and_gradients(params, jax_refs, impl, top_k, num_groups, dtype):
    x, ct = _route_inputs(top_k, num_groups, 1.25)
    kw = dict(top_k=top_k, num_groups=num_groups, dispatch_impl=impl)
    want, want_g, want_aux = jax_refs[(dtype, impl, top_k, num_groups, 1.25)]
    got, got_g, got_aux = _port_run(params, x, ct, dtype, **kw)
    out_tol, grad_tol = TOL[dtype]
    scale = 1.0 if dtype == "float32" else float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=out_tol * scale, rtol=0)
    for name, ref in want_g.items():
        scale = 1.0 if dtype == "float32" else max(float(np.abs(ref).max()), 1.0)
        np.testing.assert_allclose(got_g[name], ref, atol=grad_tol * scale, rtol=0, err_msg=name)
    for name, ref in want_aux.items():  # f32 in both, whatever the compute dtype
        assert got_aux[name] == pytest.approx(ref, rel=1e-6, abs=1e-7), name


@pytest.mark.parametrize("capacity_factor", [1.25, 1e-9])
@pytest.mark.parametrize("num_groups", [1, 2])
@pytest.mark.parametrize("top_k", [1, 2])
def test_dispatch_mask_and_combine_bit_equal_to_jax(params, top_k, num_groups, capacity_factor):
    """``route_groups`` against JAX's ``_route_group`` on each group, and the sort route's
    kept entries against the same mask; ``capacity_factor=1e-9`` gives a capacity of one
    and drops all but each expert's first claim."""
    rng = np.random.RandomState(top_k * 10 + num_groups)
    sg = B * T // num_groups
    gates = jax.nn.softmax(jnp.asarray(rng.randn(num_groups, sg, E).astype(np.float32) * 2), axis=-1)
    capacity = moe.capacity_for(sg, E, top_k, capacity_factor)
    assert capacity == max(1, int(np.ceil(sg * top_k / E * capacity_factor)))
    route = jax.jit(jax.vmap(lambda gg: jax_moe._route_group(gg, num_experts=E, capacity=capacity, top_k=top_k)))
    want_dispatch, want_combine, _ = route(gates)
    g = torch.tensor(np.asarray(gates))
    dispatch, combine = moe.route_groups(g, capacity=capacity, top_k=top_k)
    assert dispatch.dtype == torch.bool and dispatch.shape == (num_groups, sg, E, capacity)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(want_dispatch))
    np.testing.assert_array_equal(combine.numpy(), np.asarray(want_combine))
    if capacity_factor < 1:
        assert dispatch.sum() == num_groups * E * capacity < num_groups * sg * top_k  # tokens were dropped
    # the sort route keeps the same (token, expert, slot) entries
    _, rows, weights = moe.sort_dispatch(g, torch.zeros(num_groups, sg, D), capacity=capacity, top_k=top_k,
                                         dtype=torch.float32)
    mask = torch.zeros(num_groups, top_k * sg, E * capacity + 1, dtype=torch.bool)
    mask.scatter_(-1, rows[..., None], True)
    by_token = mask[..., : E * capacity].view(num_groups, top_k, sg, E, capacity).any(dim=1)
    np.testing.assert_array_equal(by_token.numpy(), dispatch.numpy())
    kept = combine.view(num_groups, sg, -1)
    picked = torch.stack([kept[i].gather(-1, rows[i].view(top_k, sg).T.clamp(max=E * capacity - 1))
                          for i in range(num_groups)])  # [G, sg, k]
    dropped = (rows == E * capacity).view(num_groups, top_k, sg).transpose(1, 2)
    np.testing.assert_allclose(torch.where(dropped, 0.0, picked).numpy(),
                               weights.view(num_groups, top_k, sg).transpose(1, 2).numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("impl", ["einsum", "sort"])
def test_capacity_drops_match_jax(params, jax_refs, impl):
    x, ct = _route_inputs(2, 2, 1e-9)
    kw = dict(top_k=2, num_groups=2, dispatch_impl=impl, capacity_factor=1e-9)
    want, want_g, _ = jax_refs[("float32", impl, 2, 2, 1e-9)]
    got, got_g, _ = _port_run(params, x, ct, **kw)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (np.abs(got).sum(-1) == 0).any()  # a token with both choices dropped gets 0
    for name, ref in want_g.items():
        np.testing.assert_allclose(got_g[name], ref, atol=1e-4, rtol=0, err_msg=name)


def test_auxiliary_losses_match_jax_functions():
    rng = np.random.RandomState(5)
    logits = rng.randn(64, E).astype(np.float32) * 3
    gates = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    first = jax.nn.one_hot(jnp.argmax(gates, -1), E, dtype=jnp.int32)
    got_z = float(moe.router_z_loss(torch.tensor(logits)))
    got_lb = float(moe.load_balance_loss(torch.tensor(np.asarray(gates)), torch.tensor(np.asarray(first))))
    assert got_z == pytest.approx(float(jax_moe.router_z_loss(jnp.asarray(logits))), rel=1e-6)
    assert got_lb == pytest.approx(float(jax_moe.load_balance_loss(gates, first)), rel=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_decode_is_capacity_free_and_matches_jax(params, top_k, dtype):
    x, _ = _inputs(seed=11, b=3, t=1)
    apply = jax.jit(lambda p, xx: _jax_layer(dtype, top_k=top_k).apply({"params": p}, xx, decode=True))
    want = apply(params, jnp.asarray(x))
    layer = _port_layer(params, dtype, top_k=top_k)
    with torch.no_grad():
        got, aux = layer(torch.tensor(x), decode=True)
    assert aux is None and got.dtype == getattr(torch, dtype) and got.shape == x.shape
    want = np.asarray(want.astype(jnp.float32))
    tol = 1e-5 if dtype == "float32" else 3e-2 * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_auto_takes_the_sort_route_from_the_ports_threshold(params, monkeypatch):
    sg = B * T
    assert moe.resolve_dispatch("auto", moe.SORT_DISPATCH_MIN_GROUP - 1) == "einsum"
    assert moe.resolve_dispatch("auto", moe.SORT_DISPATCH_MIN_GROUP) == "sort"
    assert moe.resolve_dispatch("einsum", 10**9) == "einsum"
    calls = []
    real = moe.sort_dispatch
    monkeypatch.setattr(moe, "sort_dispatch", lambda *a, **k: calls.append(1) or real(*a, **k))
    x, _ = _inputs(seed=1)
    layer = _port_layer(params, dispatch_impl="auto")
    with torch.no_grad():
        layer(torch.tensor(x))
        assert not calls  # 32 tokens a group: below the threshold, the einsum route
        monkeypatch.setattr(moe, "SORT_DISPATCH_MIN_GROUP", sg)
        auto, _ = layer(torch.tensor(x))
        assert calls == [1]
        sort, _ = _port_layer(params, dispatch_impl="sort")(torch.tensor(x))
    torch.testing.assert_close(auto, sort, rtol=0, atol=0)


def test_errors_match_jax(params):
    x = np.zeros((1, 5, D), np.float32)  # 5 tokens into 2 groups
    with pytest.raises(ValueError, match="not divisible by num_groups"):
        jax.jit(lambda p, xx: _jax_layer(num_groups=2).apply({"params": p}, xx, mutable=["intermediates"]))(
            params, jnp.asarray(x))
    with pytest.raises(ValueError, match="not divisible by num_groups"):
        _port_layer(params, num_groups=2)(torch.tensor(x))
    with pytest.raises(ValueError, match="dispatch_impl must be auto|einsum|sort"):
        jax.jit(lambda p: _jax_layer(dispatch_impl="scatter").apply({"params": p}, jnp.zeros((1, 4, D)),
                                                                    mutable=["intermediates"]))(params)
    with pytest.raises(ValueError, match="dispatch_impl must be auto|einsum|sort"):
        moe.MoEMlp(D, E, H, dispatch_impl="scatter", device="cpu")
    with pytest.raises(ValueError, match="exchange must be"):
        moe.manual_expert_mlp(port_state(params), torch.zeros(4, D), num_experts=E, exchange="ring")


def test_expert_init_matches_flax_distribution():
    """flax's ``variance_scaling(2.0, "fan_in", "truncated_normal")`` on ``[E, d, h]`` takes
    fan-in ``d * E``: at d=256, E=8 the std is 0.03125 (0.0884 with fan-in d). The port's
    draws have flax's std within 1 % and its truncation at two nominal std."""
    d, h, e = 256, 512, 8
    flax_p = jax.jit(jax_moe.MoEMlp(num_experts=e, hidden_dim=h).init)(jax.random.key(0), jnp.zeros((1, 4, d)))["params"]
    layer = moe.MoEMlp(d, e, h, device="cpu")
    layer.init_weights(torch.Generator().manual_seed(0))
    for name, fan_in in (("w_in", d * e), ("w_out", h * e)):
        ref, got = np.asarray(flax_p[name]), getattr(layer, name).detach().numpy()
        assert ref.shape == got.shape
        assert abs(got.std() - ref.std()) / ref.std() < 0.01, name
        assert abs(got.std() - (2.0 / fan_in) ** 0.5) / (2.0 / fan_in) ** 0.5 < 0.01, name
        bound = 2 * (2.0 / fan_in) ** 0.5 / 0.87962566103423978
        assert np.abs(got).max() <= bound + 1e-7 and np.abs(ref).max() <= bound + 1e-7
    w = layer.router.weight.detach().numpy()
    assert abs(w.std() - d**-0.5) / d**-0.5 < 0.02 and not layer.router.bias.any()
    assert isinstance(flax_p["router"], dict) and nn.Dense  # the router is flax's Dense: kernel and bias
