"""The port's serving stack (``distributed_training_pytorch_tpu_torch/serving/``) on the CPU.

* the micro-batcher's flush policy at its boundaries, as ``tests/test_serving.py`` pins
  the JAX package's (no devices, injected clock);
* ``InferEngine``: bucket pad, the per-(bucket, row-signature) entry count, the one-model
  binding, and the atomic ``(version, params)`` swap under concurrent predicts;
* ``InferenceServer`` end to end over HTTP with LMTiny: ``/predict`` bodies equal the JAX
  ``InferEngine`` + ``InferenceServer``'s on the same converted params (atol 2e-4, the LM
  parity tolerance of ``tests/test_torch_transformer_lm.py``), 400 on empty input, a typed
  429 with ``Retry-After``, ``/status`` and ``/metrics``, and an ``events.jsonl`` that
  the JAX package's ``load_run_events`` reads.
"""

import json
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu.models import transformer_lm as jax_lm
from distributed_training_pytorch_tpu.parallel import mesh_config_from_spec
from distributed_training_pytorch_tpu.serving.engine import InferEngine as JaxInferEngine
from distributed_training_pytorch_tpu.serving.server import InferenceServer as JaxInferenceServer
from distributed_training_pytorch_tpu.telemetry.events import load_run_events
from distributed_training_pytorch_tpu.telemetry.exporter import prometheus_text as jax_prometheus_text
from distributed_training_pytorch_tpu_torch.models import LMTiny, params_from_jax
from distributed_training_pytorch_tpu_torch.telemetry.exporter import prometheus_text
from distributed_training_pytorch_tpu_torch.serving import (
    InferEngine,
    InferenceServer,
    LatencyWindow,
    MicroBatcher,
    OverloadRejected,
    RetriesExhausted,
    RetryClient,
    pick_bucket,
)

VOCAB, SEQ = 64, 16


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _batcher(**kw):
    kw.setdefault("buckets", (1, 2, 4, 8))
    kw.setdefault("max_delay_s", 0.02)
    kw.setdefault("clock", FakeClock())
    return MicroBatcher(**kw)


# ---------------------------------------------------------------------------
# Batcher boundaries.


@pytest.mark.parametrize(
    "n,bucket", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (8, 8), (9, None), (0, None)]
)
def test_pick_bucket_boundary_exact(n, bucket):
    if bucket is None:
        with pytest.raises(ValueError):
            pick_bucket(n, (1, 2, 4, 8))
    else:
        assert pick_bucket(n, (1, 2, 4, 8)) == bucket


def test_deadline_flush_exact():
    clock = FakeClock()
    b = _batcher(clock=clock)
    for _ in range(3):
        b.submit("a", 0)
    clock.advance(0.019)
    assert b.next_batch() is None
    clock.advance(0.001)
    batch = b.next_batch()
    assert batch.flushed_by == "deadline" and len(batch.requests) == 3
    assert batch.bucket == 4 and batch.pad == 1 and b.pending() == 0


def test_full_flush_immediate_and_deadline_tracks_oldest():
    b = _batcher()
    for _ in range(8):
        b.submit("a", 0)
    batch = b.next_batch()
    assert batch.flushed_by == "full" and batch.bucket == 8 and batch.pad == 0
    clock = FakeClock(100.0)
    b = _batcher(clock=clock)
    assert b.next_deadline() is None
    b.submit("a", 0)
    clock.advance(0.01)
    b.submit("b", 0)  # a younger request must not push the deadline back
    assert b.next_deadline() == pytest.approx(100.02)


def test_fairness_rotation_and_fifo():
    b = _batcher(max_queue_depth=200)
    for _ in range(100):
        b.submit("greedy", "g")
    for _ in range(4):
        b.submit("quiet", "q")
    by_tenant = {}
    for r in b.next_batch().requests:
        by_tenant[r.tenant] = by_tenant.get(r.tenant, 0) + 1
    assert by_tenant == {"greedy": 4, "quiet": 4}
    b = _batcher(buckets=(1,), max_queue_depth=8)
    for _ in range(2):
        b.submit("a", 0)
        b.submit("b", 0)
    assert [b.next_batch(drain=True).requests[0].tenant for _ in range(4)] == ["a", "b", "a", "b"]
    b = _batcher()
    r1, r2 = b.submit("a", "first"), b.submit("a", "second")
    assert [r.id for r in b.next_batch(drain=True).requests] == [r1.id, r2.id]


def test_overload_typed_all_or_nothing_and_zero_capacity():
    b = _batcher(max_queue_depth=4)
    b.submit("a", 0)
    with pytest.raises(OverloadRejected) as exc:
        b.submit_many("a", [1, 2, 3, 4])
    assert (exc.value.tenant, exc.value.depth, exc.value.bound) == ("a", 1, 4)
    assert b.pending() == 1 and b.submitted == 1 and b.rejected["a"] == 1
    assert len(b.submit_many("a", [1, 2, 3])) == 3 and b.pending() == 4
    b.submit("b", 0)  # bounds are per tenant
    zero = _batcher(max_queue_depth=0)
    t0 = time.monotonic()
    with pytest.raises(OverloadRejected):
        zero.submit("anyone", 0)
    assert time.monotonic() - t0 < 1.0 and zero.pending() == 0


def test_stats_pad_frac_and_drain_reason():
    b = _batcher()
    for _ in range(3):
        b.submit("a", 0)
    assert b.next_batch(drain=True).flushed_by == "drain"
    stats = b.stats()
    assert stats["pad_frac"] == pytest.approx(0.25) and stats["flushes"] == {"drain": 1}


def test_latency_window_quantiles():
    clock = FakeClock(0.0)
    w = LatencyWindow(window_s=10.0, clock=clock)
    for i in range(100):
        w.add(float(i) * 0.05, latency_ms=float(i + 1))
    clock.t = 5.0
    snap = w.snapshot()
    assert (snap["window_n"], snap["p50_ms"], snap["p99_ms"]) == (100, 51.0, 100.0)
    clock.t = 50.0
    assert w.snapshot()["window_n"] == 0


def test_retry_client_honours_retry_after_then_gives_up():
    slept = []
    replies = iter([(429, b"{}", {"Retry-After": "3"}), (200, b'{"ok": 1}', {})])
    client = RetryClient(transport=lambda url, body, timeout: next(replies), sleep=slept.append)
    assert client.post_json("http://x/predict", {}) == (200, {"ok": 1})
    assert slept and slept[0] >= 3.0
    refusing = RetryClient(
        max_attempts=2, transport=lambda *a: (429, b"{}", {}), sleep=lambda s: None
    )
    with pytest.raises(RetriesExhausted):
        refusing.post_json("http://x/predict", {})


# ---------------------------------------------------------------------------
# InferEngine.


def _linear_apply(params, x):
    return x @ params["w"]


def _linear_params(seed=0, d=4):
    return {"w": np.random.default_rng(seed).standard_normal((d, d)).astype(np.float32)}


def test_engine_pads_counts_entries_and_binds_one_model():
    eng = InferEngine(_linear_apply, device="cpu", buckets=(1, 2, 4, 8))
    with pytest.raises(RuntimeError, match="no params"):
        eng.predict(np.ones((1, 4), np.float32))
    params = _linear_params()
    eng.swap_params(params, version="v1")
    eng.warmup(np.ones((4,), np.float32))
    assert eng.trace_counts["infer_step"] == 4  # one entry per bucket
    x = np.random.default_rng(1).standard_normal((3, 4)).astype(np.float32)
    out, version = eng.predict(x)
    assert version == "v1" and out.shape == (3, 4)  # padded to 4, sliced back
    np.testing.assert_allclose(out, x @ params["w"], rtol=1e-5)
    for n in (1, 2, 3, 5, 8):
        eng.predict(np.ones((n, 4), np.float32))
    assert eng.trace_counts["infer_step"] == 4
    with pytest.raises(ValueError, match="different structure"):
        eng.swap_params({"w": np.ones((8, 8), np.float32)}, version="v2")
    with pytest.raises(ValueError, match="different structure"):
        eng.swap_params({"other": np.ones((4, 4), np.float32)}, version="v2")


def test_engine_pad_repeats_last_row():
    seen = []

    def apply(params, x):
        seen.append(x.clone())
        return x * params["s"]

    eng = InferEngine(apply, device="cpu", buckets=(4,))
    eng.swap_params({"s": np.float32(2.0)}, version="v")
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    out, _ = eng.predict(x)
    np.testing.assert_array_equal(seen[0].numpy(), np.concatenate([x, x[-1:]]))
    np.testing.assert_array_equal(out, 2 * x)


def test_engine_swap_is_atomic_under_concurrent_predicts():
    """Each answer was computed with the params of the version it is stamped with."""
    eng = InferEngine(_linear_apply, device="cpu", buckets=(1, 2))
    trees = {"a": _linear_params(seed=1), "b": _linear_params(seed=2)}
    eng.swap_params(trees["a"], version="a")
    x = np.ones((2, 4), np.float32)
    expect = {k: x @ p["w"] for k, p in trees.items()}
    stop = threading.Event()
    bad = []

    def reader():
        while not stop.is_set():
            out, version = eng.predict(x)
            if not np.allclose(out, expect[version], rtol=1e-6):
                bad.append(version)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=reader) for _ in range(4)]
        for t in threads:
            t.start()
        for i in range(200):
            version = "ab"[i % 2]
            eng.swap_params(trees[version], version=version)
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert bad == [] and eng.swap_count == 201


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferEngine(_linear_apply)


# ---------------------------------------------------------------------------
# InferenceServer over HTTP, against the JAX server on the same params.


def _post(port, payload, timeout=30.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(port, route):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=30.0) as resp:
        return resp.status, resp.read().decode()


@pytest.fixture(scope="module")
def lm_params():
    model = jax_lm.LMTiny(vocab_size=VOCAB, attention_impl="plain")
    params = model.init(jax.random.key(0), jnp.zeros((1, SEQ), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _last_logits_jax(params, tokens):
    model = jax_lm.LMTiny(vocab_size=VOCAB, attention_impl="plain")
    return model.apply({"params": params}, tokens)[:, -1]


def test_predict_bodies_match_jax_server(tmp_path, lm_params):
    model = LMTiny(vocab_size=VOCAB, device="cpu").eval()

    def apply_fn(params, tokens):
        hidden = torch.func.functional_call(model, params, (tokens,), {"return_hidden": True})
        return hidden[:, -1].float() @ params["embed.weight"].float().T

    eng = InferEngine(apply_fn, device="cpu", buckets=(1, 2, 4))
    eng.swap_params(params_from_jax(lm_params), version="seed0")
    eng.warmup(np.zeros((SEQ,), np.int32))
    jax_eng = JaxInferEngine(
        _last_logits_jax, mesh_config_from_spec("dp1").build(jax.devices()[:1]), buckets=(1, 2, 4)
    )
    jax_eng.swap_params(lm_params, version="seed0")
    rows = np.random.RandomState(7).randint(0, VOCAB, size=(3, SEQ)).tolist()
    servers = [
        InferenceServer(
            eng, batcher=MicroBatcher(buckets=(1, 2, 4), max_delay_s=0.005),
            run_dir=str(tmp_path / "port"), input_dtype="int32", pulse_every_s=0.05,
            process_index=0,
        ),
        JaxInferenceServer(
            jax_eng, batcher=MicroBatcher(buckets=(1, 2, 4), max_delay_s=0.005),
            input_dtype="int32", process_index=0,
        ),
    ]
    bodies = []
    try:
        for server in servers:
            server.start()
            assert server.enabled and server.port
            code, body, _ = _post(server.port, {"tenant": "t0", "inputs": rows})
            assert code == 200, body
            bodies.append(body)
        port_server = servers[0]
        code, body, _ = _post(port_server.port, {"tenant": "t0", "inputs": []})
        assert code == 400 and body["error"] == "bad_request"
        code, body, _ = _post(port_server.port, {"tenant": "t0"})
        assert code == 400 and body["error"] == "bad_request"
        code, text = _get(port_server.port, "/status")
        snap = json.loads(text)
        assert code == 200 and snap["kind"] == "server" and snap["chips"] == 1
        assert snap["requests_total"] == 3 and snap["params_version"] == "seed0"
        code, text = _get(port_server.port, "/metrics")
        assert code == 200 and "tpu_serve_up 1" in text and "tpu_serve_requests_total 3.0" in text
        gauges = {k: v for k, v in snap.items() if v is not None}
        assert prometheus_text(gauges, prefix="tpu_serve") == jax_prometheus_text(
            gauges, prefix="tpu_serve"
        )
        time.sleep(0.1)  # one pulse interval, so request_batch lands
    finally:
        for server in servers:
            server.close()
    port_body, jax_body = bodies
    assert port_body["params_version"] == jax_body["params_version"] == "seed0"
    np.testing.assert_allclose(
        np.asarray(port_body["outputs"]), np.asarray(jax_body["outputs"]), atol=2e-4
    )
    records = load_run_events(str(tmp_path / "port"))
    kinds = [r["event"] for r in records]
    assert kinds[0] == "serve_start" and kinds[-1] == "run_end" and "request_batch" in kinds
    assert records[0]["attempt"] == 1 and records[0]["schema"] == 8


def test_overload_is_typed_429_with_retry_after(tmp_path):
    eng = InferEngine(_linear_apply, device="cpu", buckets=(1, 2, 4))
    eng.swap_params(_linear_params(), version="v1")
    with InferenceServer(
        eng,
        batcher=MicroBatcher(buckets=(1, 2, 4), max_queue_depth=0),
        run_dir=str(tmp_path),
        process_index=0,
    ) as server:
        server.start()
        code, body, headers = _post(server.port, {"tenant": "t9", "inputs": [[1, 2, 3, 4]]})
        assert code == 429
        assert body == {"error": "overload", "tenant": "t9", "depth": 0, "bound": 0}
        assert int(headers["Retry-After"]) >= 1
    rejects = [r for r in load_run_events(str(tmp_path)) if r["event"] == "admission_reject"]
    assert len(rejects) == 1 and rejects[0]["tenant"] == "t9" and rejects[0]["reason"] == "overload"


def test_bad_row_shape_is_500_and_dispatch_survives(tmp_path):
    eng = InferEngine(_linear_apply, device="cpu", buckets=(1, 2, 4))
    params = _linear_params(seed=5)
    eng.swap_params(params, version="v1")
    with InferenceServer(
        eng, batcher=MicroBatcher(buckets=(1, 2, 4), max_delay_s=0.2), process_index=0, log=lambda m: None
    ) as server:
        server.start()
        good = server.batcher.submit("a", np.ones((4,), np.float32))
        bad = server.batcher.submit("b", np.ones((8,), np.float32))
        assert good.wait(10.0) and bad.wait(10.0)
        assert good.error is None and bad.error is not None
        np.testing.assert_allclose(np.asarray(good.result), np.ones(4, np.float32) @ params["w"], rtol=1e-5)
        code, body, _ = _post(server.port, {"inputs": [[1.0, 0.0, 0.0, 0.0, 0.0, 0.0]]})
        assert code == 500 and body["error"] == "inference_failed"
        code, body, _ = _post(server.port, {"inputs": [[1.0, 0.0, 0.0, 0.0]]})
        assert code == 200 and body["params_version"] == "v1"
