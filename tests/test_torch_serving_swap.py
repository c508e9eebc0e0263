"""The port's serving hot swap, drain and admin routes (``distributed_training_pytorch_tpu_torch/
serving/``) on the CPU, held against the JAX ``InferEngine`` and ``InferenceServer`` where
both can run the same sequence.

* F9: ``swap_params`` serves a snapshot. Writing into the arrays or tensors that were
  swapped in leaves the answers and the version as they were, as in the JAX engine.
* ``CheckpointManager.exists`` and ``restore_latest_valid(params_only=True)``;
  ``InferEngine.restore_params`` by name and newest-valid (a corrupt checkpoint skipped,
  or refused by name with the old params serving); ``replan_onto`` keeps the version and
  the answers, and refuses another kind of device.
* The watcher (``swap_poll_s`` 0.02 to 0.05 s): a hot swap under concurrent ``/predict``
  (every body equals the forward of the version it is stamped with, within 1e-5: the same
  arithmetic in other batch sizes), the start-up adoption (no ``hot_swap`` for the params
  the engine was loaded with), a torn commit never served, and no swap while drained.
* The drain, ``/admin/offer`` and ``/admin/replan``: the same sequence on the port's server
  and the JAX server, over stub engines, gives the same codes, bodies and ``Retry-After``.
"""

import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu.parallel import mesh_config_from_spec
from distributed_training_pytorch_tpu.serving.engine import InferEngine as JaxInferEngine
from distributed_training_pytorch_tpu.serving.server import InferenceServer as JaxInferenceServer
from distributed_training_pytorch_tpu_torch.checkpoint import CheckpointManager
from distributed_training_pytorch_tpu_torch.checkpoint.manager import CorruptCheckpointError
from distributed_training_pytorch_tpu_torch.models import LMTiny
from distributed_training_pytorch_tpu_torch.serving import InferEngine, InferenceServer, MicroBatcher
from distributed_training_pytorch_tpu_torch.telemetry.events import resolve_events_path
from distributed_training_pytorch_tpu_torch.train import TrainState

VOCAB, SEQ = 64, 12


def _linear_apply(params, x):
    return x @ params["w"]


def _jax_engine():
    return JaxInferEngine(_linear_apply, mesh_config_from_spec("dp1").build(jax.devices()[:1]), buckets=(1, 2))


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_swapped_params_are_a_snapshot_as_in_the_jax_engine(kind):
    """F9: the served set is a copy; the caller's later writes do not reach it. The JAX
    engine answers version v1 with the params as they were swapped in (JAX arrays are
    immutable: ``jax.device_put`` hands the engine its own buffer)."""
    x = np.ones((1, 4), np.float32)
    w = np.eye(4, dtype=np.float32)
    jax_eng = _jax_engine()
    jax_eng.swap_params({"w": jax.device_put(w)}, version="v1")
    eng = InferEngine(_linear_apply, device="cpu", buckets=(1, 2))
    mine = torch.from_numpy(w.copy()) if kind == "tensor" else w.copy()
    eng.swap_params({"w": mine}, version="v1")
    before, _ = eng.predict(x)
    mine[:] = 5
    out, version = eng.predict(x)
    jax_out, jax_version = jax_eng.predict(x)
    assert (version, jax_version) == ("v1", "v1")
    np.testing.assert_array_equal(jax_out, x)
    np.testing.assert_array_equal(out, jax_out)
    np.testing.assert_array_equal(out, before)


# ---------------------------------------------------------------------------
# Checkpoints of an LMTiny, and the engine that serves them.


def _model(seed):
    return LMTiny(vocab_size=VOCAB, max_len=32, device="cpu", generator=torch.Generator().manual_seed(seed)).eval()


def _state(seed):
    model = _model(seed)
    return TrainState(model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.1))


def _engine():
    model = _model(0)

    def next_token_logits(params, tokens):
        return torch.func.functional_call(model, params, (tokens,))[:, -1]

    return InferEngine(next_token_logits, device="cpu", buckets=(1, 2, 4))


def _expected(seed, rows):
    with torch.no_grad():
        return _model(seed)(torch.as_tensor(np.asarray(rows)).long())[:, -1].numpy()


def _rows(n, seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, size=(n, SEQ)).astype(np.int32)


def test_manager_exists_names_committed_checkpoints_only(tmp_path):
    manager = CheckpointManager(tmp_path)
    assert not manager.exists("best")
    manager.save("best", _state(1), epoch=1)
    assert manager.exists("best") and not manager.exists("last")
    os.makedirs(os.path.join(tmp_path, ".staging", "last.1"))  # a save not yet committed
    assert not manager.exists("last")


def test_manager_restore_latest_valid_params_only(tmp_path):
    manager = CheckpointManager(tmp_path)
    manager.save("best", _state(1), epoch=1)
    target = _state(7)
    target.step = 5
    target.optimizer.state[next(target.model.parameters())]["momentum_buffer"] = torch.ones(1)
    state, epoch, name = manager.restore_latest_valid(target, params_only=True)
    assert (epoch, name, state.step) == (1, "best", 5)  # the target's step and optimizer kept
    assert len(state.optimizer.state) == 1
    for key, value in _state(1).model.state_dict().items():
        torch.testing.assert_close(state.params[key], value, rtol=0, atol=0)


def test_restore_params_by_name_and_newest_valid(tmp_path):
    manager = CheckpointManager(tmp_path)
    manager.save("last", _state(1), epoch=1)
    time.sleep(0.02)  # newest first by commit time
    manager.save("best", _state(2), epoch=2)
    eng, target, rows = _engine(), _state(9), _rows(3)
    assert eng.restore_params(manager, target, name="last") == "last@e1"
    np.testing.assert_allclose(eng.predict(rows)[0], _expected(1, rows), atol=1e-5, rtol=0)
    assert eng.restore_params(manager, target) == "best@e2"
    # The engine serves its own copy: a later write into the target does not reach it.
    with torch.no_grad():
        for p in target.model.parameters():
            p.zero_()
    out, version = eng.predict(rows)
    assert version == "best@e2"
    np.testing.assert_allclose(out, _expected(2, rows), atol=1e-5, rtol=0)
    with open(os.path.join(manager.path("best"), "state.pt"), "r+b") as f:
        f.seek(100)
        f.write(b"torn")
    assert eng.restore_params(manager, target) == "last@e1"  # the corrupt best skipped
    with pytest.raises(CorruptCheckpointError):
        eng.restore_params(manager, target, name="best")
    assert eng.params_version == "last@e1" and eng.swap_count == 3
    before = eng.predict(rows)
    eng.replan_onto("cpu")
    after = eng.predict(rows)
    assert eng.replan_count == 1 and after[1] == before[1] == "last@e1"
    np.testing.assert_array_equal(after[0], before[0])  # the same bytes, bit-identical answers
    with pytest.raises(ValueError, match="another kind of device"):
        eng.replan_onto("meta")
    assert eng.replan_count == 1 and eng.predict(rows)[1] == "last@e1"


def _post(port, payload, route="/predict", timeout=30.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _wait(predicate, timeout=10.0, tick=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(tick)
    return False


def _events(run_dir, kind):
    with open(resolve_events_path(str(run_dir))) as f:
        return [r for r in map(json.loads, f) if r["event"] == kind]


def test_hot_swap_under_concurrent_predict(tmp_path):
    manager = CheckpointManager(tmp_path / "weights")
    manager.save("best", _state(1), epoch=1)
    eng, target = _engine(), _state(9)
    assert eng.restore_params(manager, target) == "best@e1"
    rows = _rows(6, seed=3)
    expected = {"best@e1": _expected(1, rows), "best@e2": _expected(2, rows)}
    server = InferenceServer(
        eng, batcher=MicroBatcher(buckets=eng.buckets, max_delay_s=0.002), run_dir=str(tmp_path / "run"),
        manager=manager, target_state=target, swap_poll_s=0.05, input_dtype="int32", process_index=0,
    ).start()
    answers, stop = [], threading.Event()

    def client(i):
        while not stop.is_set():
            code, body, _ = _post(server.port, {"tenant": f"t{i}", "inputs": rows[i : i + 1 + i % 2].tolist()})
            answers.append((i, code, body))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    try:
        for t in threads:
            t.start()
        # Two of the watcher's polls, and an answer under the preloaded version: it is
        # adopted, not restored again.
        assert _wait(lambda: server.swap_polls >= 2 and any(b.get("params_version") == "best@e1"
                                                             for _, _, b in answers), timeout=120)
        assert eng.swap_count == 1
        manager.save("best", _state(2), epoch=2)
        assert _wait(lambda: any(b.get("params_version") == "best@e2" for _, _, b in answers), timeout=120)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
        server.close()
    versions = set()
    for i, code, body in answers:
        assert code == 200, body
        version = body["params_version"]
        versions.add(version)
        np.testing.assert_allclose(np.asarray(body["outputs"]), expected[version][i : i + 1 + i % 2], atol=1e-5, rtol=0)
    assert versions == {"best@e1", "best@e2"} and eng.swap_count == 2
    swaps = _events(tmp_path / "run", "hot_swap")
    assert [(s["checkpoint"], s["from_version"], s["to_version"]) for s in swaps] == [("best", "best@e1", "best@e2")]


def test_torn_commit_is_never_served_and_drain_gates_the_watcher(tmp_path):
    manager = CheckpointManager(tmp_path / "weights")
    manager.save("best", _state(1), epoch=1)
    eng, target, rows, logs = _engine(), _state(9), _rows(2), []
    server = InferenceServer(
        eng, batcher=MicroBatcher(buckets=eng.buckets, max_delay_s=0.002), manager=manager, target_state=target,
        serve_name="best", swap_poll_s=0.02, input_dtype="int32", process_index=0, log=logs.append,
    ).start()
    try:
        assert _wait(lambda: eng.params_version == "best@e1")  # the first poll loads it
        # A commit whose state file was cut after its manifest was written: published by
        # the same rename a save uses.
        manager.save("staged", _state(2), epoch=2)
        staged = manager.path("staged")
        with open(os.path.join(staged, "state.pt"), "r+b") as f:
            f.truncate(1000)
        os.rename(manager.path("best"), manager.path("best.old"))
        os.rename(staged, manager.path("best"))
        shutil.rmtree(manager.path("best.old"))
        assert _wait(lambda: any("hot-swap restore failed" in m for m in logs))
        code, body, _ = _post(server.port, {"inputs": rows.tolist()})
        assert code == 200 and body["params_version"] == "best@e1"
        np.testing.assert_allclose(np.asarray(body["outputs"]), _expected(1, rows), atol=1e-5, rtol=0)
        server.drain(deadline_s=0.05)
        manager.save("best", _state(3), epoch=3)  # lands while drained: the watcher sits out
        time.sleep(10 * server.swap_poll_s)
        assert eng.params_version == "best@e1"
        server.resume()
        assert _wait(lambda: eng.params_version == "best@e3")
        code, body, _ = _post(server.port, {"inputs": rows.tolist()})
        assert code == 200 and body["params_version"] == "best@e3"
        np.testing.assert_allclose(np.asarray(body["outputs"]), _expected(3, rows), atol=1e-5, rtol=0)
    finally:
        server.close()


# ---------------------------------------------------------------------------
# The same sequences on the port's server and the JAX server.


class _Dev:
    id = 0


class StubEngine:
    """The engine surface both servers read; ``predict`` doubles its input."""

    buckets = (1, 2, 4)
    params_version = "stub@e0"
    swap_count = replan_count = 0
    chips = 1
    device = "cpu"

    class mesh:  # noqa: N801 — the JAX server reads engine.mesh.shape and .devices
        shape = {"data": 1}
        devices = np.array([_Dev()], dtype=object)

    mesh_axes = {"data": 1}  # the port server reads these

    def visible_device_ids(self):
        return [0]

    def __init__(self):
        self.trace_counts = {}

    def predict(self, inputs):
        return np.asarray(inputs) * 2.0, self.params_version

    def warmup(self, row):
        return 0.0

    def replan_onto(self, mesh):
        raise NotImplementedError("no re-plan in this stub")


def _both(run_dir, **kw):
    return [
        cls(StubEngine(), batcher=MicroBatcher(buckets=(1, 2, 4), max_delay_s=0.005), run_dir=str(run_dir / name),
            process_index=0, **kw)
        for name, cls in (("port", InferenceServer), ("jax", JaxInferenceServer))
    ]


def _drain_sequence(server):
    """Two rows queued with no dispatch running, a drain past its deadline, admission
    while drained, a second drain, resume; then the same over HTTP once started."""
    out = {}

    def call():
        out["queued"] = server.handle_predict("t0", np.ones((2, 4), np.float32))

    t = threading.Thread(target=call)
    t.start()
    assert _wait(lambda: server.batcher.pending() == 2)
    summary = server.drain(deadline_s=0.05)
    t.join(timeout=5.0)
    assert not t.is_alive()
    out["summary"] = {k: summary[k] for k in ("pending_at_drain", "shed")}
    out["while_drained"] = server.handle_predict("t1", np.ones((1, 4), np.float32))
    with pytest.raises(RuntimeError, match="already replanning"):
        server.drain()
    out["state"] = server.state
    server.state, server._drain_deadline = "draining", server._clock() + 7.0
    out["retry_floor"] = server.retry_after_s() >= 7
    server.resume()
    server.start()
    try:
        out["after_resume"] = _post(server.port, {"tenant": "t0", "inputs": [[1, 2, 3, 4]]})
        out["offer"] = _post(server.port, {"chip": 3}, route="/admin/offer")
        out["no_chip"] = _post(server.port, {}, route="/admin/offer")
        now = server._clock()
        for _ in range(20):
            server.window.add(now, 500.0)  # a breached p99
        out["offer_breached"] = _post(server.port, {"chip": 3}, route="/admin/offer")
        out["replan"] = _post(server.port, {"device_ids": [0]}, route="/admin/replan")
        out["replan_empty"] = _post(server.port, {"device_ids": []}, route="/admin/replan")
        out["serving_after"] = (server.state, _post(server.port, {"inputs": [[1, 1, 1, 1]]})[:2])
    finally:
        server.close()
    return out


def test_drain_offer_and_replan_answer_as_the_jax_server(tmp_path):
    port, ref = (_drain_sequence(s) for s in _both(tmp_path, slo_p99_ms=100.0))
    for got in (port, ref):
        code, body, headers = got["queued"]
        body = json.loads(body)
        assert code == 503 and body["error"] == "draining" and "drain deadline exceeded" in body["detail"]
        assert int(headers["Retry-After"]) >= 1
        code, body, headers = got["while_drained"]
        assert code == 503 and json.loads(body)["state"] == "replanning" and int(headers["Retry-After"]) >= 1
        assert got["summary"] == {"pending_at_drain": 2, "shed": 2}
        assert got["state"] == "replanning" and got["retry_floor"]
        assert got["after_resume"][:2] == (200, {"outputs": [[2.0, 4.0, 6.0, 8.0]], "params_version": "stub@e0"})
        assert got["offer"][:2] == (200, {"decision": "accept", "chip": 3, "reason": "healthy and serving"})
        assert got["no_chip"][0] == 400 and got["no_chip"][1]["error"] == "bad_request"
        code, body, _ = got["offer_breached"]
        assert code == 200 and body["decision"] == "decline" and "SLO pressure" in body["reason"]
        code, body, _ = got["replan"]
        assert code == 400 and body["error"] == "replan_failed" and body["state"] == "serving"
        assert got["replan_empty"][0] == 400 and got["replan_empty"][1]["error"] == "bad_request"
        assert got["serving_after"] == ("serving", (200, {"outputs": [[2.0, 2.0, 2.0, 2.0]],
                                                          "params_version": "stub@e0"}))
    for key in ("queued", "while_drained"):
        assert json.loads(port[key][1]).keys() == json.loads(ref[key][1]).keys()
    for key in ("offer", "no_chip", "offer_breached"):
        assert port[key][:2] == ref[key][:2]
    assert port["replan"][:2] == ref["replan"][:2]
    assert port["replan"][1]["detail"] == "NotImplementedError: no re-plan in this stub"
    # The target is feasible, so both servers drained once more for the stub's failed
    # rebuild, and resumed on the old plan.
    for name, drains in (("port", 2), ("jax", 2)):
        events = [json.loads(line)["event"] for line in open(resolve_events_path(str(tmp_path / name)))]
        assert events.count("drain_start") == drains
        assert [e for e in events if e.startswith("offer_")] == ["offer_accept", "offer_decline"]
