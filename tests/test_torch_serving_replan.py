"""The port's serving re-plan (``InferEngine.replan_onto``, ``InferenceServer.
drain_and_replan``, ``POST /admin/replan``) on the CPU, held against the JAX server.

* Under concurrent ``/predict`` (four client threads, each retrying a typed 503 as a
  client should), a re-plan onto ``{"device_ids": [0]}`` answers 200: every request ends
  in a 200, every answer is bit-identical to the one the same row got before the re-plan
  (the same params, the same arithmetic), the replica is serving again, and one
  ``replan_done`` is written.
* The same re-plan on the JAX server over a JAX engine (one of the conftest's CPU devices)
  and on the port's: the same codes, the same summary keys and values (state, device ids,
  mesh, params version, reason, shed) and the same ``replan_done`` fields; an unknown id is
  refused by both with the same error, and a re-plan during a drain answers 409 on both.
* Refusals the port adds (an id this process does not see, more devices than one process
  serves) answer 400 before anything drains, and the replica keeps serving.
"""

import json
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
from distributed_training_pytorch_tpu_torch.models import LMTiny
from distributed_training_pytorch_tpu_torch.serving import InferEngine, InferenceServer, MicroBatcher
from distributed_training_pytorch_tpu_torch.telemetry.events import resolve_events_path

VOCAB, SEQ = 64, 12
REPLAN_DONE_FIELDS = {"attempt", "from_mesh", "to_mesh", "device_ids", "shed", "replan_ms", "params_version",
                      "replans", "plan_reason"}


def _post(port, payload, route="/predict", timeout=30.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _events(run_dir):
    return [json.loads(line) for line in open(resolve_events_path(str(run_dir)))]


def _lm_server(run_dir):
    model = LMTiny(vocab_size=VOCAB, max_len=32, device="cpu", generator=torch.Generator().manual_seed(0)).eval()

    def next_token_logits(params, tokens):
        return torch.func.functional_call(model, params, (tokens,))[:, -1]

    engine = InferEngine(next_token_logits, device="cpu", buckets=(1, 2, 4))
    engine.swap_params(dict(model.state_dict()), version="v1")
    server = InferenceServer(engine, batcher=MicroBatcher(buckets=(1, 2, 4), max_delay_s=0.002),
                             run_dir=str(run_dir), input_dtype="int64", process_index=0)
    return engine, server


def test_replan_under_concurrent_predict_loses_nothing_and_answers_bit_identical(tmp_path):
    engine, server = _lm_server(tmp_path)
    rows = np.random.RandomState(1).randint(0, VOCAB, size=(4, SEQ)).tolist()
    server.start()
    try:
        before = {i: _post(server.port, {"inputs": [row]})[1]["outputs"][0] for i, row in enumerate(rows)}
        answers, stop = [], threading.Event()

        def client(i):
            while not stop.is_set():
                code, body, _ = _post(server.port, {"tenant": f"t{i}", "inputs": [rows[i]]})
                while code == 503:  # a drain's typed refusal: the client comes back
                    time.sleep(0.01)
                    code, body, _ = _post(server.port, {"tenant": f"t{i}", "inputs": [rows[i]]})
                answers.append((i, code, body))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        code, summary, _ = _post(server.port, {"device_ids": [0]}, route="/admin/replan")
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        after = {i: _post(server.port, {"inputs": [row]})[1]["outputs"][0] for i, row in enumerate(rows)}
    finally:
        server.close()
    assert code == 200, summary
    assert summary["state"] == "serving" and summary["device_ids"] == [0] and summary["mesh_axes"] == {"data": 1}
    assert summary["params_version"] == "v1" and engine.replan_count == 1
    assert len(answers) > 8 and all(c == 200 for _, c, _ in answers)
    for i, _, body in answers:
        assert body["outputs"][0] == before[i] and body["params_version"] == "v1"
    assert after == before
    done = [e for e in _events(tmp_path) if e["event"] == "replan_done"]
    assert len(done) == 1 and REPLAN_DONE_FIELDS <= set(done[0]) and done[0]["replans"] == 1


def _linear_apply(params, x):
    return x @ params["w"]


def _replan_sequence(server):
    out = {}
    server.start()
    try:
        out["before"] = _post(server.port, {"inputs": [[1, 2, 3, 4]]})[:2]
        out["replan"] = _post(server.port, {"device_ids": [0]}, route="/admin/replan")[:2]
        out["after"] = _post(server.port, {"inputs": [[1, 2, 3, 4]]})[:2]
        out["unknown"] = _post(server.port, {"device_ids": [99]}, route="/admin/replan")[:2]
        server.state = "draining"
        out["busy"] = _post(server.port, {"device_ids": [0]}, route="/admin/replan")[:2]
        server.resume()
        out["serving"] = (server.state, _post(server.port, {"inputs": [[1, 1, 1, 1]]})[:2])
    finally:
        server.close()
    return out


def test_the_replan_answers_as_the_jax_server(devices, tmp_path):
    w = np.eye(4, dtype=np.float32) * 2.0
    jax_engine = JaxInferEngine(_linear_apply, mesh_config_from_spec("dp1").build(devices[:1]), buckets=(1, 2))
    jax_engine.swap_params({"w": jax.device_put(w)}, version="v1")
    port_engine = InferEngine(_linear_apply, device="cpu", buckets=(1, 2))
    port_engine.swap_params({"w": torch.from_numpy(w.copy())}, version="v1")
    got = {}
    for name, cls, engine in (("port", InferenceServer, port_engine), ("jax", JaxInferenceServer, jax_engine)):
        server = cls(engine, batcher=MicroBatcher(buckets=(1, 2), max_delay_s=0.002), run_dir=str(tmp_path / name),
                     process_index=0)
        got[name] = _replan_sequence(server)
    port, ref = got["port"], got["jax"]
    assert port["before"] == ref["before"] == port["after"] == ref["after"]
    assert port["replan"][0] == ref["replan"][0] == 200
    assert port["replan"][1].keys() == ref["replan"][1].keys()
    for key in ("state", "device_ids", "mesh_axes", "params_version", "plan_reason", "shed", "pending_at_drain"):
        assert port["replan"][1][key] == ref["replan"][1][key], key
    for out in (port, ref):
        code, body = out["unknown"]
        assert code == 400 and body["error"] == "replan_failed" and body["state"] == "serving"
        assert body["detail"].startswith("ValueError: replan target names unknown device id(s) [99]")
        assert out["busy"][0] == 409 and out["busy"][1]["error"] == "busy"
        assert out["serving"] == ("serving", (200, {"outputs": [[2.0, 2.0, 2.0, 2.0]], "params_version": "v1"}))
    done = {name: [e for e in _events(tmp_path / name) if e["event"] == "replan_done"] for name in got}
    assert len(done["port"]) == len(done["jax"]) == 1
    assert set(done["port"][0]) == set(done["jax"][0]) and REPLAN_DONE_FIELDS <= set(done["port"][0])
    for key in ("from_mesh", "to_mesh", "device_ids", "shed", "params_version", "replans", "plan_reason"):
        assert done["port"][0][key] == done["jax"][0][key], key


def test_targets_the_port_cannot_hold_are_refused_before_the_drain(tmp_path, monkeypatch):
    engine, server = _lm_server(tmp_path)
    server.start()
    try:
        refused = [_post(server.port, {"device_ids": [1]}, route="/admin/replan")[:2]]
        monkeypatch.setattr(engine, "visible_device_ids", lambda: [0, 1])
        refused.append(_post(server.port, {"device_ids": [0, 1]}, route="/admin/replan")[:2])
        serving = _post(server.port, {"inputs": [[1] * SEQ]})[:2]
    finally:
        server.close()
    (code1, body1), (code2, body2) = refused
    assert code1 == code2 == 400 and body1["error"] == body2["error"] == "replan_failed"
    assert "unknown device id(s) [1]" in body1["detail"] and "one process of the port serves one device" in body2["detail"]
    assert body1["state"] == body2["state"] == "serving" and server.state == "serving"
    assert serving[0] == 200 and serving[1]["params_version"] == "v1"
    assert engine.replan_count == 0 and server.drain_count == 0
    assert not [e for e in _events(tmp_path) if e["event"] in ("drain_start", "replan_done")]


def test_replan_onto_keeps_the_version_and_refuses_another_kind_of_device():
    engine = InferEngine(_linear_apply, device="cpu", buckets=(1, 2))
    engine.swap_params({"w": np.eye(4, dtype=np.float32)}, version="v7")
    x = np.arange(8, dtype=np.float32).reshape(2, 4)
    before = engine.predict(x)
    engine.warmup(x[0])
    assert engine.trace_counts["infer_step"] == 2 and engine.mesh_axes == {"data": 1} and engine.device_ids == [0]
    engine.replan_onto(torch.device("cpu"))
    engine.warmup(x[0])
    assert engine.trace_counts["infer_step"] == 4  # the entries were forgotten and counted again
    out = engine.predict(x)
    assert out[1] == before[1] == "v7" and np.array_equal(out[0], before[0])
    with pytest.raises(ValueError, match="another kind of device"):
        engine.replan_onto("meta")
    assert engine.replan_count == 1
