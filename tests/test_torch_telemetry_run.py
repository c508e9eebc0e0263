"""A telemetry-on run of the port against one of the JAX Trainer, and the JAX readers on it.

One module-scoped fixture trains the digits entry (VGG16 narrow, f32, batch 16, 2 epochs on
8 images a digit, ``log_every`` 2, validation and ``best``/``last`` saves) with telemetry on through the
port (in this process) and through the JAX ``DigitsTrainer`` (one subprocess, with the
stand-in ``data.streaming`` module of ``tests/test_torch_digits.py``, which cannot import
the JAX ``Trainer`` otherwise). The same subprocess then runs the JAX package's readers on
the port's run directory: ``scripts/run_doctor.py --json``, ``telemetry.timeline`` and
``scripts/run_monitor.py --once --json``.

* The event kinds come in the same order. The one listed difference: JAX emits a
  ``compile`` event (no ``kind``) for each unit that traced an executable; the port
  compiles nothing on the CPU (its stand-ins, a kernel build and a graph capture, happen
  only on the card), so those records are dropped from the JAX side before comparing. The
  FLOP probe's ``compile`` (``kind="mfu_probe"``) is in both. Heartbeats, debounced on the
  wall clock, are left out of the order on both sides.
* Each kind's fields are a superset of JAX's, except ``run_start``'s ``provenance``, whose
  keys name the port's stack (torch, CUDA, nvcc, the card) in place of jax/jaxlib/XLA flags,
  and ``kernel_dispatch``'s ``seq_len`` (JAX's LM field; no LM here). Extra in the port:
  ``compile``'s ``seconds``.
* The goodput buckets are the same; ``run_end``'s fractions sum to 1.
* JAX's doctor gives the port's run a verdict, and the port's doctor the same verdict and
  ``Diagnosis.to_dict()`` on the same events; the timeline builds; the monitor reads it.
* The port's own readers on the port's run: its timeline and its monitor's status (one
  fake clock) byte-equal to the JAX package's in this process, the timeline's goodput
  spans re-deriving the meter's fractions, and ``scripts/torch_run_doctor.py --json`` and
  ``scripts/torch_run_monitor.py --once --json`` saying what the JAX scripts said.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("cv2")
pytest.importorskip("sklearn")

from distributed_training_pytorch_tpu_torch.examples import digits_data, train_digits  # noqa: E402
from distributed_training_pytorch_tpu_torch.models import create_model  # noqa: E402
from distributed_training_pytorch_tpu_torch.ops import dispatch  # noqa: E402
from distributed_training_pytorch_tpu_torch.telemetry import Telemetry, doctor, load_run_events  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(stage_features=[8, 8, 16, 16, 16], classifier_widths=[32, 32], dropout_rate=0.0)
SUBSET, BATCH, EPOCHS = 8, 16, 2
# A heartbeat at every log_every sync on both sides: under the default 30 s debounce, which
# heartbeats a run writes (the first carries no step_ms) depends on how long it runs.
HEARTBEAT_EVERY_S = 1e-9

_JAX_SIDE = textwrap.dedent(
    """
    import contextlib, io, json, os, runpy, sys, types

    stub = types.ModuleType("distributed_training_pytorch_tpu.data.streaming")
    def _unavailable(*a, **k):
        raise RuntimeError("data/streaming is not in this tree")
    for name in ("DecodePool", "ReaderState", "StreamingLoader", "shard_array_source"):
        setattr(stub, name, _unavailable)
    sys.modules[stub.__name__] = stub

    out, subset, jax_dir, port_dir, batch, epochs, narrow, hb = sys.argv[1:9]
    HEARTBEAT_EVERY_S = float(hb)
    import jax.numpy as jnp
    from distributed_training_pytorch_tpu.models import VGG16
    from distributed_training_pytorch_tpu.telemetry import Telemetry
    from examples import digits_data
    from examples.train_digits import DigitsTrainer

    class Narrow(DigitsTrainer):
        def build_model(self):
            return VGG16(num_classes=len(self.labels), dtype=jnp.float32, **json.loads(narrow))

    trainer = Narrow(train_path=os.path.join(subset, "train"), val_path=os.path.join(subset, "test"),
                     labels=digits_data.LABELS, height=digits_data.SIZE, width=digits_data.SIZE,
                     max_epoch=int(epochs), batch_size=int(batch), have_validate=True, save_period=1,
                     last_save_period=1, save_folder=jax_dir, progress=False, async_checkpoint=False,
                     telemetry=Telemetry(heartbeat_every_s=HEARTBEAT_EVERY_S), num_workers=0, log_every=2)
    trainer.train()
    import time
    deadline = time.monotonic() + 600
    while not os.path.exists(port_dir + ".done") and time.monotonic() < deadline:
        time.sleep(0.1)  # the port's run trains meanwhile, in the test's process

    def run_script(path, *argv):
        buf = io.StringIO()
        saved = sys.argv
        sys.argv = [path, *argv]
        code = 0
        try:
            with contextlib.redirect_stdout(buf):
                runpy.run_path(path, run_name="__main__")
        except SystemExit as e:
            code = e.code or 0
        finally:
            sys.argv = saved
        return code, buf.getvalue()

    record = {}
    code, text = run_script(os.path.join("scripts", "run_doctor.py"), port_dir, "--json")
    record["doctor"] = {"code": code, "out": json.loads(text)}
    from distributed_training_pytorch_tpu.telemetry import timeline
    from distributed_training_pytorch_tpu.telemetry.events import load_run_events
    trace = timeline.build_timeline(load_run_events(port_dir))
    record["timeline_events"] = len(trace["traceEvents"])
    code, text = run_script(os.path.join("scripts", "run_monitor.py"), port_dir, "--once", "--json")
    record["monitor"] = {"code": code, "out": text}
    with open(out, "w") as f:
        json.dump(record, f)
    """
)


class _Narrow(train_digits.DigitsTrainer):
    def build_model(self):
        return create_model("vgg16", num_classes=len(self.labels), dtype=self.precision.compute_dtype,
                            device=self.device, **NARROW)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import shutil

    base = tmp_path_factory.mktemp("telemetry_run")
    tree, subset = str(base / "tree"), str(base / "subset")
    digits_data.materialize(tree)
    for split in ("train", "test"):
        for label in digits_data.LABELS:
            os.makedirs(os.path.join(subset, split, label))
            for f in sorted(os.listdir(os.path.join(tree, split, label)))[:SUBSET]:
                shutil.copy(os.path.join(tree, split, label, f), os.path.join(subset, split, label, f))
    port_dir, jax_dir = str(base / "port"), str(base / "jax")
    out = str(base / "jax_side.json")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=1")
    for knob in ("PYTHONPATH", "PALLAS", "DTYPE", "MESH", "TELEMETRY", "CHAIN_STEPS", "DIGITS_LR"):
        env.pop(knob, None)
    proc = subprocess.Popen([sys.executable, "-c", _JAX_SIDE, out, subset, jax_dir, port_dir, str(BATCH), str(EPOCHS),
                             json.dumps(NARROW), repr(HEARTBEAT_EVERY_S)], cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)
    saved = {k: os.environ.pop(k, None) for k in ("DTYPE", "MESH", "TELEMETRY", "SNAPSHOT", "CHAIN_STEPS")}
    # The dispatch records of this process start afresh, as the JAX subprocess's do: a
    # decision another test recorded before any event log existed would flush into this run's.
    dispatch.reset()
    try:
        trainer = _Narrow(train_path=os.path.join(subset, "train"), val_path=os.path.join(subset, "test"),
                          labels=digits_data.LABELS, height=digits_data.SIZE, width=digits_data.SIZE,
                          max_epoch=EPOCHS, batch_size=BATCH, have_validate=True, save_period=1, last_save_period=1,
                          save_folder=port_dir, async_checkpoint=False,
                          telemetry=Telemetry(heartbeat_every_s=HEARTBEAT_EVERY_S), num_workers=0, device="cpu", log_every=2,
                          tensorboard_dir=str(base / "tb"))
        trainer.train()
    finally:
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
        with open(port_dir + ".done", "w") as f:
            f.write("done\n")
    try:
        _, err = proc.communicate(timeout=900)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    with open(out) as f:
        readers = json.load(f)
    return {"port": load_run_events(port_dir), "jax": load_run_events(jax_dir), "readers": readers,
            "tb": str(base / "tb"), "trainer": trainer, "port_dir": port_dir}


def _kinds(evs):
    return [e["event"] for e in evs]


def test_the_same_event_kinds_in_the_same_order(runs):
    # Heartbeats are debounced on the wall clock (one a heartbeat_every_s), so how many a
    # run writes depends on how long it takes, on either side; they are left out here.
    jax_events = [e for e in runs["jax"] if not (e["event"] == "compile" and "kind" not in e)]
    assert [k for k in _kinds(runs["port"]) if k != "heartbeat"] == [k for k in _kinds(jax_events) if k != "heartbeat"]
    assert {"run_start", "window", "epoch_end", "checkpoint_save", "compile", "run_end"} <= set(_kinds(runs["port"]))


def test_each_kind_carries_the_jax_fields(runs):
    allowed_missing = {"run_start": {"provenance"}, "kernel_dispatch": {"seq_len"}}
    jax_fields, port_fields = {}, {}
    for evs, fields in ((runs["jax"], jax_fields), (runs["port"], port_fields)):
        for e in evs:
            key = ("compile", e.get("kind")) if e["event"] == "compile" else e["event"]
            fields.setdefault(key, set()).update(e)
    for kind, fields in port_fields.items():
        missing = jax_fields[kind] - fields - allowed_missing.get(kind, set())
        assert not missing, (kind, missing)
    start = next(e for e in runs["port"] if e["event"] == "run_start")
    assert {"git_sha", "torch", "mesh", "dtype", "chain_steps", "batch"} <= set(start["provenance"])


def test_the_same_goodput_buckets(runs):
    def end(evs):
        return next(e for e in evs if e["event"] == "run_end")

    port, ref = end(runs["port"]), end(runs["jax"])
    assert set(port["goodput_seconds"]) == set(ref["goodput_seconds"])
    assert abs(sum(port["goodput_fractions"].values()) - 1.0) < 1e-9
    health = next(e for e in runs["port"] if e["event"] == "epoch_end")
    assert {"grad_norm", "update_ratio", "nonfinite", "step_ms", "mfu"} <= set(health)


def test_the_jax_readers_read_the_port_run(runs):
    readers = runs["readers"]
    theirs = readers["doctor"]["out"]
    ours = doctor.diagnose(runs["port"]).to_dict()
    assert theirs["verdict"] == ours["verdict"]
    assert {k: theirs[k] for k in ours} == json.loads(json.dumps(ours))
    assert readers["timeline_events"] > 0
    assert readers["monitor"]["out"].strip()


def test_tensorboard_dir_holds_the_run_scalars(runs):
    # TensorBoard's own protobuf decodes each record (the file's framing is checked by
    # tests/test_torch_telemetry.py, which reads a writer's files with EventAccumulator).
    import struct

    from tensorboard.compat.proto import event_pb2

    (name,) = os.listdir(runs["tb"])
    with open(os.path.join(runs["tb"], name), "rb") as f:
        raw = f.read()
    scalars, at = {}, 0
    while at < len(raw):
        (n,) = struct.unpack("<Q", raw[at:at + 8])
        event = event_pb2.Event.FromString(raw[at + 12:at + 12 + n])
        at += 16 + n
        for value in event.summary.value:
            scalars.setdefault(value.tag, []).append((event.step, value.simple_value))
    assert {"train/loss", "goodput/productive_step", "telemetry/step_ms", "doctor/healthy"} <= set(scalars)
    assert len(scalars["train/loss"]) == EPOCHS


def _script(monkeypatch, capsys, name, *argv):
    import runpy

    monkeypatch.setattr(sys, "argv", [name, *argv])
    with pytest.raises(SystemExit) as done:
        runpy.run_path(os.path.join(REPO, "scripts", name), run_name="__main__")
    return done.value.code, capsys.readouterr().out


def test_the_port_readers_match_the_jax_readers_on_the_port_run(runs, monkeypatch, capsys):
    import time

    from distributed_training_pytorch_tpu.telemetry import monitor as jax_monitor
    from distributed_training_pytorch_tpu.telemetry import timeline as jax_timeline
    from distributed_training_pytorch_tpu.telemetry.events import load_run_events as jax_load
    from distributed_training_pytorch_tpu_torch.telemetry import monitor, timeline

    port_dir = runs["port_dir"]
    ours = timeline.build_timeline(load_run_events(port_dir))
    assert json.dumps(ours, sort_keys=True) == json.dumps(jax_timeline.build_timeline(jax_load(port_dir)), sort_keys=True)
    spans = timeline.span_bucket_seconds(ours)
    end = next(e for e in runs["port"] if e["event"] == "run_end")
    for bucket, fraction in end["goodput_fractions"].items():
        assert abs(spans[bucket] / sum(spans.values()) - fraction) < 1e-9, bucket
    now = time.time() + 5.0
    statuses = [mod.RunMonitor(port_dir, clock=lambda: now).poll() for mod in (monitor, jax_monitor)]
    assert json.dumps(statuses[0].to_dict(), sort_keys=True) == json.dumps(statuses[1].to_dict(), sort_keys=True)
    assert statuses[0].status == "finished"
    code, out = _script(monkeypatch, capsys, "torch_run_doctor.py", port_dir, "--json")
    assert code == 0 and json.loads(out) == runs["readers"]["doctor"]["out"]
    code, out = _script(monkeypatch, capsys, "torch_run_monitor.py", port_dir, "--once", "--json")
    theirs = json.loads(runs["readers"]["monitor"]["out"])
    ours = json.loads(out)
    assert code == runs["readers"]["monitor"]["code"]
    assert {k: ours[k] for k in ("status", "verdict", "exit_code", "diagnosis")} == {
        k: theirs[k] for k in ("status", "verdict", "exit_code", "diagnosis")}
