#!/usr/bin/env python
"""The perf gate of the PyTorch port: a measured step time against a committed baseline.

Measures, then gates the measurement against its entry in ``TORCH_PERF_BASELINE.json``
(``profiling/gate.py``: fail when measured > baseline x (1 + tolerance)). It imports the
port alone, so it runs on the card's machine. The entry's key is the mode and the device
type: ``quick-cuda``, ``quick-cpu``, ``data-wait-cuda``, ...

* ``--quick``: a small fixed workload (two 3x3 convolutions and a dense layer, batch 64 of
  16x16x3, SGD with momentum) through the real ``TrainEngine`` chained path, windows of 8
  steps (one captured CUDA graph a window on the card), timed beside a fixed calibration
  (8 matmuls of 384x384 with tanh; one captured graph on the card) in adjacent pairs; the
  gated figure is the median pair's ``step_per_calib``, the step's time over the
  calibration's, which cancels the machine's speed to first order (tolerance 50 %). On the
  card both are timed with CUDA events around graph replays, so that the host's launch
  jitter stays out of the ratio; on the CPU with the host's clock. One extra traced window adds the
  step's ``categories`` (``profiling.analyze_trace``), so a failure against an entry that
  has them prints the per-category attribution of the step's delta
  (``profiling.diff.attribute_entry_delta``).
* ``--data-wait``: two epochs of a small conv ``Trainer`` on the digits corpus (batch 128,
  ``CHAIN_STEPS`` 2, telemetry on), gating the steady-state ``data_wait`` goodput fraction
  (``telemetry.doctor.steady_fractions``) against a ceiling; ``--update`` records
  ``max(0.10, 2 x measured)``. ``--inject-data-wait S`` sleeps S seconds in every batch's
  production (the loader's ``load_delay_s``), which must fail it.
* the default mode, the headline cell's absolute ``step_ms``, comes with the port's
  benchmark (``ROADMAP.md`` Queue 1 item 1); asked for now, it says so and exits 2.

``--inject-slowdown F`` multiplies the measured step time by F after the measurement, which
must fail the gate; ``--update`` records the measurement as the entry (refused with an
injection). ``--device`` picks the card (default) or the CPU.

Exit codes: 0 pass, 1 regression, 2 refused, 3 no entry for the key, 4 an unusable entry.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch import nn  # noqa: E402

from distributed_training_pytorch_tpu_torch.profiling import diff as diff_lib  # noqa: E402
from distributed_training_pytorch_tpu_torch.profiling import gate as gate_lib  # noqa: E402

QUICK_STEPS = 8
QUICK_REPS = 10  # windows (and calibrations) a timed sample
QUICK_PAIRS = 7
QUICK_TOLERANCE = 0.5
DATA_WAIT_TOLERANCE = 0.25
DATA_WAIT_FLOOR_CEILING = 0.10


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _seconds(fn, device) -> float:
    """``fn``'s time: CUDA events around it on the card, the host's clock on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def paired_ratio(run_step, run_calib, device, pairs: int = QUICK_PAIRS) -> "tuple[float, float, float]":
    """The median of adjacent (workload, calibration) pairs' ratios, and that pair's two
    times: machine load cancels within a pair."""
    samples = []
    for _ in range(pairs):
        step_s = _seconds(run_step, device)
        calib_s = _seconds(run_calib, device)
        samples.append((step_s / calib_s, step_s, calib_s))
    samples.sort(key=lambda s: s[0])
    return samples[len(samples) // 2]


class GateNet(nn.Module):
    """Two 3x3 convolutions (8 channels, then 16 at stride 2) and a dense layer to 10."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 8, 3, padding=1)
        self.conv2 = nn.Conv2d(8, 16, 3, stride=2, padding=1)
        self.dense = nn.Linear(16 * 8 * 8, 10)

    def forward(self, x):
        x = torch.relu(self.conv1(x.permute(0, 3, 1, 2)))
        x = torch.relu(self.conv2(x))
        return self.dense(x.flatten(1))


def measure_quick(device) -> dict:
    from distributed_training_pytorch_tpu_torch.ops.losses import cross_entropy_loss
    from distributed_training_pytorch_tpu_torch.profiling import analyze_trace, trace
    from distributed_training_pytorch_tpu_torch.train import TrainEngine, TrainState

    torch.manual_seed(0)
    model = GateNet().to(device)
    opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)

    def loss_fn(m, batch, train):
        loss = cross_entropy_loss(m(batch["image"]), batch["label"])
        return loss, {"loss": loss}

    engine = TrainEngine(loss_fn, schedule=lambda step: 0.05)
    state = TrainState(model=model, optimizer=opt)
    rng = np.random.RandomState(0)
    image = torch.as_tensor(rng.randn(64, 16, 16, 3).astype(np.float32))
    label = torch.as_tensor(rng.randint(0, 10, size=(64,)).astype(np.int64))
    window = {"image": image.expand(QUICK_STEPS, *image.shape).contiguous().to(device),
              "label": label.expand(QUICK_STEPS, *label.shape).contiguous().to(device)}

    def run_windows():
        nonlocal state
        for _ in range(QUICK_REPS):
            state, metrics = engine.train_steps_chained(state, window, QUICK_STEPS)
        if device.type != "cuda":
            float(metrics["loss"][-1])

    w = torch.as_tensor(rng.randn(384, 384).astype(np.float32) * 0.05).to(device)
    x0 = torch.ones(384, 384, device=device)

    def calib():
        x = x0
        for _ in range(8):
            x = torch.tanh(x @ w)
        return x

    if device.type == "cuda":
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            calib()  # warm, off the capture
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            calib()

        def run_calibs():
            for _ in range(QUICK_REPS):
                graph.replay()
    else:
        def run_calibs():
            for _ in range(QUICK_REPS):
                calib()

    run_windows()  # the first window captures the graph on the card
    run_calibs()
    _sync(device)
    ratio, step_s, calib_s = paired_ratio(run_windows, run_calibs, device)
    measurement = {
        "workload": "gatenet-conv16x16-b64-chain8",
        "platform": device.type,
        "steps": QUICK_STEPS,
        "step_ms": round(step_s / (QUICK_REPS * QUICK_STEPS) * 1e3, 4),
        "calib_ms": round(calib_s / QUICK_REPS * 1e3, 4),
        "step_per_calib": round(ratio / QUICK_STEPS, 4),
    }
    if device.type == "cuda":
        from distributed_training_pytorch_tpu_torch.telemetry.provenance import provenance_fields

        prov = provenance_fields()  # the card's name and power limit, as nvidia-smi gives them
        measurement["card"] = prov.get("card") or torch.cuda.get_device_name(device)
        measurement["power_limit"] = prov.get("power_limit")
    prof_dir = tempfile.mkdtemp(prefix="torch_perf_gate_prof_")
    try:
        with trace(prof_dir, device):
            state, metrics = engine.train_steps_chained(state, window, QUICK_STEPS)
            float(metrics["loss"][-1])
        prof = analyze_trace(prof_dir, steps=QUICK_STEPS)
        measurement["categories"] = {k: round(v, 4) for k, v in prof.categories.items() if v}
    except (ValueError, FileNotFoundError, OSError, RuntimeError) as e:
        print(f"torch_perf_gate: the category capture failed ({e}): a failure against this measurement will be "
              "unattributed", file=sys.stderr)
    finally:
        shutil.rmtree(prof_dir, ignore_errors=True)
    return measurement


def measure_data_wait(device, inject_delay_s: "float | None" = None) -> dict:
    from distributed_training_pytorch_tpu_torch.data import ArrayDataSource
    from distributed_training_pytorch_tpu_torch.examples.digits_data import load_digits
    from distributed_training_pytorch_tpu_torch.ops.losses import cross_entropy_loss
    from distributed_training_pytorch_tpu_torch.telemetry import Telemetry
    from distributed_training_pytorch_tpu_torch.telemetry import doctor as doctor_lib
    from distributed_training_pytorch_tpu_torch.trainer import Trainer

    class GateTrainer(Trainer):
        def build_train_dataset(self):
            images, targets = load_digits()
            return ArrayDataSource(image=(images / 16.0).astype(np.float32)[..., None], label=targets)

        def build_model(self):
            return nn.Sequential(_NHWC(), nn.Conv2d(1, 16, 3, padding=1), nn.ReLU(), nn.Conv2d(16, 32, 3, padding=1),
                                 nn.ReLU(), nn.Flatten(), nn.Linear(32 * 8 * 8, 10))

        def build_criterion(self):
            def criterion(logits, batch):
                loss = cross_entropy_loss(logits, batch["label"])
                return loss, {"loss": loss}

            return criterion

        def build_optimizer(self, schedule):
            return torch.optim.SGD(self.model.parameters(), lr=0.1, momentum=0.9)

        def build_scheduler(self):
            return 0.1

        def build_dataloader(self, dataset, phase="train"):
            loader = super().build_dataloader(dataset, phase)
            if inject_delay_s:
                loader.load_delay_s = float(inject_delay_s)
            return loader

    tmp = tempfile.mkdtemp(prefix="torch_perf_gate_data_wait_")
    try:
        trainer = GateTrainer(max_epoch=2, batch_size=128, save_folder=tmp, telemetry=Telemetry(anomaly=None, mfu=False),
                              chain_steps=2, log_every=4, num_workers=0, have_validate=False, save_period=None,
                              device=device, logger=type("Quiet", (), {"log": staticmethod(lambda *a, **k: None)})())
        trainer.train()
        seconds = trainer.goodput.to_state()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    steady = doctor_lib.steady_fractions(seconds)
    return {
        "workload": "digits-conv-b128-chain2",
        "platform": device.type,
        "data_wait_frac": round(max(steady["data_wait"], 1e-6), 4),
        "data_wait_s": round(seconds["data_wait"], 4),
        "injected_delay_s": inject_delay_s or 0,
    }


class _NHWC(nn.Module):
    def forward(self, x):
        return x.permute(0, 3, 1, 2)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true", help="the calibrated-ratio mode")
    parser.add_argument("--data-wait", action="store_true", help="gate the steady-state data_wait fraction")
    parser.add_argument("--inject-data-wait", type=float, default=None, metavar="S",
                        help="sleep S seconds in every batch's production before measuring")
    parser.add_argument("--baseline", default=gate_lib.DEFAULT_BASELINE_PATH,
                        help="the baseline file (default: TORCH_PERF_BASELINE.json at the repo's root)")
    parser.add_argument("--tolerance", type=float, default=None, help="a relative tolerance (0.5 = +50%%)")
    parser.add_argument("--update", action="store_true", help="record this measurement as the entry")
    parser.add_argument("--inject-slowdown", type=float, default=None, metavar="F",
                        help="multiply the measured step time by F")
    parser.add_argument("--device", default=None, help="cuda (the default where there is a card) or cpu")
    parser.add_argument("--events", default=None, help="append a perf_gate record to this JSONL event log")
    args = parser.parse_args()
    if args.update and (args.inject_slowdown or args.inject_data_wait):
        print("torch_perf_gate: refusing --update with an injection (a poisoned baseline would mask regressions)")
        return 2
    if args.tolerance is not None and args.tolerance <= 0:
        parser.error("--tolerance must be > 0")
    if args.data_wait and args.quick:
        parser.error("--data-wait and --quick are two measurements: run them separately")
    if args.inject_data_wait and not args.data_wait:
        parser.error("--inject-data-wait applies to --data-wait only")
    if args.data_wait and args.inject_slowdown:
        parser.error("--inject-slowdown scales a step time, which --data-wait has none of: use --inject-data-wait")
    if not (args.quick or args.data_wait):
        print("torch_perf_gate: the default mode gates the headline cell's absolute step_ms, which comes with the "
              "port's benchmark (ROADMAP.md Queue 1 item 1); run --quick or --data-wait")
        return 2
    device = torch.device(args.device or ("cuda" if torch.cuda.is_available() else "cpu"))
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    if args.data_wait:
        if args.inject_data_wait:
            print(f"torch_perf_gate: injecting a {args.inject_data_wait} s sleep a batch (the gate must fail)")
        measurement = measure_data_wait(device, args.inject_data_wait)
        key = "data-wait-" + measurement["platform"]
        default_tol = DATA_WAIT_TOLERANCE
    else:
        measurement = measure_quick(device)
        key = "quick-" + measurement["platform"]
        default_tol = QUICK_TOLERANCE
    if args.inject_slowdown:
        factor = float(args.inject_slowdown)
        measurement["step_ms"] = round(measurement["step_ms"] * factor, 4)
        measurement["step_per_calib"] = round(measurement["step_per_calib"] * factor, 4)
        measurement["injected_slowdown"] = factor
        print(f"torch_perf_gate: injected a x{factor} slowdown into the measurement (the gate must fail)")
    print(f"torch_perf_gate: {key}: " + json.dumps(measurement))

    if args.update and args.data_wait:
        measurement = dict(measurement, measured_data_wait_frac=measurement["data_wait_frac"],
                           data_wait_frac=round(max(DATA_WAIT_FLOOR_CEILING, 2 * measurement["data_wait_frac"]), 4))
    if args.update:
        tol = args.tolerance
        if tol is None:
            try:
                tol = gate_lib.load_baseline(args.baseline).get("tolerance", {}).get(key, default_tol)
            except (FileNotFoundError, ValueError):
                tol = default_tol
        gate_lib.update_baseline(args.baseline, key, measurement, tolerance=tol)
        print(f"torch_perf_gate: entry {key!r} recorded in {args.baseline}")
        return 0
    try:
        baseline = gate_lib.load_baseline(args.baseline)
        result = gate_lib.evaluate(baseline, key, measurement, tolerance=args.tolerance, default_tolerance=default_tol)
    except (FileNotFoundError, KeyError) as e:
        print(f"torch_perf_gate: NO BASELINE — {e}")
        return 3
    except ValueError as e:
        print(f"torch_perf_gate: BAD BASELINE — {e}")
        return 4
    print("torch_perf_gate: " + result.describe())
    attribution = None
    if not result.passed:
        attribution = diff_lib.attribute_entry_delta(baseline["entries"].get(key, {}), measurement)
        if attribution:
            print("torch_perf_gate: FAIL attribution (step_ms delta by category): "
                  + diff_lib.describe_rows(attribution))
        elif args.quick:
            print("torch_perf_gate: FAIL unattributed — the entry or this measurement has no `categories`")
    if args.events:
        from distributed_training_pytorch_tpu_torch.telemetry import EventLog

        log = EventLog(args.events, process_index=0)
        log.emit("perf_gate", key=key, metric=result.metric, measured=result.measured, baseline=result.baseline,
                 ratio=result.ratio, tolerance=result.tolerance, passed=result.passed,
                 attribution=[r.to_dict() for r in attribution] if attribution else None)
        log.close()
    return 0 if result.passed else 1


if __name__ == "__main__":
    sys.exit(main())
