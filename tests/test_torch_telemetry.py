"""The port's telemetry and profiling modules against the JAX package's, on the same inputs.

* goodput: one tick sequence on a fake clock gives equal buckets, fractions and state,
  and the state round-trips through JSON bit for bit;
* anomaly: one observation stream gives the same findings (kind, step, value, baseline);
* the doctor: one event list gives equal ``Diagnosis.to_dict()`` and scalar fields, for a
  healthy run and for each verdict;
* ``window_report`` and ``mfu_value`` equal on the same numbers; the peak table names the
  H100 parts and gives no MFU for an unknown card;
* ``prometheus_text`` equal on one snapshot; ``StatusExporter``'s ``/status`` and
  ``/metrics`` equal to JAX's on that snapshot, and a taken port degrades to a warning;
* the event log's readers (``EventFollower``, ``load_run_events``, ``read_events``) equal
  to JAX's on one file with a torn tail;
* ``categorize`` on a table of real CUDA kernel names, and on HLO names as JAX gives them;
* ``analyze_trace`` on one synthetic set of device intervals, written as an XSpace through
  JAX's ``xplane.encode_xspace`` and as a Kineto JSON: equal ``StepProfile`` fields;
* ``MetricsWriter``'s own event files read back by TensorBoard's ``EventAccumulator``
  equal to the scalars the JAX writer writes through ``tensorboardX`` for the same calls;
* straggler fields and the provenance record's keys.
"""

import json
import math
import sys
import urllib.request
import warnings

import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu.profiling import report as jax_report
from distributed_training_pytorch_tpu.profiling import xplane
from distributed_training_pytorch_tpu.telemetry import anomaly as jax_anomaly
from distributed_training_pytorch_tpu.telemetry import doctor as jax_doctor
from distributed_training_pytorch_tpu.telemetry import events as jax_events
from distributed_training_pytorch_tpu.telemetry import exporter as jax_exporter
from distributed_training_pytorch_tpu.telemetry import goodput as jax_goodput
from distributed_training_pytorch_tpu.telemetry import mfu as jax_mfu
from distributed_training_pytorch_tpu_torch.profiling import categorize, report
from distributed_training_pytorch_tpu_torch.telemetry import anomaly, doctor, events, exporter, goodput, mfu
from distributed_training_pytorch_tpu_torch.telemetry import provenance, straggler


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


TICKS = [("compile", 2.5), ("data_wait", 0.125), ("productive_step", 1.75), ("checkpoint", 0.3),
         ("restart_rollback", 0.05), ("productive_step", 3.0), ("other", 0.2)]


def _drive(module, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(module.time, "perf_counter", clock)
    meter = module.GoodputMeter()
    meter.start()
    for bucket, dt in TICKS:
        clock.t += dt
        meter.tick(bucket)
    meter.account("checkpoint_async", 0.7)
    clock.t += 1.0
    meter.stop("other")
    return meter


def test_goodput_matches_jax_on_one_tick_sequence(monkeypatch):
    port, ref = _drive(goodput, monkeypatch), _drive(jax_goodput, monkeypatch)
    assert goodput.BUCKETS == jax_goodput.BUCKETS
    assert port.to_state() == ref.to_state()
    assert port.fractions() == ref.fractions() and port.goodput == ref.goodput
    assert abs(sum(port.fractions().values()) - 1.0) < 1e-12
    restored = goodput.GoodputMeter(json.loads(json.dumps(port.to_state())))
    assert restored.to_state() == port.to_state()  # JSON round-trips floats exactly
    with pytest.raises(KeyError):
        port.tick("bogus")


def _stream(module):
    det = module.AnomalyDetector(warmup=3)
    found = []
    rng = np.random.RandomState(0)
    for step in range(40):
        loss = 2.0 + 0.05 * rng.randn() + (9.0 if step == 20 else 0.0)
        grad = 1.0 + 0.1 * rng.randn() + (50.0 if step == 25 else 0.0)
        step_time = 0.1 + (0.5 if step == 30 else 0.0)
        live = 1e9 * (1.0 + (1.0 if step >= 35 else 0.0))
        ratio = 1.05 + (1.0 if step == 33 else 0.0)
        if step == 15:
            loss = float("nan")
        found += module.AnomalyDetector.observe(det, step, loss=loss, grad_norm=grad, step_time=step_time,
                                                live_bytes=live, straggler_ratio=ratio)
    return [(a.kind, a.step, repr(a.value), repr(a.baseline), a.factor) for a in found], det.total_fired


def test_anomaly_matches_jax_on_one_stream():
    got, ref = _stream(anomaly), _stream(jax_anomaly)
    assert got == ref
    kinds = {k for k, *_ in got[0]}
    assert kinds == {"loss_spike", "grad_explosion", "step_time_regression", "memory_growth", "straggler"}
    with pytest.raises(ValueError):
        anomaly.AnomalyDetector(action="shout")


def _events_for(kind):
    base = [
        {"event": "run_start", "epoch": 0, "_line": 1},
        {"event": "compile", "kind": "mfu_probe", "epoch": 1, "_line": 2},
        {"event": "window", "straggler_ratio": 1.1, "slowest_chip": 1, "_line": 3},
    ]
    seconds = {b: 0.0 for b in jax_goodput.BUCKETS}
    seconds.update(productive_step=10.0, compile=4.0, other=1.0)
    if kind == "data_bound":
        seconds["data_wait"] = 5.0
    if kind == "checkpoint_stall":
        seconds["checkpoint"] = 6.0
    if kind == "compile_bound":
        base.append({"event": "compile", "epoch": 2, "executables": 1, "_line": 4})
    if kind == "straggler":
        base += [{"event": "anomaly", "kind": "straggler", "value": 2.0, "_line": 5},
                 {"event": "hung_step", "timeout_s": 3.0, "_line": 6},
                 {"event": "window", "straggler_ratio": 2.2, "slowest_chip": 3, "_line": 7}]
    if kind == "comm_heavy":
        base.append({"event": "profile_capture", "categories": {"collective": 0.4, "matmul": 0.5}, "_line": 8})
    base.append({"event": "epoch_end", "goodput_seconds": seconds, "_line": 9})
    return base


@pytest.mark.parametrize("kind", ["healthy", "data_bound", "checkpoint_stall", "compile_bound", "straggler",
                                  "comm_heavy"])
def test_doctor_matches_jax_on_one_event_list(kind):
    evs = _events_for(kind)
    got, ref = doctor.diagnose(evs), jax_doctor.diagnose(evs)
    assert got.to_dict() == ref.to_dict()
    assert got.verdict == kind
    assert doctor.scalar_fields(doctor.extract_signals(evs)) == jax_doctor.scalar_fields(jax_doctor.extract_signals(evs))
    assert doctor.VERDICTS == jax_doctor.VERDICTS and doctor.THRESHOLDS == jax_doctor.THRESHOLDS


def test_window_report_and_the_peak_table():
    for steps, secs, flops in ((4, 0.5, 4e13), (1, 0.01, None), (0, 2.0, 1e9)):
        assert mfu.window_report(steps, secs, flops_per_step=flops, peak_flops=989.4e12) == jax_mfu.window_report(
            steps, secs, flops_per_step=flops, peak_flops=989.4e12)
    assert mfu.mfu_value(4e16, 0.14, 989.4e12) == jax_mfu.mfu_value(4e16, 0.14, 989.4e12)
    assert mfu.device_peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert mfu.device_peak_flops("NVIDIA H100 PCIe") == 756e12
    assert mfu.device_peak_flops("NVIDIA A10G") is None  # an unknown card: no MFU, not a guess
    assert mfu.device_peak_flops(torch.device("cpu")) == 1e12 == jax_mfu.PEAK_FLOPS["cpu"]
    assert "mfu" not in mfu.window_report(4, 1.0, flops_per_step=1e12, peak_flops=None)


SNAPSHOT = {"run_dir": "/runs/a", "phase": "training", "epoch": 2, "step_ms": 141.5, "mfu": 0.3,
            "goodput_fractions": {"productive_step": 0.9, "compile": 0.1}, "anomaly_counts": {"loss_spike": 1},
            "doctor_scores": {"data_bound": 0.2, "healthy": 1.0}, "verdict": "healthy", "loss": float("nan"),
            "nested": [1, 2], "ok": True}


def _get(port, route):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=10) as r:
        return r.status, r.read().decode()


def test_prometheus_and_status_exporter_match_jax():
    assert exporter.prometheus_text(SNAPSHOT) == jax_exporter.prometheus_text(SNAPSHOT)
    with exporter.StatusExporter(lambda: SNAPSHOT, 0, host="127.0.0.1") as ours, \
            jax_exporter.StatusExporter(lambda: SNAPSHOT, 0, host="127.0.0.1") as theirs:
        for route in ("/status", "/metrics", "/"):
            assert _get(ours.port, route) == _get(theirs.port, route)
        with pytest.raises(urllib.error.HTTPError):
            _get(ours.port, "/nope")
        taken = []
        blocked = exporter.StatusExporter(lambda: {}, ours.port, host="127.0.0.1", log=taken.append)
        assert not blocked.enabled and "could not bind" in taken[0]


def test_event_readers_match_jax(tmp_path):
    path = str(tmp_path / "telemetry" / "events.jsonl")
    log = events.EventLog(path, process_index=0)
    log.emit("run_start", epoch=0, loss=float("nan"), arr=np.float32(1.5), t=torch.tensor(2.0))
    log.emit("window", steps=3)
    log.close()
    assert events.EventLog(path, process_index=1).emit("x") is None  # rank 0 writes
    with open(path, "a") as f:
        f.write("not json\n\n" + '{"event": "heartbeat", "t": 1}')  # a torn tail without its newline
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert events.load_run_events(str(tmp_path)) == jax_events.load_run_events(str(tmp_path))
        ours, theirs = events.EventFollower(path), jax_events.EventFollower(path)
        assert ours.poll() == theirs.poll()
        assert list(events.read_events(path, strict=False, with_lineno=True)) == list(
            jax_events.read_events(path, strict=False, with_lineno=True))
    recs = events.load_run_events(str(tmp_path))
    assert [r["event"] for r in recs] == ["run_start", "window", "heartbeat"]
    assert recs[0]["loss"] == "nan" and recs[0]["schema"] == jax_events.SCHEMA_VERSION
    with pytest.raises(ValueError, match="malformed"):
        list(events.read_events(path))
    with pytest.raises(FileNotFoundError):
        events.load_run_events(str(tmp_path / "nowhere"))


KERNEL_NAMES = [
    ("void flash_fwd_wgmma_kernel<64>(FlashParams)", "matmul"),
    ("void flash_bwd_dq_wgmma_kernel<64>(BwdParams)", "matmul"),
    ("void flash_bwd_dkv_kernel<32>(BwdParams)", "matmul"),
    ("void conv1x1_bn_act_wgmma_kernel<2>(Conv1x1Params)", "matmul"),
    ("void conv1x1_bwd_dz_kernel<__nv_bfloat16>(DzParams)", "fusion(elementwise)"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_warpgroupsize1x1x1",
     "convolution"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x256x64", "convolution"),
    ("sm90_xmma_wgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x128x64", "convolution"),
    ("nvjet_tst_192x192_64x4_1x2_h_bz_coopA_NNT", "matmul"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1_execute_segment_k_off_kernel",
     "matmul"),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_16x16_128x2_tn_align8>(Params)",
     "matmul"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*, unsigned long, ncclWork*)", "collective"),
    ("Memcpy HtoD (Pinned -> Device)", "infeed"),
    ("Memcpy DtoD (Device -> Device)", "copy/transpose"),
    ("Memset (Device)", "copy/transpose"),
    ("void at::native::(anonymous namespace)::max_pool_forward_nhwc<c10::BFloat16>(int, int)", "pool-forward"),
    ("void at::native::(anonymous namespace)::max_pool_backward_nhwc<float>(int, int)", "pool-backward"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
     "at::detail::Array<char*, 3> >(int, at::native::CUDAFunctor_add<float>, at::detail::Array<char*, 3>)",
     "fusion(elementwise)"),
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<at::native::direct_copy_kernel_"
     "cuda(at::TensorIteratorBase&)::{lambda()#3}>(int)", "fusion(elementwise)"),
    ("void at::native::multi_tensor_apply_kernel<at::native::(anonymous namespace)::FusedAdamMathFunctor<float, 4, "
     "(at::native::ADAM_MODE)1, false>>(x)", "fusion(elementwise)"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::MeanOps<float, float>, "
     "unsigned int, float, 4> >(x)", "reduce(stats)"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<c10::BFloat16, float>(int, float)",
     "reduce(stats)"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float, float, float>(float*)",
     "reduce(stats)"),
    ("void cudnn::bn_fw_tr_1C11_kernel_NCHW<__nv_bfloat16, float, 512, true, 1>(x)", "reduce(stats)"),
    ("void at::native::batch_norm_collect_statistics_kernel<at::native::InvStd, float, float, float, int>(x)",
     "reduce(stats)"),
    ("void at::native::transpose_kernel<float>(x)", "copy/transpose"),
    ("void at::native::(anonymous namespace)::indexSelectLargeIndex<float, long, unsigned int, 2, 2, -2, true>(x)",
     "other"),
]


@pytest.mark.parametrize("name,want", KERNEL_NAMES)
def test_categorize_cuda_kernel_names(name, want):
    assert categorize(name) == want


@pytest.mark.parametrize("name", ["dot.3", "%all-reduce.1", "reduce-window.2", "select-and-scatter.1", "fusion.7",
                                  "reduce.4", "convolution.1", "custom-call.2", "infeed.1", "transpose.1", "add.2",
                                  "%copy.3 = f32[2] copy(%convolution.2)"])
def test_categorize_hlo_names_as_jax(name):
    from distributed_training_pytorch_tpu.profiling.categories import categorize as jax_categorize

    assert categorize(name) == jax_categorize(name)


# One synthetic set of device intervals (us): two streams that overlap, gaps between.
INTERVALS = [("dot.1", 0, 40, 7), ("fusion.2", 45, 10, 7), ("all-reduce.3", 50, 20, 13), ("copy.4", 90, 5, 7),
             ("dot.1", 100, 40, 7), ("reduce.5", 150, 10, 13), ("convolution.6", 170, 30, 7)]


def test_analyze_trace_matches_jax_on_xspace_and_kineto(tmp_path):
    lines = {}
    for name, start, dur, stream in INTERVALS:
        lines.setdefault(stream, []).append((name, start * 10**6, dur * 10**6))
    space = xplane.encode_xspace([{"name": "/device:GPU:0", "lines": [
        {"name": f"Stream #{s}", "timestamp_ns": 0, "events": evs} for s, evs in sorted(lines.items())]}])
    xdir = tmp_path / "x" / "plugins" / "profile" / "run"
    xdir.mkdir(parents=True)
    (xdir / "host.xplane.pb").write_bytes(space)
    kineto = {"traceEvents": [{"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": stream, "ts": start,
                               "dur": dur, "args": {"device": 0, "stream": stream}}
                              for name, start, dur, stream in INTERVALS]
              + [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1, "ts": 0, "dur": 500}]}
    kdir = tmp_path / "k"
    kdir.mkdir()
    (kdir / "host_1.1.pt.trace.json").write_text(json.dumps(kineto))
    ref = jax_report.analyze_trace(str(tmp_path / "x"), steps=2, top_k=5).to_dict()
    got = report.analyze_trace(str(kdir), steps=2, top_k=5).to_dict()
    assert set(got) == set(jax_report.REPORT_FIELDS) == set(report.REPORT_FIELDS)
    for key in jax_report.REPORT_FIELDS:
        if key != "trace_path":
            assert got[key] == ref[key], key
    assert got["source"] == "device" and abs(sum(got["categories"].values()) - 1.0) < 1e-3
    prof = report.analyze_events([(n, s, d) for n, s, d, _ in INTERVALS])
    assert abs(sum(prof.categories.values()) - 1.0) < 1e-12
    assert prof.busy_us == 150.0 and prof.span_us == 200.0  # the union: 0-40, 45-70, 90-95, 100-140, 150-160, 170-200


def test_metrics_writer_reads_back_as_the_jax_writer_writes(tmp_path, monkeypatch):
    pytest.importorskip("tensorboardX")
    # TensorBoard's reader without TensorFlow (its own stub; importing TensorFlow takes
    # seconds and reads nothing differently).
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from distributed_training_pytorch_tpu.utils.tensorboard import MetricsWriter as JaxWriter
    from distributed_training_pytorch_tpu_torch.utils.tensorboard import MetricsWriter, crc32c

    assert crc32c(b"123456789") == 0xE3069283
    calls = [(1, {"loss": 2.5, "acc": np.float32(0.125), "bad": float("nan"), "vec": np.ones(3)}, "train"),
             (2, {"loss": torch.tensor(2.25), "step_ms": 141.25}, "train"), (2, {"mfu": 0.3125}, "telemetry")]
    for cls, sub in ((MetricsWriter, "port"), (JaxWriter, "jax")):
        w = cls(str(tmp_path / sub))
        for step, metrics, prefix in calls:
            w.write(step, {k: (v.numpy() if sub == "jax" and torch.is_tensor(v) else v) for k, v in metrics.items()},
                    prefix=prefix)
        w.close()

    def scalars(sub):
        acc = EventAccumulator(str(tmp_path / sub))
        acc.Reload()
        return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in sorted(acc.Tags()["scalars"])}

    got = scalars("port")
    assert got == scalars("jax")
    assert got["train/loss"] == [(1, 2.5), (2, 2.25)] and "train/bad" not in got


def test_straggler_fields_and_provenance():
    assert straggler.arrival_fields([10.0]) == {} and straggler.arrival_fields([5.0, 0.0]) == {}
    f = straggler.arrival_fields([100.0, 160.0, 120.0])
    assert f == {"chip_wall_ms_min": 100.0, "chip_wall_ms_max": 160.0, "chip_skew_ms": 60.0, "slowest_chip": 1,
                 "chips_sampled": 3}
    from distributed_training_pytorch_tpu.telemetry import straggler as jax_straggler

    assert straggler.FIELDS == jax_straggler.FIELDS
    assert straggler.ratio(60.0, 120.0) == jax_straggler.ratio(60.0, 120.0) == 1.5
    rec = provenance.provenance_fields(mesh={"data": 1}, dtype="bfloat16", chain_steps=4, batch=64)
    assert rec["torch"] == torch.__version__ and rec["git_sha"] and rec["chain_steps"] == 4
    assert all(not isinstance(v, float) or math.isfinite(v) for v in rec.values())
    if torch.version.cuda is None:
        assert "cuda" not in rec
    assert rec == provenance.provenance_fields(mesh={"data": 1}, dtype="bfloat16", chain_steps=4, batch=64)
