"""Import hygiene of the PyTorch/CUDA port: it imports neither JAX nor any module of the
JAX package ``distributed_training_pytorch_tpu`` (whose name is a prefix of the port's,
so module names are matched exactly or by ``name + "."``), and importing it initialises
no CUDA context and builds nothing (neither the kernels nor the native data runtime).
``chip_smoke.py`` and every ``scripts/torch_*.py`` (the profiles, the chaos soak, the
readers, the perf gate, the memory probe, the fleet controller) run where the card is,
beside the port, and are held to the same rule; each reader script and the soaks also run
there in a process that imports them (``--help``)."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "distributed_training_pytorch_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "distributed_training_pytorch_tpu")
# Every module of the port, by slice; each must import in the probe below.
PORT_MODULES = [
    # LM serving
    "models.convert", "models.transformer_lm", "ops.dispatch", "ops.flash_attention", "ops._build",
    "serving.batcher", "serving.client", "serving.engine", "serving.server", "telemetry.events",
    "telemetry.exporter",
    # LM training
    "ops.losses", "ops.schedules", "precision.policy", "train.state", "train.engine", "data.dataset",
    "data.loader", "data.transforms", "parallel.mesh", "checkpoint.manager", "utils.logger",
    "trainer.trainer", "examples.train_lm",
    # ResNet-50 training
    "ops.conv1x1", "ops.metrics", "models.resnet", "models.wrappers", "examples.train_imagenet",
    # GPT-2-small training over a seq axis with ring attention
    "parallel.ring_attention",
    # VGG16 on CIFAR-10 with the host data path
    "data.native", "data.prefetch", "models.vgg", "examples.train_cifar10",
    # the image-folder entry
    "examples.example_trainer", "examples.main", "examples.eval",
    # real data: the digits corpus, record files, fp16 with dynamic loss scaling
    "data.png", "data.records", "precision.loss_scale", "examples.digits_data", "examples.train_digits",
    "examples.train_records",
    # LM generation and offline LM evaluation
    "examples.eval_lm", "examples.make_lm_corpus",
    # observability: telemetry, live memory, profiling, FLOPs, TensorBoard scalars
    "telemetry.anomaly", "telemetry.doctor", "telemetry.goodput", "telemetry.mfu", "telemetry.provenance",
    "telemetry.stats", "telemetry.straggler", "memory.live", "profiling.capture", "profiling.categories",
    "profiling.report", "profiling.trace", "utils.flops", "utils.tensorboard",
    # the memory preflight and observability's readers
    "memory.analysis", "memory.preflight", "profiling.diff", "profiling.gate", "telemetry.timeline",
    "telemetry.monitor", "telemetry.history",
    # pipeline parallelism over the pipe axis, Ulysses attention (in parallel.ring_attention)
    "parallel.pipeline", "models.pipelined_lm",
    # the fleet controller (its mechanism is scripts/torch_fleet_controller.py)
    "telemetry.controller",
]
# The card's machine has neither OpenCV nor PIL, nor scikit-learn: the port decodes and
# transforms images without them, and ships the digits corpus as an array of its own.
IMAGE_LIBRARIES = ("cv2", "PIL", "sklearn")

_PROBE = f"""
import importlib, json, pkgutil, sys
import {PORT}
for info in pkgutil.walk_packages({PORT}.__path__, prefix="{PORT}."):
    importlib.import_module(info.name)
import chip_smoke  # its module-level imports
import torch
from {PORT}.data import native
from {PORT}.ops import _build
print(json.dumps({{
    "modules": sorted(sys.modules),
    "cuda_initialized": torch.cuda.is_initialized(),
    "kernels_loaded": _build._lib is not None,
    "native_loaded": native._lib is not None or native._error is not None,
}}))
"""


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_the_port_pulls_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300, check=True,
    )
    import json

    probe = json.loads(out.stdout.strip().splitlines()[-1])
    assert [m for m in probe["modules"] if _forbidden(m)] == []
    assert [m for m in probe["modules"] if m.split(".")[0] in IMAGE_LIBRARIES] == []
    assert [m for m in PORT_MODULES if f"{PORT}.{m}" not in probe["modules"]] == []
    assert probe["cuda_initialized"] is False
    assert probe["kernels_loaded"] is False
    assert probe["native_loaded"] is False


def _sources():
    for root, _, files in os.walk(os.path.join(REPO, PORT)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    scripts = os.path.join(REPO, "scripts")
    for f in sorted(os.listdir(scripts)):
        if f.startswith("torch_") and f.endswith(".py"):
            yield os.path.join(scripts, f)


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_no_source_of_the_port_imports_an_image_library():
    offenders = [f"{os.path.relpath(path, REPO)}:{line} {name}" for path in _sources()
                 for line, name in _imports(path) if name.split(".")[0] in IMAGE_LIBRARIES]
    assert offenders == []


def test_no_source_of_the_port_imports_jax():
    offenders = []
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert offenders == []


READER_SCRIPTS = ("torch_run_doctor.py", "torch_run_monitor.py", "torch_run_compare.py", "torch_bench_history.py",
                  "torch_perf_gate.py", "torch_memory_probe.py", "torch_chaos_soak.py", "torch_fleet_controller.py")

_SCRIPT_PROBE = """
import json, runpy, sys
for path in sys.argv[1:]:
    sys.argv = [path, "--help"]
    try:
        runpy.run_path(path, run_name="__main__")
    except SystemExit:
        pass
print(json.dumps(sorted(sys.modules)))
"""


def test_the_reader_scripts_import_no_jax():
    import json

    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _SCRIPT_PROBE, *(os.path.join(REPO, "scripts", n) for n in READER_SCRIPTS)],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300, check=True)
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    assert [m for m in modules if _forbidden(m) or m.split(".")[0] in IMAGE_LIBRARIES] == []
    assert all(f"usage: {n}" in out.stdout for n in READER_SCRIPTS)
