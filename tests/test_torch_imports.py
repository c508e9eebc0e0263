"""Import hygiene of the PyTorch/CUDA port: it imports neither JAX nor any module of the
JAX package ``distributed_training_pytorch_tpu`` (whose name is a prefix of the port's,
so module names are matched exactly or by ``name + "."``), and importing it initialises
no CUDA context and builds nothing. ``chip_smoke.py``, ``scripts/torch_serve_profile.py``,
``scripts/torch_train_profile.py`` and ``scripts/torch_resnet_profile.py`` run where the
card is, beside the port, and are held to the same rule."""

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
]

_PROBE = f"""
import importlib, json, pkgutil, sys
import {PORT}
for info in pkgutil.walk_packages({PORT}.__path__, prefix="{PORT}."):
    importlib.import_module(info.name)
import chip_smoke  # its module-level imports
import torch
from {PORT}.ops import _build
print(json.dumps({{
    "modules": sorted(sys.modules),
    "cuda_initialized": torch.cuda.is_initialized(),
    "kernels_loaded": _build._lib is not None,
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
    assert [m for m in PORT_MODULES if f"{PORT}.{m}" not in probe["modules"]] == []
    assert probe["cuda_initialized"] is False
    assert probe["kernels_loaded"] is False


def _sources():
    for root, _, files in os.walk(os.path.join(REPO, PORT)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "scripts", "torch_serve_profile.py")
    yield os.path.join(REPO, "scripts", "torch_train_profile.py")
    yield os.path.join(REPO, "scripts", "torch_resnet_profile.py")


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
