"""Run provenance: what produced a number.

Counterpart of ``distributed_training_pytorch_tpu/telemetry/provenance.py``, stamped on
the trainer's ``run_start`` record. The environment's identity is the port's: the git SHA,
the torch and CUDA versions, the ``nvcc`` release the kernels were built with, and the
card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them (a card set below its maximum power runs slower under
load). A field the machine cannot give (no ``nvcc``, no ``nvidia-smi``, not a checkout)
is left out, never guessed. The program's identity is the caller's: mesh, compute dtype,
chain length and global batch.

:data:`COMPARE_KEYS` are the configuration keys on which two records must agree to
measure one program on one kind of card (:func:`differing_keys`); ``git_sha`` is not one:
differing code is what a comparison compares.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess

__all__ = ["COMPARE_KEYS", "differing_keys", "provenance_fields"]

COMPARE_KEYS = ("torch", "cuda", "nvcc", "card", "power_limit", "mesh", "dtype", "chain_steps", "batch")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CACHE: dict = {}


def _run(cmd, timeout: float = 20.0) -> "str | None":
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip() or None


def _environment() -> dict:
    """The machine's fields, read once a process."""
    if _CACHE:
        return dict(_CACHE)
    import torch

    env = {"git_sha": _run(["git", "-C", _REPO_ROOT, "rev-parse", "--short", "HEAD"]) or "unknown",
           "torch": torch.__version__}
    if torch.version.cuda:
        env["cuda"] = torch.version.cuda
    nvcc = shutil.which("nvcc") or ("/usr/local/cuda/bin/nvcc" if os.path.exists("/usr/local/cuda/bin/nvcc") else None)
    if nvcc:
        found = re.search(r"release ([\d.]+)", _run([nvcc, "--version"]) or "")
        if found:
            env["nvcc"] = found.group(1)
    if shutil.which("nvidia-smi"):
        line = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
        if line:
            name, _, limit = line.splitlines()[0].partition(",")
            env["card"] = name.strip()
            env["power_limit"] = limit.strip()
    _CACHE.update(env)
    return dict(env)


def provenance_fields(*, mesh=None, dtype: "str | None" = None, chain_steps: "int | None" = None,
                      batch: "int | None" = None) -> dict:
    """The provenance record: the machine's fields and the caller's program identity."""
    out = _environment()
    out.update(mesh=mesh if mesh is None or isinstance(mesh, (str, dict)) else str(mesh), dtype=dtype,
               chain_steps=chain_steps, batch=batch)
    return out


def differing_keys(a: "dict | None", b: "dict | None") -> "list[str]":
    """The :data:`COMPARE_KEYS` on which two provenance records disagree (empty: they are
    comparable). A key absent or None on either side never disagrees, and a record
    without provenance compares with anything."""
    if not a or not b:
        return []
    out = []
    for key in COMPARE_KEYS:
        va, vb = a.get(key), b.get(key)
        if va is None or vb is None:
            continue
        if va != vb:
            out.append(key)
    return out
