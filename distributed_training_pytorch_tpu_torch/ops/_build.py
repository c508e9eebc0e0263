"""Build the package's CUDA kernels with ``nvcc`` at first use and load them with ``ctypes``.

Every source under ``csrc/`` compiles to an object of its own (one ``nvcc`` each, all
started together; ``*.cuh`` headers are shared by them), and the objects link into one shared library with a plain C interface,
``build/torch_kernels/libdtp_torch_kernels.so`` under the checkout root. The ``build/``
rule of the repository's ``.gitignore`` covers that directory, so nothing built is ever
committed. The library is rebuilt when any source or header is newer than it.

Nothing here runs at import: the CPU tests import every module, and this machine may have
no ``nvcc`` at all. ``build_log`` keeps the ``-Xptxas -v`` report (registers, shared memory
and spills of each kernel) of the last build in this process.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["ARGTYPES", "SOURCES", "LIBRARY", "library", "build_log"]

_PKG = Path(__file__).resolve().parents[1]
SOURCES = sorted((_PKG / "csrc").glob("*.cu"))
HEADERS = sorted((_PKG / "csrc").glob("*.cuh"))
LIBRARY = _PKG.parent / "build" / "torch_kernels" / "libdtp_torch_kernels.so"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None
build_log = ""

_c = ctypes
_FLASH_FWD_ARGTYPES = (
    [_c.c_void_p] * 5  # q, k, v, o, lse
    + [_c.c_int] * 6  # dtype, B, H, Tq, seq_len, D
    + [_c.c_longlong] * 12  # (b, t, h) element strides of q, k, v, o
    + [_c.c_int, _c.c_float, _c.c_void_p]  # causal, scale, stream
)
_BWD_SIZES = [_c.c_int] * 7  # dtype, B, H, Tq, Tk, seq_len, D
_FLASH_BWD_DQ_ARGTYPES = (
    [_c.c_void_p] * 7  # q, k, v, dO, lse, delta, dq
    + _BWD_SIZES
    + [_c.c_longlong] * 15  # (b, t, h) element strides of q, k, v, dO, dq
    + [_c.c_int, _c.c_float, _c.c_void_p]  # causal, scale, stream
)
_FLASH_BWD_DKV_ARGTYPES = (
    [_c.c_void_p] * 8  # q, k, v, dO, lse, delta, dk, dv
    + _BWD_SIZES
    + [_c.c_longlong] * 18  # (b, t, h) element strides of q, k, v, dO, dk, dv
    + [_c.c_int, _c.c_float, _c.c_void_p]  # causal, scale, stream
)
_CONV1X1_ARGTYPES = (
    [_c.c_void_p] * 5  # x, w, scale, bias, out
    + [_c.c_int] * 7  # in dtype, out dtype, N, H, W, Cin, Cout
    + [_c.c_longlong] * 3  # (b, h, w) element strides of x
    + [_c.c_int, _c.c_void_p]  # act, stream
)
_CONV1X1_WGMMA_ARGTYPES = (
    [_c.c_void_p] * 5  # x, w, scale, bias, out
    + [_c.c_int] * 4  # Cin, Cout, rows_w, rows_bh
    + [_c.c_longlong] * 2  # stride_w, stride_bh (elements)
    + [_c.c_int] * 3  # box_w, box_bh, act
    + [_c.c_void_p]  # stream
)
_CONV1X1_BWD_DZ_ARGTYPES = (
    [_c.c_void_p] * 4  # g, y, scale, dz
    + [_c.c_int] * 2  # g dtype, dz dtype
    + [_c.c_longlong, _c.c_int, _c.c_int, _c.c_void_p]  # rows, Cout, act, stream
)
# The argument types of every ``extern "C"`` function of ``csrc/*.cu``; all return int.
# ctypes converts by these alone, so a count or type that differs from the C signature is
# a silent fault on the card: ``tests/test_torch_flash_backward.py`` holds them against
# the sources.
ARGTYPES = {
    "dtp_flash_fwd": _FLASH_FWD_ARGTYPES,
    "dtp_flash_fwd_wgmma": _FLASH_FWD_ARGTYPES,
    "dtp_flash_bwd_dq": _FLASH_BWD_DQ_ARGTYPES,
    "dtp_flash_bwd_dkv": _FLASH_BWD_DKV_ARGTYPES,
    "dtp_flash_bwd_dq_wgmma": _FLASH_BWD_DQ_ARGTYPES,
    "dtp_flash_bwd_dkv_wgmma": _FLASH_BWD_DKV_ARGTYPES,
    "dtp_conv1x1_bn_act": _CONV1X1_ARGTYPES,
    "dtp_conv1x1_bn_act_wgmma": _CONV1X1_WGMMA_ARGTYPES,
    "dtp_conv1x1_bn_act_wgmma_smem_bytes": [_c.c_int, _c.c_int],  # Cin, Cout
    "dtp_conv1x1_bwd_dz": _CONV1X1_BWD_DZ_ARGTYPES,
    **{
        f"dtp_flash_{kernel}_smem_bytes": [_c.c_int]  # head dim D
        for kernel in ("fwd", "bwd_dq", "bwd_dkv", "fwd_wgmma", "bwd_dq_wgmma", "bwd_dkv_wgmma")
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _stale() -> bool:
    if not LIBRARY.exists():
        return True
    built = LIBRARY.stat().st_mtime
    return any(src.stat().st_mtime > built for src in SOURCES + HEADERS)


def _build() -> str:
    nvcc = _nvcc()
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=LIBRARY.parent) as tmp:
        objects = [Path(tmp) / (src.stem + ".o") for src in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(SOURCES, objects, strict=True)
        ]
        logs = []
        failed = []
        for src, proc in zip(SOURCES, procs, strict=True):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / LIBRARY.name
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objects), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, LIBRARY)  # atomic: a concurrent loader sees old or new, whole
    return "\n".join(logs)


def library(*, rebuild: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built first when it is missing or stale, or when
    ``rebuild`` asks for a build from the sources before the first load."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            if rebuild or _stale():
                build_log = _build()
            lib = ctypes.CDLL(str(LIBRARY))
            for name, argtypes in ARGTYPES.items():
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
            _lib = lib
        return _lib
