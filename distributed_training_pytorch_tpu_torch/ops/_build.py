"""Build the package's CUDA kernels with ``nvcc`` at first use and load them with ``ctypes``.

Every source under ``csrc/`` compiles to an object of its own (one ``nvcc`` each, all
started together), and the objects link into one shared library with a plain C interface,
``build/torch_kernels/libdtp_torch_kernels.so`` under the checkout root. The ``build/``
rule of the repository's ``.gitignore`` covers that directory, so nothing built is ever
committed. The library is rebuilt when any source is newer than it.

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

__all__ = ["SOURCES", "LIBRARY", "library", "build_log"]

_PKG = Path(__file__).resolve().parents[1]
SOURCES = sorted((_PKG / "csrc").glob("*.cu"))
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
    return any(src.stat().st_mtime > built for src in SOURCES)


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
            lib.dtp_flash_fwd.argtypes = _FLASH_FWD_ARGTYPES
            lib.dtp_flash_fwd.restype = ctypes.c_int
            lib.dtp_flash_fwd_smem_bytes.argtypes = [ctypes.c_int]
            lib.dtp_flash_fwd_smem_bytes.restype = ctypes.c_int
            _lib = lib
        return _lib
