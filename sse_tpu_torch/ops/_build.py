"""Build and load the port's CUDA kernels.

Every ``sse_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ONE shared library with a plain C interface, which is
loaded with ``ctypes`` — no PyTorch headers, so a build takes seconds.
The build happens on the first CUDA launch, never at import, and is
cached in ``build/sse_tpu_torch/`` under a hash of the sources and flags.
A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "sse_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds the last build took (0.0 when it was cached) and nvcc's output
build_info = {"seconds": None, "log": ""}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built"
    )


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        out = os.path.join(BUILD_DIR, f"libsse_kernels_{_digest()}.so")
        if os.path.exists(out):
            build_info["seconds"] = 0.0
        else:
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, capture_output=True, text=True)
            build_info["seconds"] = time.perf_counter() - t0
            build_info["log"] = r.stdout + r.stderr
            if r.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n{r.stderr}"
                )
            os.replace(tmp, out)
        _lib = ctypes.CDLL(out)
        return _lib


def launch(name: str, argtypes, device: torch.device, *args) -> None:
    """Call the library's C entry point ``name`` with ``args`` and, as its
    last argument, ``device``'s current stream; raise if it returns a
    CUDA error (a refused launch never runs, so this is the only place it
    shows)."""
    fn = getattr(library(), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    with torch.cuda.device(device):
        status = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    _check(status, name)


def _check(status: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if status != 0:
        lib = library()
        lib.sse_error_string.restype = ctypes.c_char_p
        lib.sse_error_string.argtypes = [ctypes.c_int]
        msg = lib.sse_error_string(status).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {status}: {msg}")
