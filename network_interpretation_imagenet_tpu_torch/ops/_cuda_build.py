"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/<name>.cu`` is one shared library with a plain C interface,
compiled on its own by ``nvcc`` for ``sm_90a`` into
``network_interpretation_imagenet_tpu_torch/_build/<name>-<hash>.so``. The
hash covers the source, every ``csrc/*.cuh`` and the flags, so a stale
library is never loaded. :func:`build` starts one ``nvcc`` per stale source,
all at once, and waits for them. Nothing here runs at import time.

Binding rules (every wrapper follows them): pointers and the stream are
``ctypes.c_void_p``, sizes ``ctypes.c_int``, and each C entry returns
``cudaGetLastError()`` after its launches, which the wrapper turns into an
exception.
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
from typing import Dict, Iterable, Optional, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
    """Kernel names: the stems of ``csrc/*.cu``."""
    return sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(CSRC_DIR, "*.cu"))
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                           "CUDA toolkit is installed")
    return path


def so_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC_DIR, name + ".cu")] + sorted(
        glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    ):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every stale kernel library in parallel; returns the seconds
    each compile took (0.0 where the library was already built). Writes
    ``nvcc``'s register/shared-memory report to ``_build/<name>.log``."""
    names = list(sources() if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    seconds = {name: 0.0 for name in names}
    failed = []
    procs = {}
    try:
        for name in names:
            out = so_path(name)
            if os.path.isfile(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
            with open(os.path.join(BUILD_DIR, name + ".log"), "w") as log:
                proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
            procs[name] = (proc, tmp, out, time.perf_counter())
        for name, (proc, tmp, out, t0) in procs.items():
            rc = proc.wait()
            seconds[name] = time.perf_counter() - t0
            if rc == 0:
                os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
            else:
                failed.append(name)
    finally:
        for proc, *_ in procs.values():
            if proc.poll() is None:  # an exception left a compile running
                proc.kill()
                proc.wait()
    if failed:
        details = []
        for name in failed:
            with open(os.path.join(BUILD_DIR, name + ".log")) as f:
                details.append(f"--- {name}.cu ---\n{f.read()[-4000:]}")
        raise RuntimeError("nvcc failed:\n" + "\n".join(details))
    return seconds


def library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.
    ``signatures`` maps each C entry to its ``argtypes``; every entry
    returns an int (a ``cudaError_t``)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError(f"the {name} kernel needs a CUDA device")
            path = so_path(name)
            if not os.path.isfile(path):
                build([name])
            lib = ctypes.CDLL(path)
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
