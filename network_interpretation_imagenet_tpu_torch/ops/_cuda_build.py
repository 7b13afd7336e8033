"""Build the port's native code at first use and load it with ctypes.

Every library has a plain C interface and is compiled on its own: each
``csrc/<name>.cu`` (a CUDA kernel) by ``nvcc`` for ``sm_90a``, each
``native/<name>.cc`` (host code: the Felzenszwalb segmenter) by ``g++``.
It lands in ``network_interpretation_imagenet_tpu_torch/_build/<name>-<hash>.so``,
the hash covering the source, its headers (every ``csrc/*.cuh``, or every
``native/*.h``) and the flags, so a stale library is never loaded. A
compile writes a per-process temp file and renames it into place, so a
concurrent loader never sees half a file. :func:`build` starts one
compiler per stale library, all at once, and waits for them. Nothing here
runs at import time.

Binding rules (every wrapper follows them): pointers and the stream are
``ctypes.c_void_p``, sizes ``ctypes.c_int``, and every C entry returns an
int. A CUDA entry returns ``cudaGetLastError()`` after its launches, which
the wrapper turns into an exception (:func:`check`).
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
NATIVE_DIR = os.path.join(PKG_DIR, "native")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# No -march=native: _build/ may be copied to another machine with the
# checkout, and a library tuned to one CPU can fault on another. No
# contraction: a fused multiply-add would round the segmenter's smoothing
# and edge weights otherwise than scipy and numpy do.
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-ffp-contract=off")
CXX_TIMEOUT_S = 300.0

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


def _source(name: str):
    """(source, headers, flags, is CUDA) of library ``name``: ``csrc/<name>.cu``
    where it exists (or where no ``native/<name>.cc`` does), else the latter."""
    cu, cc = os.path.join(CSRC_DIR, name + ".cu"), os.path.join(NATIVE_DIR, name + ".cc")
    if os.path.isfile(cu) or not os.path.isfile(cc):
        return cu, sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))), NVCC_FLAGS, True
    return cc, sorted(glob.glob(os.path.join(NATIVE_DIR, "*.h"))), CXX_FLAGS, False


def so_path(name: str) -> str:
    source, headers, flags, _ = _source(name)
    h = hashlib.sha256(" ".join(flags).encode())
    for path in [source] + headers:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every stale library in parallel (by default every CUDA
    kernel); returns the seconds each compile took (0.0 where the library
    was already built). Writes the compiler's output (``nvcc``'s
    register/shared-memory report) to ``_build/<name>.log``. A ``g++``
    compile that outlasts ``CXX_TIMEOUT_S`` raises ``TimeoutExpired``."""
    names = list(sources() if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    seconds = {name: 0.0 for name in names}
    failed = []
    procs = {}
    try:
        for name in names:
            out = so_path(name)
            if os.path.isfile(out):
                continue
            source, _, flags, cuda = _source(name)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc() if cuda else "g++", *flags, "-o", tmp, source]
            with open(os.path.join(BUILD_DIR, name + ".log"), "w") as log:
                proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
            procs[name] = (proc, tmp, out, time.perf_counter(), None if cuda else CXX_TIMEOUT_S)
        for name, (proc, tmp, out, t0, limit) in procs.items():
            rc = proc.wait(None if limit is None else max(0.0, t0 + limit - time.perf_counter()))
            seconds[name] = time.perf_counter() - t0
            if rc == 0:
                os.replace(tmp, out)
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
                details.append(f"--- {os.path.basename(_source(name)[0])} ---\n"
                               f"{f.read()[-4000:]}")
        raise RuntimeError("compile failed:\n" + "\n".join(details))
    return seconds


def library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed. ``signatures``
    maps each C entry to its ``argtypes``; every entry returns an int. A
    CUDA kernel's library needs a CUDA device; a ``native/*.cc`` library
    loads on any host."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _source(name)[3]:
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


def stream_ptr(device) -> int:
    """The address of ``device``'s current CUDA stream (read without making
    a ``torch.cuda.Stream``: a launch on the host's path reads it every
    call)."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
