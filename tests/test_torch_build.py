"""The native build (``ops/_cuda_build.py``) with a stand-in ``nvcc``: one
compile per source, all started together; libraries keyed by a hash of
the sources, so an edit rebuilds and an unchanged source does not; a failed
compile raises with the compiler's output. No CUDA is compiled here. A
``native/*.cc`` library goes through a stand-in ``g++`` that counts its
compiles and hands them to the host's own, and loads without a card."""

import ctypes
import os
import shutil
import stat
import time

import pytest
import torch

from network_interpretation_imagenet_tpu_torch.ops import _cuda_build

_FAKE_NVCC = """#!/bin/sh
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
echo "ptxas info    : Used 8 registers"
case "$*" in *broken.cu*) echo "broken.cu(1): error: expected a declaration"; exit 2;; esac
sleep 1
echo built > "$out"
"""


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    csrc, build, bin_dir = tmp_path / "csrc", tmp_path / "build", tmp_path / "bin"
    for d in (csrc, bin_dir):
        d.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    monkeypatch.setattr(_cuda_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", str(build))
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    return csrc, build


def test_build_parallel_cached_and_keyed_by_source(fake_toolchain):
    csrc, build = fake_toolchain
    assert _cuda_build.sources() == ["a", "b"]
    t0 = time.perf_counter()
    seconds = _cuda_build.build()
    assert time.perf_counter() - t0 < 1.9  # two 1 s compiles ran together
    assert set(seconds) == {"a", "b"} and all(s > 0 for s in seconds.values())
    first = _cuda_build.so_path("a")
    assert os.path.isfile(first) and "Used 8 registers" in (build / "a.log").read_text()
    assert _cuda_build.build() == {"a": 0.0, "b": 0.0}  # cached
    (csrc / "a.cu").write_text("// a, edited\n")
    assert _cuda_build.so_path("a") != first
    assert _cuda_build.build(["a"])["a"] > 0
    before = _cuda_build.so_path("b")
    (csrc / "common.cuh").write_text("// shared header\n")
    assert _cuda_build.so_path("b") != before  # a header edit rebuilds every source
    assert _cuda_build.build(["b"])["b"] > 0


def test_build_failure_raises_with_compiler_output(fake_toolchain):
    csrc, _ = fake_toolchain
    (csrc / "broken.cu").write_text("oops\n")
    with pytest.raises(RuntimeError, match="expected a declaration"):
        _cuda_build.build()
    assert not os.path.isfile(_cuda_build.so_path("broken"))


def test_a_native_cc_library_builds_once_under_the_shared_name_rule(tmp_path, monkeypatch):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host: the native segmenter cannot build either")
    native, build, bin_dir = tmp_path / "native", tmp_path / "build", tmp_path / "bin"
    for d in (native, bin_dir):
        d.mkdir()
    calls = tmp_path / "calls"
    stand_in = bin_dir / "g++"
    stand_in.write_text(f'#!/bin/sh\necho "$*" >> "{calls}"\nexec "{gxx}" "$@"\n')
    stand_in.chmod(stand_in.stat().st_mode | stat.S_IEXEC)
    (native / "tiny.cc").write_text('extern "C" int tiny(int x) { return x + 1; }\n')
    monkeypatch.setattr(_cuda_build, "CSRC_DIR", str(tmp_path / "csrc"))
    monkeypatch.setattr(_cuda_build, "NATIVE_DIR", str(native))
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", str(build))
    monkeypatch.setattr(_cuda_build, "_libs", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # no card
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")

    def compiles():
        return calls.read_text().splitlines() if calls.exists() else []

    sigs = {"tiny": [ctypes.c_int]}
    assert _cuda_build.sources() == []  # build() with no names stays the CUDA set
    assert _cuda_build.library("tiny", sigs).tiny(41) == 42
    first = _cuda_build.so_path("tiny")
    assert os.path.dirname(first) == str(build)
    assert os.path.basename(first).startswith("tiny-") and first.endswith(".so")
    assert sorted(os.listdir(build)) == sorted([os.path.basename(first), "tiny.log"])
    assert len(compiles()) == 1 and all(f in compiles()[0] for f in _cuda_build.CXX_FLAGS)
    monkeypatch.setattr(_cuda_build, "_libs", {})  # a new process: the file is reused
    assert _cuda_build.library("tiny", sigs).tiny(1) == 2 and len(compiles()) == 1
    assert _cuda_build.build(["tiny"]) == {"tiny": 0.0}
    (native / "tiny.cc").write_text('extern "C" int tiny(int x) { return x + 2; }\n')
    edited = _cuda_build.so_path("tiny")
    assert edited != first
    monkeypatch.setattr(_cuda_build, "_libs", {})
    assert _cuda_build.library("tiny", sigs).tiny(40) == 42 and len(compiles()) == 2
    (native / "common.h").write_text("// shared header\n")
    assert _cuda_build.so_path("tiny") != edited  # a header edit rebuilds too
