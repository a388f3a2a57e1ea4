"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``kernels/*/csrc/*.cu`` file is compiled for ``sm_90a`` (one
``nvcc -c`` per source, all started together), linked into one shared
library with a plain C interface, and loaded with ``ctypes``.  The build
runs on first use, into ``build/repro_torch_kernels/<hash>/`` at the
root of the checkout (gitignored), keyed by a hash of the sources, the
headers beside them (``csrc/*.cuh``) and the flags: a changed source
builds anew, an unchanged one loads the library already built.  ``build.log`` beside it keeps ``ptxas``'s
register and shared-memory report, after a ``== <source> (exit <code>,
<seconds> s)`` line per source: when its ``nvcc`` ended, counted from
the start of the build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_KERNELS = Path(__file__).resolve().parent
BUILD_ROOT = _KERNELS.parents[2] / "build" / "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_lib = None
_functions: dict = {}


def sources() -> list:
    return sorted(_KERNELS.glob("*/csrc/*.cu"))


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for s in srcs + sorted(_KERNELS.glob("*/csrc/*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin): the CUDA kernels need the "
                       "CUDA toolkit to build")


def library_path() -> Path:
    return BUILD_ROOT / _digest(sources()) / LIB_NAME


def build() -> Path:
    """Build the library unless this exact source set is already built;
    returns its path."""
    target = library_path()
    if target.exists():
        return target
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix=".tmp-"))
    try:
        srcs = sources()
        t0 = time.perf_counter()
        procs = [(s, subprocess.Popen(
            [nvcc, *ARCH, *FLAGS, "-c", str(s), "-o",
             str(tmp / (s.stem + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for s in srcs]
        ended = {}

        def wait(s, p):
            out, _ = p.communicate()
            ended[s] = (out, time.perf_counter() - t0)

        waiters = [threading.Thread(target=wait, args=sp) for sp in procs]
        for t in waiters:
            t.start()
        for t in waiters:
            t.join()
        log = []
        failed = []
        for s, p in procs:
            out, took = ended[s]
            log.append(f"== {s.name} (exit {p.returncode}, {took:.1f} s)\n"
                       f"{out}")
            if p.returncode:
                failed.append(s.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp / LIB_NAME),
             *[str(tmp / (s.stem + ".o")) for s in srcs]],
            capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        (tmp / "build.log").write_text("\n".join(log))
        try:
            os.rename(tmp, target.parent)
        except OSError:
            # another process finished the same build first
            if not target.exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return target


def load() -> ctypes.CDLL:
    """The built library (building it first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


def function(name: str, argtypes: list):
    """The library's C function ``name``, with ``argtypes`` declared and
    an ``int`` (the ``cudaError_t`` of the launch) as its result."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(load(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def launch_error(name: str, code: int) -> RuntimeError:
    return RuntimeError(f"{name}: kernel launch failed with cudaError_t "
                        f"{code}")
