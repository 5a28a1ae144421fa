"""Build and launch the hand-written CUDA kernels of `csrc/`.

Each `csrc/*.cu` file is compiled by nvcc for Hopper (`sm_90a`) into its
own shared library with a plain C interface and loaded with ctypes.  The
libraries go to `build/` inside the package (git-ignored), named by a
hash of the sources and flags, so an edit rebuilds and a rerun reuses.  `build()` compiles every source at once, one nvcc process each.

A `Kernel` is one C entry point.  Calling it launches on PyTorch's current
stream; the C function returns `cudaGetLastError()` and a non-zero code
raises.  Each `Kernel` counts its launches, so a run can show that it went
through the kernel (`reset_launches`, `launch_counts`).  While a run
records (utils/timers.py), a kernel's first call in the process is the
span `cold:<kernel>`: the library's load, the first launch and a
synchronize, so that the lazy module load falls inside it; the counters
`cuda.built` and `cuda.libs_loaded` count the sources compiled and the
libraries loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from .utils import timers

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}  # source -> nvcc/ptxas output of its build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for c in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (CUDA_HOME=%s): the CUDA kernels "
                       "cannot be built" % home)


def _lib_path(source: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC)):
        if f == source or f.endswith(".cuh"):
            with open(os.path.join(CSRC, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, "%s-%s.so" % (stem, h.hexdigest()[:16]))


def sources() -> list[str]:
    return sorted(f for f in os.listdir(CSRC) if f.endswith(".cu"))


def build(srcs=None) -> float:
    """Compile the given (default: all) sources that are not built yet,
    one nvcc process each, all started together.  Returns the seconds
    spent; raises with the compiler's output when a build fails."""
    t0 = time.time()
    with _lock:
        todo = [s for s in (srcs or sources())
                if not os.path.exists(_lib_path(s))]
        if not todo:
            return 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for s in todo:
            out = _lib_path(s)
            tmp = "%s.%d.tmp" % (out, os.getpid())
            cmd = [nvcc] + NVCC_FLAGS + ["-o", tmp, os.path.join(CSRC, s)]
            procs.append((s, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for s, out, tmp, p in procs:
            log, _ = p.communicate()
            BUILD_LOG[s] = log
            if p.returncode != 0:
                failed.append("%s:\n%s" % (s, log[-3000:]))
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    timers.count("cuda.built", len(todo))
    return time.time() - t0


def _lib(source: str) -> ctypes.CDLL:
    lib = _libs.get(source)
    if lib is None:
        build([source])
        with _lock:
            lib = _libs.get(source)
            if lib is None:
                lib = ctypes.CDLL(_lib_path(source))
                _libs[source] = lib
                timers.count("cuda.libs_loaded")
    return lib


KERNELS: list["Kernel"] = []


class Kernel:
    """One kernel entry point of a `csrc/` source.

    argtypes lists the ctypes of the arguments before the trailing stream
    argument.  `replaces` is the file:line of the JAX device program it
    ports."""

    def __init__(self, name: str, source: str, symbol: str, argtypes,
                 replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self._fn = None
        KERNELS.append(self)

    def __call__(self, *args) -> None:
        if self._fn is None:
            with timers.span("cold:" + self.name):
                fn = getattr(_lib(self.source), self.symbol)
                fn.argtypes = self.argtypes + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                self._fn = fn
                self._launch(args)
                if timers.recording():
                    torch.cuda.synchronize()
            return
        self._launch(args)

    def _launch(self, args) -> None:
        err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError("%s: kernel launch failed (cudaError %d)"
                               % (self.name, err))
        self.launches += 1


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def ptr(t: torch.Tensor) -> int:
    """Device pointer of a contiguous CUDA tensor (validated)."""
    if not t.is_cuda:
        raise ValueError("expected a CUDA tensor, got %s" % t.device)
    if not t.is_contiguous():
        raise ValueError("expected a contiguous tensor")
    return t.data_ptr()


# shared memory a block may use on an H100 (227 KB), the most a kernel's
# dynamic shared memory can be raised to
SMEM_MAX = 232448

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_int64
F32 = ctypes.c_float
