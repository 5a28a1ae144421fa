"""On-demand builder for the host C++ loader.

Compiles every .cpp in this directory (the PAF loaders, the exact radix
argsort they and the finalizer link, the FASTA/-R streams and the native
graph finalizer) into one shared object with g++ (-O3, zlib).
The result is cached next to the sources and rebuilt when a source is
newer.  A failed build raises: the port has no fallback path."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libminiasm_torch_native.so")
_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(
        os.path.join(_DIR, f) for f in os.listdir(_DIR) if f.endswith(".cpp"))


def _needs_build() -> bool:
    if not os.path.exists(_SO):
        return True
    so_mtime = os.path.getmtime(_SO)
    return any(os.path.getmtime(s) > so_mtime for s in _sources())


def get_lib():
    """The loaded native library; builds it on first use or raises."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _needs_build():
            tmp = "%s.%d.tmp" % (_SO, os.getpid())
            cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                   "-std=c++17", "-pthread", "-o", tmp] + _sources() + ["-lz"]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError("native loader build failed: %s"
                                   % r.stderr[-2000:])
            os.replace(tmp, _SO)
        _lib = ctypes.CDLL(_SO)
        return _lib
