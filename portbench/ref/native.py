"""The reference's C (native.c), built by the host's cc the first time it
is needed and called through ctypes: miniasm's radix order and the PAF
read.

The library lies in .portbench_cache/ref/ at the checkout's root, named
by the hash of its source, so a checkout builds it once.  A failed build
raises BuildError with the compiler's message: the reference has no
slower path to fall back to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "native.c")
CACHE = os.path.join(os.path.dirname(os.path.dirname(HERE)),
                     ".portbench_cache", "ref")
CC = "cc"

_lib = None


class BuildError(RuntimeError):
    """The reference's C did not build or load."""


def _build() -> str:
    with open(SOURCE, "rb") as f:
        src = f.read()
    path = os.path.join(CACHE, "pbref-%s.so"
                        % hashlib.sha256(src).hexdigest()[:16])
    if os.path.exists(path):
        return path
    os.makedirs(CACHE, exist_ok=True)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    cmd = [CC, "-O2", "-shared", "-fPIC", "-o", tmp, SOURCE]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise BuildError("the reference's C did not build (%s): %s"
                         % (" ".join(cmd), e)) from e
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise BuildError("the reference's C did not build (%s, exit %d): %s"
                         % (" ".join(cmd), r.returncode, r.stderr[-2000:]))
    os.replace(tmp, path)
    return path


def lib():
    """The loaded library, built first where it is not there yet."""
    global _lib
    if _lib is None:
        path = _build()
        try:
            so = ctypes.CDLL(path)
        except OSError as e:
            raise BuildError("the reference's C did not load: %s" % e) from e
        i64, p = ctypes.c_int64, ctypes.c_void_p
        so.pb_radix_order.argtypes = [p, i64, p]
        so.pb_radix_order.restype = ctypes.c_int
        so.pb_paf_read.argtypes = [p, i64, i64, i64, ctypes.c_int, p, p, p,
                                   p, p]
        so.pb_paf_read.restype = ctypes.c_int
        so.pb_count_lines.argtypes = [p, i64]
        so.pb_count_lines.restype = i64
        _lib = so
    return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def radix_order(keys) -> np.ndarray:
    """The order in which miniasm's radix sort leaves the uint64 `keys`
    (radix.radix_argsort's permutation)."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    order = np.empty(keys.size, dtype=np.int64)
    if lib().pb_radix_order(_ptr(keys), keys.size, _ptr(order)) != 0:
        raise MemoryError("pb_radix_order: out of memory")
    return order


def paf_read(raw: bytes, min_span: int, min_match: int, split: bool):
    """pb_paf_read over the bytes `raw`.  Returns (columns, names, lens,
    lines): the kept records' int64 columns qid, qs, qe, tid, ts, te, ml,
    bl, rev; the read names by id (str) and their lengths (int64); the
    lines of 10 fields or more."""
    buf = np.frombuffer(raw, dtype=np.uint8)
    cap = lib().pb_count_lines(_ptr(buf), buf.size)
    keys = ("qid", "qs", "qe", "tid", "ts", "te", "ml", "bl", "rev")
    cols = np.empty((len(keys), cap), dtype=np.int64)
    rows = (ctypes.c_void_p * len(keys))(*(_ptr(c) for c in cols))
    noff, nlen, nrl = (np.empty(2 * cap, dtype=np.int64) for _ in range(3))
    out = np.zeros(3, dtype=np.int64)
    if lib().pb_paf_read(_ptr(buf), buf.size, min_span, min_match,
                         int(split), ctypes.addressof(rows), _ptr(noff),
                         _ptr(nlen), _ptr(nrl), _ptr(out)) != 0:
        raise MemoryError("pb_paf_read: out of memory")
    n_lines, n, n_names = (int(x) for x in out)
    names = [raw[o:o + ln].decode("latin-1") for o, ln in
             zip(noff[:n_names].tolist(), nlen[:n_names].tolist())]
    return ({k: cols[i, :n] for i, k in enumerate(keys)}, names,
            nrl[:n_names].copy(), n_lines)
