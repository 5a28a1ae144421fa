"""ctypes wrappers for the native PAF loaders.

pafmt.cpp (main path): reader and parser threads tokenize, filter and
intern in C++ while the caller pulls (7, piece) int32 column pieces
[qid qs qe tid ts te flags] (flags bit0=valid bit1=rev bit2=iden_ok).  The
pieces are concatenated on the host into one exact-size colmat and
uploaded with one pinned copy.

pafread.cpp (staged path): one single-threaded pass to the filtered
records' SoA columns on the host (`load_paf_native`)."""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..seqdict import SeqDict

_CHUNK = 1 << 19  # records per piece for large inputs


class _MaMtInfo(ctypes.Structure):
    _fields_ = [
        ("n_orig", ctypes.c_int64),
        ("n_mirror", ctypes.c_int64),
        ("n_seq", ctypes.c_int64),
        ("n_lines", ctypes.c_int64),
        ("max_len", ctypes.c_int64),
        ("names_bytes", ctypes.c_int64),
    ]


def _bind(lib):
    lib.ma_mt_begin.restype = ctypes.c_void_p
    lib.ma_mt_begin.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_char_p,
                                ctypes.c_int64, ctypes.c_int,
                                ctypes.c_double, ctypes.c_int64,
                                ctypes.c_int, ctypes.c_int64]
    lib.ma_mt_next.restype = ctypes.c_int64
    lib.ma_mt_next.argtypes = [ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_int32),
                               ctypes.c_int64]
    lib.ma_mt_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(_MaMtInfo)]
    lib.ma_mt_names.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ma_mt_seq_len.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_uint32)]
    lib.ma_mt_rank.argtypes = [ctypes.c_void_p]
    lib.ma_mt_rank_fetch.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int64),
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_int64)]
    lib.ma_mt_free.argtypes = [ctypes.c_void_p]


class HitsMt:
    """Handle over the loader state: read names and lengths, and the
    lazily built exact radix permutation of the implied mirrored hit array
    (hit.c:100/ksort.h) for the rare exact-rank order fallback."""

    def __init__(self, lib, res, cap):
        self._lib = lib
        self._res = res
        self.cap = cap
        self._ranked = False
        info = _MaMtInfo()
        lib.ma_mt_info(res, ctypes.byref(info))
        self.n_orig = int(info.n_orig)
        self.n_mirror = int(info.n_mirror)
        self.n_lines = int(info.n_lines)
        self.max_len = int(info.max_len)
        self._n_seq = int(info.n_seq)
        self._names_bytes = int(info.names_bytes)

    def build_rank(self):
        """CPU-bound exact-permutation build."""
        if not self._ranked:
            self._lib.ma_mt_rank(self._res)
            self._ranked = True

    def arc_ranks(self, idx):
        """Map kernel arc indices (j for q-side rows, cap+j for mirrors)
        to positions in the reference's sorted mirrored hit array."""
        self.build_rank()
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        out = np.empty(idx.shape[0], dtype=np.int64)
        self._lib.ma_mt_rank_fetch(
            self._res, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            idx.shape[0], self.cap,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return out

    def seqdict(self):
        blob = ctypes.create_string_buffer(max(self._names_bytes, 1))
        self._lib.ma_mt_names(self._res, blob)
        names = (blob.raw[:self._names_bytes].decode("latin-1")
                 .split("\0")[:self._n_seq])
        lens = np.empty(max(self._n_seq, 1), dtype=np.uint32)
        self._lib.ma_mt_seq_len(
            self._res, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        return SeqDict.from_arrays(names, lens[:self._n_seq].tolist())

    def free(self):
        if self._res:
            self._lib.ma_mt_free(self._res)
            self._res = None

    def __del__(self):
        self.free()


def _excl_blob(excl) -> bytes:
    """The NUL-separated names of an exclusion SeqDict (-R), as the C++
    loaders take them."""
    if excl is None or not excl.n_seq:
        return b""
    return b"\0".join(n.encode() for n in excl.names) + b"\0"


def load_hits_mt(fn, min_span, min_match, *, excl=None, bi_dir=True,
                 min_iden=0.05, device=torch.device("cpu"), n_workers=2):
    """Parse `fn` with the pipelined loader and upload the (7, n) int32
    colmat of the unmirrored originals to `device`; lines naming a read of
    `excl` are dropped.  Returns (colmat, SeqDict, HitsMt)."""
    from .build import get_lib

    lib = get_lib()
    _bind(lib)
    try:
        fsz = os.path.getsize(fn) if fn != "-" else 0
    except OSError:
        fsz = 0
    if fn.endswith(".gz"):
        fsz *= 4
    # PAF lines are ~70-90 B: small inputs ride quarter-size pieces
    chunk = _CHUNK if fsz == 0 or fsz // 100 >= (1 << 22) else _CHUNK >> 2
    blob = _excl_blob(excl)
    res = lib.ma_mt_begin(fn.encode(), min_span, min_match, blob, len(blob),
                          1 if bi_dir else 0, float(min_iden), chunk,
                          n_workers, 0)
    if not res:
        raise FileNotFoundError(2, "could not open PAF file", fn)
    pieces = []
    try:
        while True:
            buf = np.empty((7, chunk), dtype=np.int32)
            n = lib.ma_mt_next(
                res, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                chunk)
            pieces.append(buf[:, :n])
            if n < chunk:
                break
        colmat = np.ascontiguousarray(np.concatenate(pieces, axis=1))
        h = HitsMt(lib, res, cap=colmat.shape[1])
    except BaseException:
        lib.ma_mt_free(res)
        raise
    d = h.seqdict()
    t = torch.from_numpy(colmat)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t, d, h


class _MaPafLoad(ctypes.Structure):
    _fields_ = [
        ("n_rec", ctypes.c_int64),
        ("n_seq", ctypes.c_int64),
        ("n_lines", ctypes.c_int64),
        ("names_bytes", ctypes.c_int64),
        ("qid", ctypes.POINTER(ctypes.c_int32)),
        ("qs", ctypes.POINTER(ctypes.c_uint32)),
        ("qe", ctypes.POINTER(ctypes.c_uint32)),
        ("tid", ctypes.POINTER(ctypes.c_int32)),
        ("ts", ctypes.POINTER(ctypes.c_uint32)),
        ("te", ctypes.POINTER(ctypes.c_uint32)),
        ("ml", ctypes.POINTER(ctypes.c_uint32)),
        ("bl", ctypes.POINTER(ctypes.c_uint32)),
        ("rev", ctypes.POINTER(ctypes.c_uint8)),
        ("seq_len", ctypes.POINTER(ctypes.c_uint32)),
        ("names", ctypes.POINTER(ctypes.c_char)),
    ]


def _arr(ptr, n, dtype):
    if n == 0:
        return np.zeros(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def load_paf_native(fn, min_span, min_match, excl=None):
    """Load, filter and intern `fn` with ma_paf_load (pafread.cpp) into a
    PafLoad of host columns; lines naming a read of `excl` are dropped."""
    from ..paf import PafLoad
    from .build import get_lib

    lib = get_lib()
    lib.ma_paf_load.restype = ctypes.POINTER(_MaPafLoad)
    lib.ma_paf_load.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_char_p,
                                ctypes.c_int64]
    lib.ma_paf_free.argtypes = [ctypes.POINTER(_MaPafLoad)]
    blob = _excl_blob(excl)
    res = lib.ma_paf_load(fn.encode(), min_span, min_match, blob, len(blob))
    if not res:
        raise FileNotFoundError(2, "could not open PAF file", fn)
    try:
        r = res.contents
        n = int(r.n_rec)
        ns = int(r.n_seq)
        names_blob = ctypes.string_at(r.names, int(r.names_bytes))
        names = names_blob.decode("latin-1").split("\0")[:ns]
        d = SeqDict.from_arrays(names, _arr(r.seq_len, ns, np.uint32).tolist())
        return PafLoad(
            qid=_arr(r.qid, n, np.int32), qs=_arr(r.qs, n, np.uint32),
            qe=_arr(r.qe, n, np.uint32), tid=_arr(r.tid, n, np.int32),
            ts=_arr(r.ts, n, np.uint32), te=_arr(r.te, n, np.uint32),
            ml=_arr(r.ml, n, np.uint32), bl=_arr(r.bl, n, np.uint32),
            rev=_arr(r.rev, n, np.uint8), d=d, n_lines=int(r.n_lines))
    finally:
        lib.ma_paf_free(res)
