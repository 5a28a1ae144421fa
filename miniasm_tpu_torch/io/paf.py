"""PAF loading into structure-of-array columns + interned read ids, for
the staged selection path (the main path streams through pafmt.cpp).

Semantics of the reference's scalar path (paf.c:34-67 parsing,
hit.c:70-107 filter+intern), kept exactly:

  - a line is parsed from its first 11 tab fields (qn ql qs qe strand tn tl
    ts te ml bl); lines with <10 separators are skipped (paf.c:55);
  - record filter: qe-qs < min_span or te-ts < min_span or ml < min_match
    drops the line BEFORE interning (hit.c:85) -- so id order is the
    first-appearance order of names on *surviving* lines, qn before tn
    (hit.c:88-90).  This order is load-bearing for output parity.
  - optional exclusion set by name (hit.c:86, used by -R).

The parse is the native C++ tokenizer (io/native/pafread.cpp), and the -R
prefilter is its C++ pass (io/native/fastx.cpp); a failed build raises.
`open_text` opens a text input for the host tools (minidot, interop, eval).
"""

from __future__ import annotations

import dataclasses
import gzip
import io as _io
import sys

import numpy as np

from .seqdict import SeqDict


def open_text(fn: str):
    """Open a possibly-gzipped text file ('-' = stdin), like gzopen/gzdopen
    in the reference (paf.c:14)."""
    if fn == "-" or fn is None:
        raw = sys.stdin.buffer
        head = raw.peek(2) if hasattr(raw, "peek") else b""
        if head[:2] == b"\x1f\x8b":
            return gzip.open(raw, "rt")
        return _io.TextIOWrapper(raw)
    with open(fn, "rb") as f:
        head = f.read(2)
    if head == b"\x1f\x8b":
        return gzip.open(fn, "rt")
    return open(fn, "rt")


@dataclasses.dataclass
class PafLoad:
    """Filtered PAF records with interned ids, plus the id dictionary."""

    qid: np.ndarray  # int32
    qs: np.ndarray   # uint32
    qe: np.ndarray   # uint32
    tid: np.ndarray  # int32
    ts: np.ndarray   # uint32
    te: np.ndarray   # uint32
    ml: np.ndarray   # uint32
    bl: np.ndarray   # uint32
    rev: np.ndarray  # uint8 (0/1)
    d: SeqDict
    n_lines: int     # total PAF lines seen

    @property
    def n(self) -> int:
        return len(self.qid)


def load_paf(fn: str, min_span: int, min_match: int,
             excl: SeqDict | None = None) -> PafLoad:
    """Load + filter + intern a PAF file (reference ma_hit_read's read loop,
    hit.c:82-99, minus the hit mirroring, which core/hits.py does); lines
    naming a read of `excl` are dropped."""
    from .native.pafload import load_paf_native

    return load_paf_native(fn, min_span, min_match, excl=excl)


def no_cont_prefilter(fn: str, min_span: int, min_match: int,
                      max_hang: int, int_frac: float) -> SeqDict:
    """Step 0 (-R): one streaming pass recording clearly-contained reads in
    an exclusion dict (reference ma_hit_no_cont, hit.c:38-68), in C++
    (io/native/fastx.cpp ma_no_cont)."""
    import ctypes

    from ..utils.timers import log
    from .native.build import get_lib

    class _MaNoCont(ctypes.Structure):
        _fields_ = [("n", ctypes.c_int64), ("names_bytes", ctypes.c_int64),
                    ("names", ctypes.POINTER(ctypes.c_char)),
                    ("lens", ctypes.POINTER(ctypes.c_uint32))]

    lib = get_lib()
    lib.ma_no_cont.restype = ctypes.POINTER(_MaNoCont)
    lib.ma_no_cont.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_double]
    lib.ma_no_cont_free.argtypes = [ctypes.POINTER(_MaNoCont)]
    res = lib.ma_no_cont(fn.encode(), min_span, min_match, max_hang,
                         float(int_frac))
    if not res:
        raise FileNotFoundError(2, "could not open PAF file", fn)
    try:
        r = res.contents
        n = int(r.n)
        d = SeqDict()
        if n:
            blob = ctypes.string_at(r.names, int(r.names_bytes))
            names = blob.decode("latin-1").split("\0")[:n]
            lens = np.ctypeslib.as_array(r.lens, shape=(n,)).copy()
            for nm, ln in zip(names, lens):
                d.put(nm, int(ln))
    finally:
        lib.ma_no_cont_free(res)
    log("no_cont", "dropped %d contained reads", d.n_seq)
    return d
