"""Unitig sequence splicing for -f (reference ma_ug_seq, asm.c:236-290).

Each read contributes its trimmed prefix (forward) or the reverse
complement of its trimmed suffix (reverse) to the unitig at its golden-path
offset; unfilled bases stay 'N'.  The reads file (FASTA or FASTQ, gzip or
not) is streamed in C++ (io/native/fastx.cpp ma_ug_seq_native), whose
complement table is the reference's comp_tab (asm.c:225-233).  A failed
build raises, and a reads file that cannot be opened raises
FileNotFoundError.
"""

from __future__ import annotations

import ctypes

import numpy as np


class _MaUgSeqOut(ctypes.Structure):
    _fields_ = [
        ("total_len", ctypes.c_int64),
        ("n_utg", ctypes.c_int64),
        ("offsets", ctypes.POINTER(ctypes.c_int64)),
        ("seq", ctypes.POINTER(ctypes.c_char)),
    ]


def _read_tables(ug, n_seq):
    """Per-read (utg, ori, start, len) golden-path table (asm.c:247-260)."""
    t_utg = np.full(n_seq, -1, dtype=np.int64)
    t_ori = np.zeros(n_seq, dtype=np.uint8)
    t_start = np.zeros(n_seq, dtype=np.int64)
    t_len = np.zeros(n_seq, dtype=np.int64)
    for i, u in enumerate(ug.u):
        l = 0
        for (vtx, ll) in u.a:
            x = vtx >> 1
            assert t_len[x] == 0  # a read joins at most one unitig (asm.c:255)
            t_utg[x] = i
            t_ori[x] = vtx & 1
            t_start[x] = l
            t_len[x] = ll
            l += ll
    return t_utg, t_ori, t_start, t_len


def ug_seq(ug, d, sub_s, sub_e, fn: str) -> None:
    """Fill Unitig.s in place from the reads file `fn`; sub_s/sub_e are the
    reads' trim tables, or None when no selection pass ran."""
    from ..io.native.build import get_lib

    lib = get_lib()
    lib.ma_ug_seq_native.restype = ctypes.POINTER(_MaUgSeqOut)
    lib.ma_ug_seq_native.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32)]
    lib.ma_ug_seq_free.argtypes = [ctypes.POINTER(_MaUgSeqOut)]

    n_seq = d.n_seq
    t_utg, t_ori, t_start, t_len = _read_tables(ug, n_seq)
    blob = ("\0".join(d.names) + "\0").encode("latin-1") if n_seq else b"\0"
    has_sub = sub_s is not None
    ss = np.ascontiguousarray(sub_s if has_sub else np.zeros(n_seq),
                              dtype=np.uint32)
    se = np.ascontiguousarray(sub_e if has_sub else np.zeros(n_seq),
                              dtype=np.uint32)
    tu = np.ascontiguousarray(t_utg, dtype=np.int64)
    to = np.ascontiguousarray(t_ori, dtype=np.uint8)
    tst = np.ascontiguousarray(t_start, dtype=np.uint32)
    tl = np.ascontiguousarray(t_len, dtype=np.uint32)
    ulen = np.ascontiguousarray([u.len for u in ug.u], dtype=np.uint32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    res = lib.ma_ug_seq_native(
        fn.encode(), n_seq, blob, len(blob), 1 if has_sub else 0,
        ptr(ss, ctypes.c_uint32), ptr(se, ctypes.c_uint32),
        ptr(tu, ctypes.c_int64), ptr(to, ctypes.c_uint8),
        ptr(tst, ctypes.c_uint32), ptr(tl, ctypes.c_uint32),
        len(ug.u), ptr(ulen, ctypes.c_uint32))
    if not res:
        raise FileNotFoundError(2, "could not open reads file", fn)
    try:
        r = res.contents
        offs = np.ctypeslib.as_array(r.offsets, shape=(len(ug.u) + 1,))
        blob_out = ctypes.string_at(r.seq, int(r.total_len))
        for i, u in enumerate(ug.u):
            u.s = blob_out[offs[i]:offs[i + 1]].decode("latin-1")
    finally:
        lib.ma_ug_seq_free(res)
