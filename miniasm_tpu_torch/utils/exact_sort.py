"""Exact-permutation emulation of the reference's radix sort.

The reference sorts hits and arcs with an in-place MSD radix sort
(KRADIX_SORT_INIT, ksort.h:134-183): 8-bit digits top-down, cycle-leader
distribution, insertion sort for buckets <= 64 (RS_MIN_SIZE).  That sort is
NOT stable — the relative order of equal keys is a deterministic function
of the input permutation — and the tie order leaks into the output (hit
dump order, arc slot order, hence del_multi/biloop/unitig decisions).
Byte-parity therefore requires reproducing the exact permutation, not just
a sorted order.

The permutation depends only on the key sequence (records move atomically,
decisions read only keys), so running the same algorithm on (key, index)
pairs yields the reference's exact row permutation.

Used on the host at the two points the reference sorts: once over hits
after reading (hit.c:104) and once over arcs at first cleanup
(asg.c:22-25, gated by is_srt).  The C++ implementation lives in
io/native/exact_sort.cpp.
"""

from __future__ import annotations

import numpy as np


def radix_argsort(keys: np.ndarray) -> np.ndarray:
    """Return the permutation the reference radix sort would produce for
    these u64 keys (native C++, io/native/exact_sort.cpp)."""
    import ctypes

    from ..io.native.build import get_lib

    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    lib = get_lib()
    n = len(keys)
    idx = np.arange(n, dtype=np.int64)
    kcopy = keys.copy()
    lib.ma_radix_argsort_u64(
        kcopy.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n))
    return idx
