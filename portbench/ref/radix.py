"""The permutation of miniasm's radix sort, in NumPy and Python.

miniasm sorts its hits (hit.c) and, once, its arcs (asg_cleanup) with the
in-place MSD radix sort of klib's ksort.h (KRADIX_SORT_INIT, RS_MAX_BITS
8, RS_MIN_SIZE 64): 8-bit digits from the top, buckets filled by cycle
leaders, an insertion sort for buckets of 64 or fewer.  That sort is not
stable, and where keys tie the order it leaves reaches the output.  The
permutation depends on the key sequence alone, so running the same steps
on the keys gives the reference's order of the records.

This is a plain rendering of those steps.  A pass over a range whose
digits are already in order moves nothing, and is skipped; the insertion
sorts, which are stable, run as one stable NumPy sort.
"""

from __future__ import annotations

import numpy as np

RS_MIN_SIZE = 64


def _distribute(d: np.ndarray) -> np.ndarray:
    """One pass of cycle-leader distribution over a range whose digits are
    `d`: returns, for each slot of the range after the pass, the index of
    the element that lies there."""
    dl = d.tolist()
    n = len(dl)
    cnt = [0] * 256
    for x in dl:
        cnt[x] += 1
    b = [0] * 256
    e = [0] * 256
    acc = 0
    for k in range(256):
        b[k] = acc
        acc += cnt[k]
        e[k] = acc
    a = list(range(n))
    k = 0
    while k < 256:
        bk, ek = b[k], e[k]
        # elements already in bucket k stay where they are
        while bk != ek and dl[a[bk]] == k:
            bk += 1
        b[k] = bk
        if bk == ek:
            k += 1
            continue
        tmp = a[bk]
        l = dl[tmp]
        while True:
            swap = tmp
            tmp = a[b[l]]
            a[b[l]] = swap
            b[l] += 1
            l = dl[tmp]
            if l == k:
                break
        a[b[k]] = tmp
        b[k] += 1
    return np.asarray(a, dtype=np.int64)


def radix_argsort(keys) -> np.ndarray:
    """The order in which miniasm's radix sort leaves the uint64 `keys`."""
    keys = np.array(keys, dtype=np.uint64)
    n = keys.size
    idx = np.arange(n, dtype=np.int64)
    if n <= RS_MIN_SIZE:
        return np.argsort(keys, kind="stable")
    small = []
    pending = [(0, n)]
    s = 56
    while pending:
        nxt = []
        for lo, hi in pending:
            d = ((keys[lo:hi] >> np.uint64(s)) & np.uint64(0xFF)).astype(np.int64)
            if np.any(d[1:] < d[:-1]):
                p = _distribute(d)
                keys[lo:hi] = keys[lo:hi][p]
                idx[lo:hi] = idx[lo:hi][p]
                d = d[p]
            if s == 0:
                continue
            cnt = np.bincount(d, minlength=256)
            ends = lo + np.cumsum(cnt)
            starts = ends - cnt
            for k in np.flatnonzero(cnt > 1).tolist():
                rng = (int(starts[k]), int(ends[k]))
                (nxt if cnt[k] > RS_MIN_SIZE else small).append(rng)
        pending = nxt
        s = s - 8 if s > 8 else 0
    if small:
        lo = np.array([r[0] for r in small], dtype=np.int64)
        ln = np.array([r[1] - r[0] for r in small], dtype=np.int64)
        rid = np.repeat(np.arange(len(small)), ln)
        pos = np.arange(int(ln.sum()), dtype=np.int64) - np.repeat(
            np.cumsum(ln) - ln, ln) + np.repeat(lo, ln)
        o = np.lexsort((keys[pos], rid))
        keys[pos] = keys[pos[o]]
        idx[pos] = idx[pos[o]]
    return idx
