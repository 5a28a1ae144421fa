"""Array helpers over int32 key columns (port of miniasm_tpu/utils/arrays.py).

Set membership over composite keys (`member_multi`, l.81): the JAX program
sorts hay and needles together with a stable multi-key sort and scans for
the last hay row.  Here each key tuple is packed into one int64, the hay
keys are sorted with one `torch.sort`, and the K7 `key_member` kernel
(csrc/symm.cu) looks each needle up by binary search.

The sorting and indexing helpers (`argsort_multi`, `sort_rows_multi`,
`segment_starts`, `csr_index`, `compact`) are plain torch ops with the JAX
functions' results, int32 where those are int32.  No caller in the port
needs a kernel for them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cuda import I64, P, Kernel, ptr

INT32_MAX = 2**31 - 1

K_MEMBER = Kernel(
    "key_member", "symm.cu", "ma_key_member", [P, I64, P, I64, I64, P],
    replaces="miniasm_tpu/utils/arrays.py:81")


def _masked_i32(col: torch.Tensor, n) -> torch.Tensor:
    """The column cast to int32 (wrapping, like astype), rows >= n set to
    INT32_MAX."""
    col = col.to(torch.int32)
    if n is None:
        return col
    iota = torch.arange(col.shape[0], device=col.device)
    return torch.where(iota < n, col, INT32_MAX)


def argsort_multi(keys, n=None) -> torch.Tensor:
    """Stable lexicographic argsort by integer key columns, keys[0] the
    most significant, each cast to int32; with n, rows >= n sort as
    INT32_MAX in every key.  LSD rounds of stable sorts, as the JAX
    function.  Returns (m,) int32."""
    ks = [_masked_i32(k, n) for k in keys]
    perm = torch.arange(ks[0].shape[0], device=ks[0].device)
    for k in reversed(ks):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm.to(torch.int32)


def sort_rows_multi(cols, keys_idx, n=None):
    """Stable sort of equally long 1-D columns by the columns named in
    keys_idx (most significant first).  Returns (permuted columns, perm)."""
    perm = argsort_multi([cols[i] for i in keys_idx], n=n)
    return [c[perm.long()] for c in cols], perm


def segment_starts(sorted_ids: torch.Tensor, n) -> torch.Tensor:
    """Bool mask of the rows that start an id run of a sorted column: row
    i < n whose id differs from row i-1's (row 0 against -1)."""
    prev = torch.cat([torch.full((1,), -1, dtype=sorted_ids.dtype,
                                 device=sorted_ids.device), sorted_ids[:-1]])
    iota = torch.arange(sorted_ids.shape[0], device=sorted_ids.device)
    return (iota < n) & (sorted_ids != prev)


def csr_index(sorted_ids: torch.Tensor, n, num_segments: int):
    """CSR index over a sorted id column (asg_arc_index_core, asg.c:27-36):
    int32 (start, count) per segment id 0..num_segments-1 from two
    searchsorteds; rows >= n read as INT32_MAX, absent ids count 0."""
    ids = _masked_i32(sorted_ids, n)
    seg = torch.arange(num_segments, dtype=torch.int32, device=ids.device)
    start = torch.searchsorted(ids, seg, side="left", out_int32=True)
    end = torch.searchsorted(ids, seg, side="right", out_int32=True)
    return start, end - start


def compact(mask: torch.Tensor, cols, n=None):
    """Stable compaction: the rows whose mask is set (and, with n, whose
    index is below n) move to the front in order, the rest follow in
    order.  Returns (permuted columns, int32 count of the kept rows)."""
    if n is not None:
        mask = mask & (torch.arange(mask.shape[0], device=mask.device) < n)
    perm = argsort_multi([torch.where(mask, 0, 1)]).long()
    return [c[perm] for c in cols], mask.sum().to(torch.int32)


def key_column(k, device: torch.device) -> torch.Tensor:
    """One numpy key column as int32 on `device` (a cast that wraps, like
    the JAX program's astype)."""
    return torch.from_numpy(np.asarray(k).astype(np.int32)).to(device)


def _pack2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a, b) int32 -> a<<32 | b as int64: equal iff both columns equal."""
    return (a.to(torch.int64) << 32) | (b.to(torch.int64) & 0xFFFFFFFF)


def pack_keys(cols: list[torch.Tensor]) -> torch.Tensor:
    """Pack int32 key columns (most significant first) into one int64 per
    row that is equal exactly when every column is: one column sign-extends,
    two pack into the high and low words, and longer tuples first fold
    their leading pair into its dense rank."""
    cols = list(cols)
    while len(cols) > 2:
        rank = torch.unique(_pack2(cols[0], cols[1]), return_inverse=True)[1]
        cols = [rank.to(torch.int32)] + cols[2:]
    if len(cols) == 1:
        return cols[0].to(torch.int64)
    return _pack2(cols[0], cols[1])


def key_member_plain(hay_sorted: torch.Tensor, needles: torch.Tensor,
                     needle_n: int) -> torch.Tensor:
    """Plain PyTorch version of K7: (mq,) bool, needle i < needle_n found in
    the sorted (mh,) int64 hay."""
    mh, mq = hay_sorted.shape[0], needles.shape[0]
    live = torch.arange(mq, device=needles.device) < needle_n
    if mh == 0:
        return torch.zeros(mq, dtype=torch.bool, device=needles.device)
    pos = torch.searchsorted(hay_sorted, needles).clamp(max=mh - 1)
    return (hay_sorted[pos] == needles) & live


def key_member(hay_sorted: torch.Tensor, needles: torch.Tensor,
               needle_n: int) -> torch.Tensor:
    """K7.  hay_sorted (mh,) int64 ascending, needles (mq,) int64.  Returns
    (mq,) bool: needle i < needle_n equals some hay key."""
    if needles.device.type == "cpu":
        return key_member_plain(hay_sorted, needles, needle_n)
    if hay_sorted.dtype != torch.int64 or needles.dtype != torch.int64:
        raise TypeError("key_member: int64 keys expected")
    if hay_sorted.device != needles.device:
        raise ValueError("key_member: hay and needles on different devices")
    mq = needles.shape[0]
    found = torch.empty(mq, dtype=torch.bool, device=needles.device)
    if mq:
        K_MEMBER(ptr(hay_sorted), hay_sorted.shape[0], ptr(needles), mq,
                 max(min(int(needle_n), mq), 0), ptr(found))
    return found


def member_multi(hay_keys, hay_n, needle_keys, needle_n,
                 device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """Is each needle tuple among the hay tuples?  Numpy key columns are
    cast to int32; hay rows >= hay_n take INT32_MAX in every
    column (so an all-INT32_MAX needle is found there) and needles >=
    needle_n are False, as in the JAX program.  Returns (mq,) bool on
    `device`."""
    assert len(hay_keys) == len(needle_keys)
    h = [key_column(k, device) for k in hay_keys]
    q = [key_column(k, device) for k in needle_keys]
    mh = h[0].shape[0]
    h = [_masked_i32(k, hay_n) for k in h]
    q = [_masked_i32(k, needle_n) for k in q]
    keys = pack_keys([torch.cat([a, b]) for a, b in zip(h, q)])
    hay = torch.sort(keys[:mh]).values
    return key_member(hay, keys[mh:].contiguous(), needle_n)
