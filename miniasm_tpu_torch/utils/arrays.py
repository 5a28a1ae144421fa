"""Array helpers over int32 key columns (port of miniasm_tpu/utils/arrays.py).

Set membership over composite keys (`member_multi`, l.81): the JAX program
sorts hay and needles together with a stable multi-key sort and scans for
the last hay row.  Here the K7 `key_member` kernel (csrc/symm.cu) takes
the int32 key columns on the card as they are, inserts the hay keys into
a hash table and looks each needle up; no sort runs in front of it.

The sorting and indexing helpers (`argsort_multi`, `sort_rows_multi`,
`segment_starts`, `csr_index`, `compact`) are plain torch ops with the JAX
functions' results, int32 where those are int32.  No caller in the port
needs a kernel for them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cuda import I32, I64, P, Kernel, ptr

INT32_MAX = 2**31 - 1

K_MEMBER = Kernel(
    "key_member", "symm.cu", "ma_key_member",
    [P, P, I64, I64, P, P, I64, I64, I32, P, I64, P],
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


def fold_keys(cols: list[torch.Tensor]) -> list[torch.Tensor]:
    """Int32 key columns (most significant first) folded to at most two
    that are equal exactly when every column is: a longer tuple's leading
    pair becomes its dense rank, until two columns are left."""
    cols = list(cols)
    while len(cols) > 2:
        rank = torch.unique(_pack2(cols[0], cols[1]), return_inverse=True)[1]
        cols = [rank.to(torch.int32)] + cols[2:]
    return cols


def pack_keys(cols: list[torch.Tensor]) -> torch.Tensor:
    """Pack int32 key columns into one int64 per row that is equal exactly
    when every column is: one column sign-extends, two pack into the high
    and low words (the packing K7 and K8 do in registers), and longer
    tuples fold first (fold_keys)."""
    cols = fold_keys(cols)
    if len(cols) == 1:
        return cols[0].to(torch.int64)
    return _pack2(cols[0], cols[1])


def check_cols(fn: str, *groups) -> None:
    """K7's and K8's key columns: one or two per group, equally long."""
    for cols in groups:
        if not 1 <= len(cols) <= 2:
            raise ValueError("%s: 1 or 2 key columns expected, got %d"
                             % (fn, len(cols)))
        if len({c.shape for c in cols}) != 1 or cols[0].dim() != 1:
            raise ValueError("%s: key columns of one length expected" % fn)
    if len({len(cols) for cols in groups}) != 1:
        raise ValueError("%s: as many needle as hay columns expected" % fn)


def check_cuda_cols(fn: str, cols) -> torch.device:
    """Raise unless every column is a contiguous int32 tensor on one CUDA
    device; returns the device."""
    dev = cols[0].device
    for c in cols:
        if c.dtype != torch.int32:
            raise TypeError("%s: int32 key columns expected, got %s"
                            % (fn, c.dtype))
        if c.device != dev:
            raise ValueError("%s: key columns on different devices" % fn)
        ptr(c)  # a contiguous CUDA tensor
    return dev


# K7's and K8's hash table: slots per key, so the load factor is at most
# its inverse.  A pass lasts as long as its longest probe chain (about 6
# slots at 1/8 and 31,000 keys, 27 at 1/2); 8 beat 2, 4 and 16 on the
# E. coli calls, measured on the card
SLOTS_PER_KEY = 8


def table_slots(n: int) -> int:
    """The hash table's capacity for n keys: the least power of two of at
    least SLOTS_PER_KEY * n, and at least 2."""
    return 1 << max(SLOTS_PER_KEY * n - 1, 1).bit_length()


def key_member_plain(hay, hay_n, needles, needle_n,
                     needle_xor: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K7: the packed hay keys (rows >= hay_n as
    INT32_MAX in every column) sorted, each packed needle (its columns
    xor needle_xor) looked up by searchsorted; needles >= needle_n are
    False.  Returns (mq,) bool."""
    check_cols("key_member", hay, needles)
    mh, mq = hay[0].shape[0], needles[0].shape[0]
    dev = needles[0].device
    live = torch.arange(mq, device=dev) < needle_n
    if mh == 0:
        return torch.zeros(mq, dtype=torch.bool, device=dev)
    h = torch.sort(pack_keys([_masked_i32(c, hay_n) for c in hay])).values
    q = pack_keys([c ^ needle_xor for c in needles])
    pos = torch.searchsorted(h, q).clamp(max=mh - 1)
    return (h[pos] == q) & live


def key_member(hay, hay_n, needles, needle_n,
               needle_xor: int = 0) -> torch.Tensor:
    """K7.  hay and needles: lists of 1 or 2 int32 key columns (most
    significant first); hay rows >= hay_n take INT32_MAX in every column;
    each needle's columns are xor-ed with needle_xor.  Returns (mq,) bool:
    needle i < needle_n equals some hay key."""
    check_cols("key_member", hay, needles)
    cols = list(hay) + list(needles)
    if all(c.device.type == "cpu" for c in cols):
        return key_member_plain(hay, hay_n, needles, needle_n, needle_xor)
    dev = check_cuda_cols("key_member", cols)
    mh, mq = hay[0].shape[0], needles[0].shape[0]
    if max(mh, mq) >= 2**31:
        raise ValueError("key_member: at most 2^31 - 1 keys")
    found = torch.empty(mq, dtype=torch.bool, device=dev)
    if mq:
        hay_n = max(min(int(hay_n), mh), 0)
        rows = hay_n + (hay_n < mh)  # one row stands for all the pads
        cap = table_slots(rows)
        table = torch.empty(cap, dtype=torch.int32, device=dev)
        two = len(hay) == 2
        K_MEMBER(ptr(hay[0]), ptr(hay[1]) if two else None, rows, hay_n,
                 ptr(needles[0]), ptr(needles[1]) if two else None, mq,
                 max(min(int(needle_n), mq), 0), int(needle_xor),
                 ptr(table), cap, ptr(found))
    return found


def member_multi(hay_keys, hay_n, needle_keys, needle_n,
                 device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """Is each needle tuple among the hay tuples?  Numpy key columns are
    cast to int32; hay rows >= hay_n take INT32_MAX in every
    column (so an all-INT32_MAX needle is found there) and needles >=
    needle_n are False, as in the JAX program.  One or two columns go
    to K7 as they are; longer tuples are masked and folded to two
    columns first (fold_keys over hay and needles together).  Returns
    (mq,) bool on `device`."""
    assert len(hay_keys) == len(needle_keys)
    h = [key_column(k, device) for k in hay_keys]
    q = [key_column(k, device) for k in needle_keys]
    if len(h) > 2:
        mh = h[0].shape[0]
        cols = fold_keys([torch.cat([_masked_i32(a, hay_n), b])
                          for a, b in zip(h, q)])
        h, q, hay_n = [c[:mh] for c in cols], [c[mh:] for c in cols], mh
    return key_member(h, hay_n, q, needle_n)
