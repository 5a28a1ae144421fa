"""Set membership over composite integer keys (port of
miniasm_tpu/utils/arrays.py:81 member_multi).

The JAX program sorts hay and needles together with a stable multi-key sort
and scans for the last hay row.  Here each key tuple is packed into one
int64, the hay keys are sorted with one `torch.sort`, and the K7
`key_member` kernel (csrc/symm.cu) looks each needle up by binary search.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cuda import I64, P, Kernel, ptr

INT32_MAX = 2**31 - 1

K_MEMBER = Kernel(
    "key_member", "symm.cu", "ma_key_member", [P, I64, P, I64, I64, P],
    replaces="miniasm_tpu/utils/arrays.py:81")


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
    mh, mq = h[0].shape[0], q[0].shape[0]
    h = [torch.where(torch.arange(mh, device=device) >= hay_n, INT32_MAX, k)
         for k in h]
    q = [torch.where(torch.arange(mq, device=device) >= needle_n, INT32_MAX,
                     k) for k in q]
    keys = pack_keys([torch.cat([a, b]) for a, b in zip(h, q)])
    hay = torch.sort(keys[:mh]).values
    return key_member(hay, keys[mh:].contiguous(), needle_n)
