"""Stable stream compaction of int32 columns on the card (K16).

The JAX package compacts the staged path's hits on the host, in numpy
(pipeline.py:41-47 `_apply_cut`, core/hits.py:50 `Hits.take`,
select/contained.py:65-75 `apply_contained`); the port keeps those hits on
the card and compacts them there with the `compact` kernel
(csrc/compact.cu).  `compact_plain` is its plain PyTorch version, which
the wrapper runs for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda import I32, I64, P, Kernel, ptr

# the compactions of the staged path the JAX package runs in numpy:
# pipeline.py:41 _apply_cut (and the Hits.take it and pipeline.py:121
# call), select/contained.py:65-75
K_COMPACT = Kernel(
    "compact", "compact.cu", "ma_compact", [P, I32, I64, P, P, I64, P, P, P],
    replaces="miniasm_tpu/pipeline.py:41")
MAX_ROWS = 16  # csrc/compact.cu


def _rows(cols):
    return list(cols.unbind(0)) if isinstance(cols, torch.Tensor) \
        else list(cols)


def compact_plain(cols, keep=None, mp=None) -> torch.Tensor:
    """Plain PyTorch version of the compact kernel (see `compact`)."""
    rows = _rows(cols)
    n = rows[0].shape[0]
    ok = torch.ones(n, dtype=torch.bool, device=rows[0].device) \
        if keep is None else keep.to(torch.bool)
    if mp is not None:
        T = mp.shape[0]
        q = mp[rows[0].clamp(0, T - 1).long()]
        t = mp[rows[3].clamp(0, T - 1).long()]
        ok = ok & (q >= 0) & (t >= 0)
        rows = [q, *rows[1:3], t, *rows[4:]]
    return torch.stack(rows)[:, ok]


def compact(cols, keep=None, mp=None) -> torch.Tensor:
    """K16.  cols: a (k, n) int32 tensor or k (n,) int32 rows (1 <= k <=
    16); keep: (n,) bool or uint8, or None (every column); mp: (T,) int32
    or None.  Returns the (k, m) int32 columns that survive, in column
    order: those whose keep is set and, with mp, both of whose ids (rows 0
    and 3) map to 0 or more, carrying the mapped ids in rows 0 and 3."""
    rows = _rows(cols)
    if rows[0].device.type == "cpu":
        return compact_plain(rows, keep, mp)
    k, n = len(rows), rows[0].shape[0]
    dev = rows[0].device
    if not 1 <= k <= MAX_ROWS or (mp is not None and k < 4):
        raise ValueError("compact: 1 to %d rows (4 with a remap) expected"
                         % MAX_ROWS)
    if any(r.dtype != torch.int32 or r.shape != (n,) for r in rows):
        raise TypeError("compact: int32 rows of one length expected")
    if keep is not None and (keep.shape != (n,) or keep.dtype not in (
            torch.bool, torch.uint8)):
        raise ValueError("compact: keep must be (n,) bool or uint8")
    if n == 0:
        return torch.empty((k, 0), dtype=torch.int32, device=dev)
    if mp is not None and (mp.dtype != torch.int32 or mp.dim() != 1
                           or mp.numel() == 0):
        raise ValueError("compact: mp must be a non-empty (T,) int32 map")
    if n >= 1 << 31:
        raise ValueError("compact: at most 2**31 - 1 columns")
    # one pointer a row: the rows may come from several tensors
    ptrs = (ctypes.c_void_p * k)(*[ptr(r) for r in rows])
    bsum = torch.empty((n + 1023) // 1024, dtype=torch.int32, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    out = torch.empty(k * n, dtype=torch.int32, device=dev)
    K_COMPACT(ctypes.cast(ptrs, ctypes.c_void_p), k, n,
              None if keep is None else ptr(keep.view(torch.uint8)),
              None if mp is None else ptr(mp),
              0 if mp is None else mp.shape[0], ptr(bsum), ptr(total),
              ptr(out))
    m = int(total)
    return out[:k * m].view(k, m)
