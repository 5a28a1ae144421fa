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
    "compact", "compact.cu", "ma_compact",
    [P, I32, I64, P, P, I64, P, I64, P, I64, I64, P, P],
    replaces="miniasm_tpu/pipeline.py:41")
MAX_ROWS = 16  # csrc/compact.cu
MAX_COLS = (1 << 31) - 1  # csrc/compact.cu
# scratch words: m (an int64) and a word a block, for up to this many
# blocks (an H100 holds 528-792 of the kernel's blocks at once, by its
# row count)
SCRATCH_BLOCKS = 4096


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


def spill_words(n: int, words: int) -> int:
    """Global scratch words a compaction of n items may keep its keep
    bits in, `words` bit arrays (csrc/common.cuh coop_spill_words)."""
    return words * (33 * n // 512 + 265)


def compact(cols, keep=None, mp=None, grid=None,
            smem_cap=0) -> torch.Tensor:
    """K16.  cols: a (k, n) int32 tensor or k (n,) int32 rows (1 <= k <=
    16); keep: (n,) bool or uint8, or None (every column); mp: (T,) int32
    or None.  Returns the (k, m) int32 columns that survive, in column
    order: those whose keep is set and, with mp, both of whose ids (rows 0
    and 3) map to 0 or more, carrying the mapped ids in rows 0 and 3.
    grid: a list that, when given, receives the launch's [blocks, columns
    a block, most blocks the card holds at once, global scratch words a
    block keeps its keep bits in (0: shared memory)].  smem_cap: the most
    bytes of shared memory those bits may take (0: what the card allows);
    past it they go to global scratch."""
    mat = isinstance(cols, torch.Tensor)
    first = cols if mat else cols[0]
    if first.device.type == "cpu":
        return compact_plain(cols, keep, mp)
    k = cols.shape[0] if mat else len(cols)
    n = cols.shape[1] if mat else first.shape[0]
    if not 1 <= k <= MAX_ROWS or (mp is not None and k < 4):
        raise ValueError("compact: 1 to %d rows (4 with a remap) expected"
                         % MAX_ROWS)
    if mat:
        if cols.dtype != torch.int32 or cols.dim() != 2:
            raise TypeError("compact: a (k, n) int32 matrix expected")
    elif any(r.dtype != torch.int32 or r.shape != (n,) for r in cols):
        raise TypeError("compact: int32 rows of one length expected")
    if keep is not None and (keep.shape != (n,) or keep.dtype not in (
            torch.bool, torch.uint8)):
        raise ValueError("compact: keep must be (n,) bool or uint8")
    if n == 0:
        return torch.empty((k, 0), dtype=torch.int32, device=first.device)
    if mp is not None and (mp.dtype != torch.int32 or mp.dim() != 1
                           or mp.numel() == 0):
        raise ValueError("compact: mp must be a non-empty (T,) int32 map")
    if n > MAX_COLS:
        raise ValueError("compact: at most 2**31 - 1 columns")
    # one allocation: the output (k * n words, padded to an int64), the
    # survivor count m, the block counts, the keep bits' spill
    kn = (k * n + 1) & ~1
    sw = spill_words(n, 1)
    buf = torch.empty(kn + 2 + SCRATCH_BLOCKS + sw, dtype=torch.int32,
                      device=first.device)
    # one pointer a row: the rows may come from several tensors; a
    # matrix's rows are at its row stride, with no tensor a row
    if mat and cols.stride(1) == 1:
        d, s = cols.data_ptr(), 4 * cols.stride(0)
        ptrs = (ctypes.c_void_p * k)(*[d + s * j for j in range(k)])
    else:
        ptrs = (ctypes.c_void_p * k)(*[ptr(r) for r in _rows(cols)])
    g = (ctypes.c_int * 4)()
    base = buf.data_ptr()
    scratch = base + 4 * kn
    K_COMPACT(ctypes.addressof(ptrs), k, n,
              None if keep is None else ptr(keep.view(torch.uint8)),
              None if mp is None else ptr(mp),
              0 if mp is None else mp.shape[0], scratch,
              2 + SCRATCH_BLOCKS, scratch + 4 * (2 + SCRATCH_BLOCKS), sw,
              smem_cap, base, ctypes.addressof(g))
    if grid is not None:
        grid[:] = list(g)
    m = int(buf[kn:kn + 2].view(torch.int64))
    return buf[:k * m].view(k, m)
