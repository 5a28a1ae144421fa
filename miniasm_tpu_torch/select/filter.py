"""Arc-classification hit filter + crude coverage estimate (reference
ma_hit_flt, hit.c:195-216), for the staged selection path.

Port of miniasm_tpu/select/filter.py.  Keeps hits that classify as proper
overlaps or containments under relaxed parameters (the caller passes
max_hang*1.5, min_ovlp*0.5; int_frac is the hardcoded 0.5 of hit.c:205)
and estimates global coverage for the log.  `hit_flt_sums` launches the
hit_flt kernel (K17, csrc/staged.cu) on CUDA tensors and runs
`hit_flt_plain` on CPU tensors: the classification, the keep byte, dp,
the int64 sum of the kept dp and each kept query's present byte, in one
launch.
"""

from __future__ import annotations

import torch

from ..core import hit2arc as h2a
from ..core.hits import Hits
from ..cuda import I32, I64, P, Kernel, ptr
from ..utils.u32 import as_u32

# the whole hit_flt program (miniasm_tpu/select/filter.py:16) and the dp
# sum and coverage set the pipeline takes from it (pipeline.py:120-122)
K_HIT_FLT = Kernel(
    "hit_flt", "staged.cu", "ma_hit_flt",
    [P, I64, P, I64, I32, I32, P, P, P, P],
    replaces="miniasm_tpu/select/filter.py:16")


def hit_flt_plain(cols, sub, max_hang: int, min_ovlp: int):
    """Plain PyTorch version of the hit_flt kernel (see `hit_flt_sums`)."""
    T = sub.shape[1]
    qi = cols[0].clamp(0, T - 1).long()
    ti = cols[3].clamp(0, T - 1).long()
    lens = sub[1] - sub[0]
    ql, tl = lens[qi], lens[ti]
    c = h2a.hit2arc(cols[0], cols[1], cols[2], cols[3], cols[4], cols[5],
                    cols[8] != 0, ql, tl, max_hang, 0.5, min_ovlp)
    r = c["r"]
    alive = (sub[2][qi] == 0) & (sub[2][ti] == 0)
    keep = alive & ((r >= 0) | (r == h2a.MA_HT_QCONT)
                    | (r == h2a.MA_HT_TCONT))
    dp = torch.where(r >= 0, r, torch.where(r == h2a.MA_HT_QCONT, ql, tl))
    dp = torch.where(keep, dp, 0)
    present = torch.zeros(T, dtype=torch.uint8, device=cols.device)
    present[qi[keep]] = 1
    return (keep.to(torch.uint8), dp, dp.to(torch.int64).sum().reshape(1),
            present)


def hit_flt_sums(cols, sub, max_hang: int, min_ovlp: int):
    """K17.  cols (9, n) int32 hits; sub (3, T) int32 trim tables [s, e,
    del].  Returns (keep (n,) uint8, dp (n,) int32 per-hit depth
    contribution, 0 where not kept, dp_sum (1,) int64, present (T,) uint8:
    1 for each read that is the query of a kept hit)."""
    if cols.device.type == "cpu":
        return hit_flt_plain(cols, sub, max_hang, min_ovlp)
    n, T = cols.shape[1], sub.shape[1]
    dev = cols.device
    if cols.dtype != torch.int32 or sub.dtype != torch.int32:
        raise TypeError("hit_flt: int32 hits and trim tables expected")
    if cols.shape[0] != 9 or sub.shape[0] != 3 or (n and T == 0):
        raise ValueError("hit_flt: shape mismatch")
    keep = torch.empty(n, dtype=torch.uint8, device=dev)
    dp = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return (keep, dp, torch.zeros(1, dtype=torch.int64, device=dev),
                torch.zeros(T, dtype=torch.uint8, device=dev))
    # the kernel's call zeroes the sum and the present bytes
    dp_sum = torch.empty(1, dtype=torch.int64, device=dev)
    present = torch.empty(T, dtype=torch.uint8, device=dev)
    K_HIT_FLT(ptr(cols), n, ptr(sub), T, int(max_hang), int(min_ovlp),
              ptr(keep), ptr(dp), ptr(dp_sum), ptr(present))
    return keep, dp, dp_sum, present


def hit_flt(hits: Hits, sub: torch.Tensor, max_hang: int, min_ovlp: int):
    """Returns (keep bool, dp int32 per-hit depth contribution) against
    the trim tables `sub` (3, T) [s, e, del]."""
    keep, dp, _, _ = hit_flt_sums(hits.cols, sub.contiguous(), max_hang,
                                  min_ovlp)
    return keep.view(torch.bool), dp


def flt_coverage(present: torch.Tensor, dp_sum: int,
                 sub: torch.Tensor) -> float:
    """Crude coverage = total depth / total length of the reads marked in
    `present` (the queries of the surviving hits, hit.c:209-212).
    Log-only in the reference."""
    tot_len = int(torch.where(present != 0, as_u32(sub[1]) - as_u32(sub[0]),
                              0).sum())
    return float(dp_sum) / tot_len if tot_len else 0.0
