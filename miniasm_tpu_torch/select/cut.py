"""Rewrite hit coordinates into trimmed read frames (reference ma_hit_cut,
hit.c:162-193), for the staged selection path.

Port of miniasm_tpu/select/cut.py.  The reference's arithmetic mixes int
and uint32; clamp comparisons happen in the unsigned domain (a negative
intermediate compares as a huge unsigned and loses the min / wins the
max).  This is reproduced bit-exactly: projections in wrapping int32,
all four clamps on the uint32 value, the span check on the wrapped int32
difference (hit.c:185).

`hit_cut` launches the K5 kernel (csrc/staged.cu) on CUDA tensors and runs
`hit_cut_plain` on CPU tensors.
"""

from __future__ import annotations

import torch

from ..core.hits import Hits
from ..cuda import I32, I64, P, Kernel, ptr
from ..utils import compact as kc
from ..utils.u32 import as_i32, as_u32

K_HIT_CUT = Kernel(
    "hit_cut", "staged.cu", "ma_hit_cut", [P, I64, P, I64, I32, P, P],
    replaces="miniasm_tpu/select/cut.py:16")


def cut_project(qs0, qe0, ts0, te0, rev, rq_s, rq_e, rt_s, rt_e):
    """The first half of ma_hit_cut (hit.c:170-180): the strand-aware
    projection of the partner read's trim onto int32 hit coordinates, with
    signed compares (cut_project of csrc/common.cuh).  The clamp that
    follows differs between K1 (select/fused2.py) and K5 (`hit_cut`)."""
    w = torch.where
    qs1 = w(rev, w(te0 < rt_e, qs0, qs0 + (te0 - rt_e)),
            w(ts0 > rt_s, qs0, qs0 + (rt_s - ts0)))
    qe1 = w(rev, w(ts0 > rt_s, qe0, qe0 - (rt_s - ts0)),
            w(te0 < rt_e, qe0, qe0 - (te0 - rt_e)))
    ts1 = w(rev, w(qe0 < rq_e, ts0, ts0 + (qe0 - rq_e)),
            w(qs0 > rq_s, ts0, ts0 + (rq_s - qs0)))
    te1 = w(rev, w(qs0 > rq_s, te0, te0 - (rq_s - qs0)),
            w(qe0 < rq_e, te0, te0 - (qe0 - rq_e)))
    return qs1, qe1, ts1, te1


def hit_cut_plain(cols, sub, min_span: int):
    """Plain PyTorch version of the hit_cut kernel (see `hit_cut`)."""
    T = sub.shape[1]
    qi = cols[0].clamp(0, T - 1).long()
    ti = cols[3].clamp(0, T - 1).long()
    rq_s, rq_e = sub[0][qi], sub[1][qi]
    rt_s, rt_e = sub[0][ti], sub[1][ti]
    alive = (sub[2][qi] == 0) & (sub[2][ti] == 0)
    qs1, qe1, ts1, te1 = cut_project(cols[1], cols[2], cols[4], cols[5],
                                     cols[8] != 0, rq_s, rq_e, rt_s, rt_e)
    # unsigned clamp to the trim interval then rebase (hit.c:181-184)
    uqs, uqe, uts, ute = as_u32(rq_s), as_u32(rq_e), as_u32(rt_s), as_u32(rt_e)
    qs2 = as_i32(torch.maximum(as_u32(qs1), uqs) - uqs)
    qe2 = as_i32(torch.minimum(as_u32(qe1), uqe) - uqs)
    ts2 = as_i32(torch.maximum(as_u32(ts1), uts) - uts)
    te2 = as_i32(torch.minimum(as_u32(te1), ute) - uts)
    keep = alive & (qe2 - qs2 >= min_span) & (te2 - ts2 >= min_span)
    return torch.stack([qs2, qe2, ts2, te2]), keep


def hit_cut(cols, sub, min_span: int):
    """K5.  cols (9, n) int32 hits [qid qs qe tid ts te ml bl rev]; sub
    (3, T) int32 trim tables [s, e, del] (s and e as uint32 bit patterns).
    Returns ((4, n) int32 cut [qs qe ts te], (n,) bool keep)."""
    if cols.device.type == "cpu":
        return hit_cut_plain(cols, sub, min_span)
    n, T = cols.shape[1], sub.shape[1]
    if cols.dtype != torch.int32 or sub.dtype != torch.int32:
        raise TypeError("hit_cut: int32 hits and trim tables expected")
    if cols.shape[0] != 9 or sub.shape[0] != 3 or (n and T == 0):
        raise ValueError("hit_cut: shape mismatch")
    out = torch.empty((4, n), dtype=torch.int32, device=cols.device)
    keep = torch.empty(n, dtype=torch.bool, device=cols.device)
    if n:
        K_HIT_CUT(ptr(cols), n, ptr(sub), T, int(min_span), ptr(out),
                  ptr(keep))
    return out, keep


def apply_cut(hits: Hits, sub, min_span: int) -> Hits:
    """Cut every hit against the trim tables `sub` and keep the survivors,
    in hit order (the staged path's _apply_cut, pipeline.py:41-47): K5's
    keep byte and coordinates feed K16, which composes the cut columns
    (the coordinates for rows 1, 2, 4, 5) as it compacts them."""
    coords, keep = hit_cut(hits.cols, sub.contiguous(), min_span)
    c = hits.cols
    return Hits(kc.compact([c[0], coords[0], coords[1], c[3], coords[2],
                            coords[3], c[6], c[7], c[8]], keep))
