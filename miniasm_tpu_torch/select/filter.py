"""Arc-classification hit filter + crude coverage estimate (reference
ma_hit_flt, hit.c:195-216), for the staged selection path.

Port of miniasm_tpu/select/filter.py.  Keeps hits that classify as proper
overlaps or containments under relaxed parameters (the caller passes
max_hang*1.5, min_ovlp*0.5; int_frac is the hardcoded 0.5 of hit.c:205)
and estimates global coverage for the log.  The classification is the
hit2arc kernel (K6, core/hit2arc.py); the masks are torch ops.
"""

from __future__ import annotations

import torch

from ..core import hit2arc as h2a
from ..core.hits import Hits
from ..utils.u32 import as_u32


def hit_flt(hits: Hits, sub: torch.Tensor, max_hang: int, min_ovlp: int):
    """Returns (keep bool, dp int32 per-hit depth contribution) against
    the trim tables `sub` (3, T) [s, e, del]."""
    lens = (sub[1] - sub[0]).contiguous()
    r = h2a.hit2arc_rows(hits.cols, lens, max_hang, 0.5, min_ovlp)[0]
    qi, ti = hits.qid.long(), hits.tid.long()
    ql, tl = lens[qi], lens[ti]
    alive = (sub[2][qi] == 0) & (sub[2][ti] == 0)
    keep = alive & ((r >= 0) | (r == h2a.MA_HT_QCONT)
                    | (r == h2a.MA_HT_TCONT))
    dp = torch.where(r >= 0, r, torch.where(r == h2a.MA_HT_QCONT, ql, tl))
    return keep, torch.where(keep, dp, 0)


def flt_coverage(kept_qid: torch.Tensor, dp_sum: int,
                 sub: torch.Tensor) -> float:
    """Crude coverage = total depth / total length of queries present in the
    surviving hits (hit.c:209-212).  Log-only in the reference."""
    if kept_qid.numel() == 0:
        return 0.0
    present = torch.zeros(sub.shape[1], dtype=torch.bool,
                          device=kept_qid.device)
    present[kept_qid.long()] = True
    tot_len = int(torch.where(present, as_u32(sub[1]) - as_u32(sub[0]),
                              0).sum())
    return float(dp_sum) / tot_len if tot_len else 0.0
