"""Coverage-sweep read trimming (reference ma_hit_sub, hit.c:109-160), for
the staged selection path.

Port of miniasm_tpu/select/subregion.py.  The reference walks each query's
hit group, builds (start<<1, end<<1|1) events, sorts them, and sweeps a
+-1 depth counter to find the first longest region with depth >= min_dp.
Here every hit puts its two events (pos*2 + is_end) in its query's
segment, and the `sweep` kernel of the select step (K2, csrc/select.cu)
buckets the whole file's events by read, sorts each read's and sweeps
them.  An event that fails the validity test (self match, identity, empty
clipped span) is keyed SKIP, which adds nothing to the depth; it still
marks its read as having hits as query (hit.c:117):
reads with such hits but no qualifying region are soft-deleted
(hit.c:152); reads with no hits as query keep {s=0, e=0, del=0}
(hit.c:115), whose zero-length interval kills their hits at the next cut.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.hits import Hits
from ..utils.timers import log
from ..utils.u32 import as_u32
from . import fused2


def hit_sub(hits: Hits, n_seq: int, min_dp: int, min_iden: float,
            end_clip: int) -> torch.Tensor:
    """Trim intervals of the `n_seq` reads: (3, n_seq) int32 [s, e, del]
    (s and e are the uint32 bit patterns).  The hits must be sorted by
    (qid, qs)."""
    dev = hits.cols.device
    if n_seq == 0:
        return torch.zeros((3, 0), dtype=torch.int32, device=dev)
    qid, tid = hits.qid, hits.tid
    # event construction (hit.c:123-131); the identity test is one float32
    # multiply and compare on the uint32 counts
    frac = torch.tensor(np.float32(min_iden), dtype=torch.float32, device=dev)
    ml = as_u32(hits.ml).to(torch.float32)
    bl = as_u32(hits.bl).to(torch.float32)
    evs = hits.qs + end_clip
    eve = hits.qe - end_clip
    valid = (tid != qid) & ~(ml < bl * frac) & (eve > evs)
    skip = fused2.SKIP
    key = torch.cat([torch.where(valid, evs * 2, skip),
                     torch.where(valid, eve * 2 + 1, skip)])
    out = fused2.sweep_events(torch.cat([qid, qid]), key, n_seq, min_dp,
                              end_clip)
    return out[:3]


def log_sub(sub: torch.Tensor) -> None:
    n_remained = int((as_u32(sub[1]) > as_u32(sub[0])).sum())
    log("hit_sub", "%d query sequences remain after sub", n_remained)
