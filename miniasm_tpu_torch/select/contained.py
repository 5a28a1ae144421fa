"""Containment removal + dense renumbering (reference ma_hit_contained,
hit.c:225-256), for the staged selection path.

Port of miniasm_tpu/select/contained.py.  Device part: classify every hit
with the final parameters (the hit2arc kernel, K6) and mark the contained
reads.  Host part: propagate deletions into the name dictionary, drop
reads appearing in no hit (hit.c:24-36), squeeze ids (order-preserving);
then remap and compact the hits on the device.
"""

from __future__ import annotations

import torch

from ..core import hit2arc as h2a
from ..core.hits import Hits, mark_unused
from ..utils.timers import log


def contained_marks(hits: Hits, sub: torch.Tensor, n_seq: int,
                    max_hang: int, int_frac: float,
                    min_ovlp: int) -> torch.Tensor:
    """Per-read containment deletion mask, (n_seq,) bool."""
    lens = (sub[1] - sub[0]).contiguous()
    r = h2a.hit2arc_rows(hits.cols, lens, max_hang, int_frac, min_ovlp)[0]
    mask = torch.zeros(n_seq, dtype=torch.bool, device=hits.cols.device)
    mask[hits.qid[r == h2a.MA_HT_QCONT].long()] = True
    mask[hits.tid[r == h2a.MA_HT_TCONT].long()] = True
    return mask


def hit_contained(opt, d, sub: torch.Tensor, hits: Hits):
    """Full pass.  Mutates `d` (squeeze); returns (hits', sub') with dense
    new ids."""
    mask = contained_marks(hits, sub, d.n_seq, opt.max_hang, opt.int_frac,
                           opt.min_ovlp)
    return apply_contained(d, sub, mask, hits)


def apply_contained(d, sub: torch.Tensor, cont_mask: torch.Tensor,
                    hits: Hits):
    """Host half of ma_hit_contained (hit.c:237-256): propagate deletions,
    drop unused reads, squeeze ids, remap + compact hits."""
    dev = hits.cols.device
    sub_del = (sub[2] != 0) | cont_mask
    # sub deletions -> dict deletions (hit.c:237-238)
    d.mark_deleted(sub_del.cpu().numpy())
    # reads appearing in no hit -> deleted (ma_hit_mark_unused)
    mark_unused(d, hits)
    mp = torch.from_numpy(d.squeeze()).to(dev)  # order-preserving renumber
    keep_read = mp >= 0
    sub = torch.stack([sub[0][keep_read], sub[1][keep_read],
                       sub_del[keep_read].to(torch.int32)])
    c = hits.cols
    qn, tn = mp[c[0].long()], mp[c[3].long()]
    keep = (qn >= 0) & (tn >= 0)
    new = Hits(torch.cat([qn[None], c[1:3], tn[None], c[4:]])[:, keep])
    log("hit_contained", "%d sequences and %d hits remain after "
        "containment removal", d.n_seq, new.n)
    return new, sub
