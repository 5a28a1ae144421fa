"""Containment removal + dense renumbering (reference ma_hit_contained,
hit.c:225-256), for the staged selection path.

Port of miniasm_tpu/select/contained.py.  Device part: classify every hit
with the final parameters and mark the contained reads (the hit_marks
kernel, K18).  Host part: propagate deletions into the name dictionary,
drop reads appearing in no hit (hit.c:24-36; K18's "used" marks), squeeze
ids (order-preserving); then, on the device, compact the trim table and
remap and compact the hits (the compact kernel, K16).
"""

from __future__ import annotations

import torch

from ..core import hit2arc as h2a
from ..core.hits import Hits, mark_unused
from ..utils import compact as kc
from ..utils.timers import log


def contained_marks(hits: Hits, sub: torch.Tensor, n_seq: int,
                    max_hang: int, int_frac: float,
                    min_ovlp: int) -> torch.Tensor:
    """Per-read containment deletion mask, (n_seq,) bool."""
    lens = (sub[1] - sub[0]).contiguous()
    return h2a.hit_marks(hits.cols, "contained", n_seq, lens, max_hang,
                         int_frac, min_ovlp).view(torch.bool)


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
    # order-preserving renumber (int32 -1 where dropped)
    mp = torch.from_numpy(d.squeeze()).to(dev)
    sub = kc.compact([sub[0], sub[1], sub_del.to(torch.int32)], mp >= 0)
    new = Hits(kc.compact(hits.cols, mp=mp))
    log("hit_contained", "%d sequences and %d hits remain after "
        "containment removal", d.n_seq, new.n)
    return new, sub
