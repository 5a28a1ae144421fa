"""Containment removal + dense renumbering (reference ma_hit_contained,
hit.c:225-256), for the staged selection path.

Port of miniasm_tpu/select/contained.py.  Device part: classify every hit
with the final parameters and mark the contained reads and the reads in
use (hit.c:24-36), both in one launch of the hit_marks kernel, K18.  Host
part, after one copy of both marks: propagate deletions into the name
dictionary, drop reads appearing in no hit, squeeze ids
(order-preserving); then, on the device, compact the trim table and
remap and compact the hits (the compact kernel, K16).
"""

from __future__ import annotations

import torch

from ..core import hit2arc as h2a
from ..core.hits import Hits, mark_unused
from ..device import to_host
from ..utils import compact as kc
from ..utils.timers import log


def contained_marks(hits: Hits, sub: torch.Tensor, n_seq: int,
                    max_hang: int, int_frac: float,
                    min_ovlp: int) -> torch.Tensor:
    """The containment pass's per-read marks, (2, n_seq) uint8: row 0 the
    containment deletions, row 1 the reads some hit names."""
    lens = (sub[1] - sub[0]).contiguous()
    return h2a.hit_marks(hits.cols, "contained", n_seq, lens, max_hang,
                         int_frac, min_ovlp)


def hit_contained(opt, d, sub: torch.Tensor, hits: Hits):
    """Full pass.  Mutates `d` (squeeze); returns (hits', sub') with dense
    new ids."""
    marks = contained_marks(hits, sub, d.n_seq, opt.max_hang, opt.int_frac,
                            opt.min_ovlp)
    return apply_contained(d, sub, marks, hits)


def apply_contained(d, sub: torch.Tensor, marks: torch.Tensor,
                    hits: Hits):
    """Host half of ma_hit_contained (hit.c:237-256): propagate deletions,
    drop unused reads, squeeze ids, remap + compact hits.  marks: the
    (2, n_seq) uint8 rows of contained_marks; the trim table's deletions
    are or-ed into row 0 in place."""
    dev = hits.cols.device
    sub_del = marks[0]
    sub_del |= sub[2] != 0
    # one copy of both rows
    host = to_host(marks).numpy()
    # sub deletions -> dict deletions (hit.c:237-238)
    d.mark_deleted(host[0] != 0)
    # reads appearing in no hit -> deleted (ma_hit_mark_unused)
    mark_unused(d, host[1])
    # order-preserving renumber (int32 -1 where dropped)
    mp = torch.from_numpy(d.squeeze()).to(dev)
    sub = kc.compact([sub[0], sub[1], sub_del.to(torch.int32)], mp >= 0)
    new = Hits(kc.compact(hits.cols, mp=mp))
    log("hit_contained", "%d sequences and %d hits remain after "
        "containment removal", d.n_seq, new.n)
    return new, sub
