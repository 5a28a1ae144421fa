"""PAF loading into structure-of-array columns + interned read ids, for
the staged selection path (the main path streams through pafmt.cpp).

Semantics of the reference's scalar path (paf.c:34-67 parsing,
hit.c:70-107 filter+intern), kept exactly:

  - a line is parsed from its first 11 tab fields (qn ql qs qe strand tn tl
    ts te ml bl); lines with <10 separators are skipped (paf.c:55);
  - record filter: qe-qs < min_span or te-ts < min_span or ml < min_match
    drops the line BEFORE interning (hit.c:85) -- so id order is the
    first-appearance order of names on *surviving* lines, qn before tn
    (hit.c:88-90).  This order is load-bearing for output parity.

The parse is the native C++ tokenizer (io/native/pafread.cpp); a failed
build raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .seqdict import SeqDict


@dataclasses.dataclass
class PafLoad:
    """Filtered PAF records with interned ids, plus the id dictionary."""

    qid: np.ndarray  # int32
    qs: np.ndarray   # uint32
    qe: np.ndarray   # uint32
    tid: np.ndarray  # int32
    ts: np.ndarray   # uint32
    te: np.ndarray   # uint32
    ml: np.ndarray   # uint32
    bl: np.ndarray   # uint32
    rev: np.ndarray  # uint8 (0/1)
    d: SeqDict
    n_lines: int     # total PAF lines seen

    @property
    def n(self) -> int:
        return len(self.qid)


def load_paf(fn: str, min_span: int, min_match: int) -> PafLoad:
    """Load + filter + intern a PAF file (reference ma_hit_read's read loop,
    hit.c:82-99, minus the hit mirroring, which core/hits.py does)."""
    from .native.pafload import load_paf_native

    return load_paf_native(fn, min_span, min_match)
