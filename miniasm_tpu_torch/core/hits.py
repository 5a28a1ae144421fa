"""Device-resident hit store of the staged selection path.

The reference keeps hits as a heap array of 32-byte packed structs sorted by
a u64 radix key qns=(qid<<32|qstart) (ma_hit_t, miniasm.h:29-34; sort
hit.c:12-22).  Here the hits are one (9, n) int32 tensor on the device,
rows [qid qs qe tid ts te ml bl rev]; the uint32 columns (qs qe ts te ml
bl) are held as their int32 bit patterns.  Passes compact it with the
compact kernel (K16, utils/compact.py), which keeps hit order.

Construction order parity (reference hit.c:82-99): for each surviving PAF
record, the forward hit is appended, then -- when bi_dir and qid != tid --
its mirror (q and t swapped): an interleave + compaction on the host, then
the reference's exact radix permutation, then one upload.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..io.paf import PafLoad
from ..utils import compact as kc
from ..utils.timers import log

COLS = ("qid", "qs", "qe", "tid", "ts", "te", "ml", "bl", "rev")


@dataclasses.dataclass
class Hits:
    """(9, n) int32 hit columns, rows named by COLS (each row is also an
    attribute: `hits.qid` is `hits.cols[0]`)."""

    cols: torch.Tensor

    @property
    def n(self) -> int:
        return self.cols.shape[1]

    def take(self, mask: torch.Tensor) -> "Hits":
        """The hits where the bool or uint8 `mask` is set, in hit order
        (K16)."""
        return Hits(kc.compact(self.cols, mask))

    def numpy(self) -> dict:
        """Host columns with the JAX package's dtypes (int32 ids, uint32
        coordinates and counts, uint8 strand)."""
        c = self.cols.cpu().numpy()
        out = {k: c[i].view(np.uint32) for i, k in enumerate(COLS)}
        out["qid"], out["tid"] = c[0], c[3]
        out["rev"] = c[8].astype(np.uint8)
        return out


for _i, _name in enumerate(COLS):
    setattr(Hits, _name, property(lambda self, i=_i: self.cols[i]))


def build_hits(load: PafLoad, bi_dir: bool = True,
               device: torch.device = torch.device("cpu")) -> Hits:
    """Mirror + sort (reference hit.c:92-104) on the host, then one upload
    to `device`."""
    n = load.n
    src = [load.qid, load.qs, load.qe, load.tid, load.ts, load.te,
           load.ml, load.bl, load.rev]
    if not bi_dir:
        mat = np.empty((9, n), dtype=np.int32)
        for i, c in enumerate(src):
            mat[i] = c.astype(np.uint32).view(np.int32)
    else:
        # interleave fwd/mirror, keep mirror slots only when qid != tid
        keep = np.ones(2 * n, dtype=bool)
        keep[1::2] = load.qid != load.tid
        mirror = [load.tid, load.ts, load.te, load.qid, load.qs, load.qe,
                  load.ml, load.bl, load.rev]
        mat = np.empty((9, 2 * n), dtype=np.int32)
        for i, (a, b) in enumerate(zip(src, mirror)):
            mat[i, 0::2] = a.astype(np.uint32).view(np.int32)
            mat[i, 1::2] = b.astype(np.uint32).view(np.int32)
        mat = mat[:, keep]
    tot_len = int(np.sum(load.d.lens_array(), dtype=np.uint64))
    log("hit_read", "read %d hits; stored %d hits and %d sequences (%d bp)",
        load.n_lines, mat.shape[1], load.d.n_seq, tot_len)
    t = torch.from_numpy(np.ascontiguousarray(sort_hits(mat)))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return Hits(t)


def sort_hits(mat: np.ndarray) -> np.ndarray:
    """Sort the (9, n) host columns by the reference's radix key
    qns = qid<<32|qs (hit.c:12-13) with the reference's EXACT (unstable)
    tie permutation -- the in-place MSD radix of ksort.h is not stable and
    its tie order leaks into output order (see utils/exact_sort.py)."""
    from ..utils.exact_sort import radix_argsort

    key = ((mat[0].astype(np.uint64) << np.uint64(32))
           | mat[1].view(np.uint32).astype(np.uint64))
    return mat[:, radix_argsort(key)]


def mark_unused(d, used) -> None:
    """Mark reads that appear in no surviving hit as deleted (reference
    ma_hit_mark_unused, hit.c:24-36).  used: the (n_seq,) host row of the
    containment pass's marks that names the reads of some hit (row 1 of
    select/contained.py contained_marks, K18)."""
    d.mark_deleted(np.asarray(used) == 0)
