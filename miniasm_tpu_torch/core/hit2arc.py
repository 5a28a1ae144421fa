"""Vectorized hit -> arc classification (the geometric core).

PyTorch version of the reference's scalar ma_hit2arc (miniasm.h:86-104;
Algorithm 5 of the paper) over hit columns.  Return code per hit:

  l >= 0            : proper overlap; arc fields (u, v, l, ol) are valid
  MA_HT_INT   (-1)  : internal match
  MA_HT_QCONT (-2)  : query contained in target
  MA_HT_TCONT (-3)  : target contained in query
  MA_HT_SHORT_OVLP (-4): overlap too short

Integer columns are int32 and wrap like the reference's 32-bit arithmetic;
the int_frac test is one float32 multiply and compare (miniasm.h:94), with
no promotion to float64.  The select kernel K1 (csrc/select.cu) computes
the same function per row; `hit2arc` is its plain version.

`hit2arc_tail` is K6 (csrc/staged.cu): the graft entry's forward step
after K5 in one launch (the read lengths from the trim table, hit2arc,
`good` and `sub_del`); `hit2arc_tail_plain` is its plain version.
`hit2arc_rows_plain` is the same function over the staged path's (9, n)
hit matrix with the read lengths gathered from a table.  `hit_marks` is
K18 (the same source): hit2arc with the per-read byte marks the staged
path takes from it (the containment pass's contained reads and reads in
use, in one launch; the string graph's deletions and arc rows),
`hit_marks_plain` its plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..cuda import F32, I32, I64, P, Kernel, ptr

MA_HT_INT = -1
MA_HT_QCONT = -2
MA_HT_TCONT = -3
MA_HT_SHORT_OVLP = -4


def hit2arc(qid, qs, qe, tid, ts, te, rev, ql, tl,
            max_hang: int, int_frac: float, min_ovlp: int) -> dict:
    """Classify hits.  Every argument but the three parameters is a 1-D
    tensor on one device (rev 0/1).  Returns int32 columns r, u, v, l, ol
    (see the module docstring)."""
    i32 = torch.int32
    qid, qs, qe, tid, ts, te, ql, tl = [
        x.to(i32) for x in (qid, qs, qe, tid, ts, te, ql, tl)]
    rev = rev.to(torch.bool)

    tl5 = torch.where(rev, tl - te, ts)     # 5'-end target overhang
    tl3 = torch.where(rev, ts, tl - te)     # 3'-end
    qh5 = qs
    qh3 = ql - qe
    ext5 = torch.minimum(qh5, tl5)
    ext3 = torch.minimum(qh3, tl3)

    span = qe - qs
    tot = span + ext5 + ext3
    frac = torch.tensor(np.float32(int_frac), dtype=torch.float32,
                        device=qs.device)
    internal = ((ext5 > max_hang) | (ext3 > max_hang)
                | (span.to(torch.float32) < tot.to(torch.float32) * frac))
    qcont = (qh5 <= tl5) & (qh3 <= tl3)
    tcont = (qh5 >= tl5) & (qh3 >= tl3)

    from5 = qh5 > tl5
    rev_i = rev.to(i32)
    u_dir = (~from5).to(i32)
    v_dir = torch.where(from5, rev_i, 1 - rev_i)
    l = torch.where(from5, qh5 - tl5, qh3 - tl3)

    short = (tot < min_ovlp) | ((te - ts) + ext5 + ext3 < min_ovlp)

    r = l
    r = torch.where(short, MA_HT_SHORT_OVLP, r)
    # containment tests precede the short test in the reference control flow
    r = torch.where(tcont & ~qcont, MA_HT_TCONT, r)
    r = torch.where(qcont, MA_HT_QCONT, r)
    r = torch.where(internal, MA_HT_INT, r).to(i32)

    u = (qid << 1) | u_dir
    v = (tid << 1) | v_dir
    ol = ql - l
    return {"r": r, "u": u, "v": v, "l": l, "ol": ol}


def hit2arc_rows_plain(cols, lens, max_hang: int, int_frac: float,
                       min_ovlp: int) -> torch.Tensor:
    """`hit2arc` over the staged (9, n) hit matrix with ql, tl gathered
    from `lens` (indices clamped), as (5, n) int32 [r u v l ol]: the
    classification K17 and K18 (csrc/staged.cu) make per hit."""
    T = lens.shape[0]
    qid, tid = cols[0], cols[3]
    c = hit2arc(qid, cols[1], cols[2], tid, cols[4], cols[5], cols[8] != 0,
                lens[qid.clamp(0, T - 1).long()],
                lens[tid.clamp(0, T - 1).long()],
                max_hang, int_frac, min_ovlp)
    return torch.stack([c[k] for k in ("r", "u", "v", "l", "ol")])


# the hit2arc program (miniasm_tpu/core/hit2arc.py:28) as the graft
# entry's forward step calls it (__graft_entry__.py:60-65), with the
# lengths before it and good and sub_del after it
K_HIT2ARC = Kernel(
    "hit2arc", "staged.cu", "ma_hit2arc",
    [P, I64, I64, P, P, P, I64, I32, F32, I32, P, P, P],
    replaces="miniasm_tpu/core/hit2arc.py:28")


def jnp_index(ids, T: int) -> torch.Tensor:
    """ids as indices of a length-T table, as jnp's gather x[ids] takes
    them: a negative id counts from the end, then clamped to [0, T)."""
    return torch.where(ids < 0, ids + T, ids).clamp(0, T - 1).long()


def hit2arc_tail_plain(colmat, coords, keep, sub, max_hang: int,
                       int_frac: float, min_ovlp: int):
    """Plain PyTorch version of the hit2arc kernel (see `hit2arc_tail`)."""
    T = sub.shape[1]
    slen = sub[1] - sub[0]
    qid, tid = colmat[0], colmat[3]
    c = hit2arc(qid, coords[0], coords[1], tid, coords[2], coords[3],
                colmat[8] != 0, slen[jnp_index(qid, T)],
                slen[jnp_index(tid, T)], max_hang, int_frac, min_ovlp)
    arcs = torch.stack([c[k] for k in ("r", "u", "v", "l", "ol")])
    return arcs, keep & (colmat[9] != 0) & (arcs[0] >= 0), sub[2] != 0


def hit2arc_tail(colmat, coords, keep, sub, max_hang: int, int_frac: float,
                 min_ovlp: int):
    """K6.  colmat the entry's (10, n) int32 columns [qid qs qe tid ts te
    ml bl rev valid] (any row stride); coords (4, n) int32 [qs qe ts te]
    and keep (n,) bool from K5; sub (3, T) int32 trim tables [s e del]
    (s and e as uint32 bit patterns).  hit2arc of the cut columns against
    the trimmed lengths e - s (a wrapping int32 difference; a read id
    taken as `jnp_index` takes it).  Returns ((5, n) int32 [r u v l ol],
    (n,) bool good = keep & valid & r >= 0, (T,) bool sub_del = del != 0)."""
    if colmat.device.type == "cpu":
        return hit2arc_tail_plain(colmat, coords, keep, sub, max_hang,
                                  int_frac, min_ovlp)
    n, T = colmat.shape[1], sub.shape[1]
    if (colmat.dtype != torch.int32 or coords.dtype != torch.int32
            or sub.dtype != torch.int32 or keep.dtype != torch.bool):
        raise TypeError("hit2arc_tail: int32 columns, coordinates and trim "
                        "tables and a bool keep expected")
    if (colmat.shape[0] != 10 or (n > 1 and colmat.stride(1) != 1)
            or coords.shape != (4, n) or keep.shape != (n,)
            or sub.shape[0] != 3 or (n and T == 0)):
        raise ValueError("hit2arc_tail: shape mismatch")
    if not colmat.is_cuda:
        raise ValueError("expected a CUDA tensor, got %s" % colmat.device)
    dev = colmat.device
    arcs = torch.empty((5, n), dtype=torch.int32, device=dev)
    good = torch.empty(n, dtype=torch.bool, device=dev)
    sub_del = torch.empty(T, dtype=torch.bool, device=dev)
    if n or T:
        K_HIT2ARC(colmat.data_ptr(), colmat.stride(0), n, ptr(coords),
                  ptr(keep), ptr(sub), T, int(max_hang),
                  float(np.float32(int_frac)), int(min_ovlp), ptr(arcs),
                  ptr(good), ptr(sub_del))
    return arcs, good, sub_del


# hit2arc with the per-read marks of select/contained.py:19
# contained_marks and core/hits.py:106 mark_unused ("contained", one launch
# for both) and of graph/asg.py:160-190 in graph_from_hits ("sg")
K_HIT_MARKS = Kernel(
    "hit_marks", "staged.cu", "ma_hit_marks",
    [P, I64, P, I64, I32, F32, I32, I32, P, P, P, P],
    replaces="miniasm_tpu/select/contained.py:19")
MARK_MODES = ("contained", "sg")


def hit_marks_plain(cols, mode: str, T: int, lens, max_hang: int = 0,
                    int_frac: float = 0.0, min_ovlp: int = 0):
    """Plain PyTorch version of the hit_marks kernel (see `hit_marks`)."""
    qi = cols[0].clamp(0, T - 1).long()
    ti = cols[3].clamp(0, T - 1).long()
    arc = hit2arc_rows_plain(cols, lens, max_hang, int_frac, min_ovlp)
    r = arc[0]
    if mode == "contained":
        marks = torch.zeros((2, T), dtype=torch.uint8, device=cols.device)
        marks[0, qi[r == MA_HT_QCONT]] = 1
        marks[0, ti[r == MA_HT_TCONT]] = 1
        marks[1, qi] = 1
        marks[1, ti] = 1
        return marks
    mark = torch.zeros(T, dtype=torch.uint8, device=cols.device)
    self_ = cols[0] == cols[3]
    pal = ((r >= 0) & self_ & (cols[1] == cols[4]) & (cols[2] == cols[5])
           & (cols[8] != 0))
    mark[qi[pal | (r == MA_HT_QCONT)]] = 1
    return mark, ((r >= 0) & ~self_).to(torch.uint8), arc[1:].contiguous()


def hit_marks(cols, mode: str, T: int, lens, max_hang: int = 0,
              int_frac: float = 0.0, min_ovlp: int = 0, *, grid=None):
    """K18.  cols (9, n) int32 hits; mode one of MARK_MODES; T the reads;
    lens (T,) int32 per-read lengths; hit2arc at max_hang, int_frac,
    min_ovlp.  "contained" returns the containment pass's (2, T) uint8
    marks in one launch: row 0 the query of each QCONT hit and the target
    of each TCONT hit, row 1 both reads of every hit (the reads in use).
    "sg" returns the (T,) uint8 marks of the query of each QCONT hit and
    of each exact reverse self-palindrome, the (n,) uint8 arc-row keep (an
    arc, not a self match) and the (4, n) int32 arc columns [u v l ol].
    grid: a list that, when given, receives the contained launch's
    [blocks, hits a block at most, shared memory bytes a block (0: the
    marks go straight to device memory, past 196,608 reads)]."""
    if mode not in MARK_MODES:
        raise ValueError("hit_marks: mode must be one of %s" % (MARK_MODES,))
    if cols.device.type == "cpu":
        return hit_marks_plain(cols, mode, T, lens, max_hang, int_frac,
                               min_ovlp)
    n = cols.shape[1]
    dev = cols.device
    if cols.dtype != torch.int32 or cols.shape[0] != 9:
        raise TypeError("hit_marks: (9, n) int32 hits expected")
    if lens is None or lens.dtype != torch.int32 or lens.shape != (T,):
        raise ValueError("hit_marks: (T,) int32 lengths expected")
    if T <= 0 and n:
        raise ValueError("hit_marks: hits without reads")
    sg = mode == "sg"
    # the kernel's call zeroes the marks; without hits there is no call
    mark = (torch.empty if n else torch.zeros)(
        T if sg else (2, T), dtype=torch.uint8, device=dev)
    keep = torch.empty(n, dtype=torch.uint8, device=dev) if sg else None
    arcs = torch.empty((4, n), dtype=torch.int32, device=dev) if sg else None
    info = (ctypes.c_int64 * 3)()
    if n:
        K_HIT_MARKS(ptr(cols), n, ptr(lens), T, int(max_hang),
                    float(np.float32(int_frac)), int(min_ovlp),
                    MARK_MODES.index(mode), ptr(mark),
                    ptr(keep) if sg else None, ptr(arcs) if sg else None,
                    ctypes.addressof(info))
    if grid is not None:
        grid[:] = list(info)
    return (mark, keep, arcs) if sg else mark
