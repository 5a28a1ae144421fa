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
no promotion to float64.  The select kernel (csrc/select.cu) computes the
same function per row; this is its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

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
