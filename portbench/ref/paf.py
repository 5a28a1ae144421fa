"""PAF reading for the plain reference.

miniasm's reading of a PAF file (paf.c, hit.c:70-107): a line counts when
it has at least 10 tab-separated fields; each number is read as a uint32
from its leading digits; a line with 10 fields takes the block length of
the line before it.  A record is kept when qe - qs and te - ts (uint32)
are at least min_span and ml at least min_match, and only kept records
give their read names ids, in the order the names first appear, the
query's before the target's.  The length of a name's first appearance is
its length.

`read_paf` parses in C (native.c's pb_paf_read); `read_paf_numpy` is the
same reading in NumPy, the spec that the tests hold the C against.
"""

from __future__ import annotations

import gzip

import numpy as np

from . import native


def _read_raw(fn: str) -> bytes:
    with open(fn, "rb") as f:
        raw = f.read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return raw


def _u32(buf: np.ndarray, s: np.ndarray, e: np.ndarray) -> np.ndarray:
    """The uint32 value of the leading digits of each field [s, e): the
    C's v = v * 10 + digit, wrapping in uint32."""
    n = s.size
    v = np.zeros(n, dtype=np.uint32)
    go = np.ones(n, dtype=bool)
    L = e - s
    last = buf.size - 1
    for k in range(int(L.max()) if n else 0):
        d = buf[np.minimum(s + k, last)] - np.uint8(48)
        go &= (d <= 9) & (k < L)
        v = np.where(go, v * np.uint32(10) + d, v)
    return v.astype(np.int64)


def _names(buf: np.ndarray, s: np.ndarray, e: np.ndarray):
    """Each field [s, e) as a row of bytes, zero-padded to the longest."""
    ln = e - s
    W = max(int(ln.max()) if ln.size else 1, 1)
    k = np.arange(W)
    tab = buf[np.minimum(s[:, None] + k[None, :], buf.size - 1)]
    if (ln < W).any():
        tab[k[None, :] >= ln[:, None]] = 0
    return tab


def _columns(buf: np.ndarray):
    """The lines of `buf` that have 10 fields or more: their numeric
    columns (bl as read, with `has_bl` false where a line has 10 fields),
    the strand, and the query and target names as byte tables."""
    nl = np.flatnonzero(buf == 10)
    if buf.size and buf[-1] != 10:
        nl = np.append(nl, buf.size)
    ls = np.concatenate([[0], nl[:-1] + 1]) if nl.size else np.zeros(0, np.int64)
    le = nl
    nonempty = le > ls
    ls, le = ls[nonempty], le[nonempty]
    tabs = np.flatnonzero(buf == 9)
    t0 = np.searchsorted(tabs, ls)
    ntab = np.searchsorted(tabs, le) - t0
    ok = ntab >= 9
    ls, le, t0, ntab = ls[ok], le[ok], t0[ok], ntab[ok]
    ntab = np.minimum(ntab, 11)

    if ls.size and tabs.size == ls.size * 11 and (ntab == 11).all():
        # every line has 12 fields: the tabs as a table
        tt = tabs.reshape(ls.size, 11)

        def field(k):
            return (ls if k == 0 else tt[:, k - 1] + 1,
                    tt[:, k] if k < 11 else le)
    else:
        def field(k):
            s = ls if k == 0 else tabs[np.minimum(t0 + k - 1, tabs.size - 1)] + 1
            e = np.where(k < ntab, tabs[np.minimum(t0 + k, tabs.size - 1)], le)
            return s, e

    cols = {}
    for k, name in ((1, "ql"), (2, "qs"), (3, "qe"), (6, "tl"), (7, "ts"),
                    (8, "te"), (9, "ml"), (10, "bl")):
        cols[name] = _u32(buf, *field(k))
    cols["has_bl"] = ntab >= 10
    s4, e4 = field(4)
    cols["rev"] = ((e4 > s4) & (buf[np.minimum(s4, buf.size - 1)] == 45)
                   ).astype(np.int64)
    return cols, _names(buf, *field(0)), _names(buf, *field(5))


def read_paf(fn: str, min_span: int, min_match: int, intern: str = "order"):
    """The kept records of `fn` and the read dictionary, as
    read_paf_numpy gives them, parsed in C."""
    if intern not in ("order", "split"):
        raise ValueError("intern: order or split")
    cols, names, lens, n_lines = native.paf_read(
        _read_raw(fn), min_span, min_match, intern == "split")
    return dict(cols, names=names, lens=lens, n_lines=n_lines)


def read_paf_numpy(fn: str, min_span: int, min_match: int,
                   intern: str = "order"):
    """The kept records of `fn` and the read dictionary.  Returns a dict of
    int64 columns qid, qs, qe, tid, ts, te, ml, bl, rev; `names` (list of
    str) and `lens` (int64) of the reads by id; `n_lines`.
    `intern="split"` gives the ids in another order: the names of the
    second half of the kept records first, then those of the first half
    (the control of the benchmark's check; not miniasm's order)."""
    cols, qn, tn = _columns(np.frombuffer(_read_raw(fn), dtype=np.uint8))
    n_lines = int(cols["ql"].size)
    has_bl = cols.pop("has_bl")
    if not has_bl.all():
        # a 10-field line takes the block length of the line before it
        bl = cols["bl"]
        src = np.where(has_bl, np.arange(bl.size), -1)
        src = np.maximum.accumulate(src)
        cols["bl"] = np.where(src >= 0, bl[np.maximum(src, 0)], 0)
    m32 = 0xFFFFFFFF
    keep = (((cols["qe"] - cols["qs"]) & m32) >= min_span) & \
        (((cols["te"] - cols["ts"]) & m32) >= min_span) & \
        (cols["ml"] >= min_match)
    qn, tn = qn[keep], tn[keep]
    cols = {k: v[keep] for k, v in cols.items()}
    n = int(keep.sum())

    # ids by first appearance in the stream q0 t0 q1 t1 ...
    W = max(qn.shape[1], tn.shape[1])
    seq = np.zeros((2 * n, W), dtype=np.uint8)
    seq[0::2, :qn.shape[1]] = qn
    seq[1::2, :tn.shape[1]] = tn
    lens_seq = np.empty(2 * n, dtype=np.int64)
    lens_seq[0::2] = cols["ql"]
    lens_seq[1::2] = cols["tl"]
    # name identity on the columns that differ between names, as uint64
    # words (a single word when they are 8 bytes or fewer)
    vary = np.flatnonzero((seq != seq[:1]).any(axis=0)) if n else \
        np.zeros(0, np.int64)
    Wv = max(8, (vary.size + 7) // 8 * 8)
    packed = np.zeros((2 * n, Wv), dtype=np.uint8)
    packed[:, :vary.size] = seq[:, vary]
    words = packed.view(">u8").reshape(2 * n, Wv // 8)
    if words.shape[1] == 1:
        o = np.argsort(words[:, 0], kind="stable")
    else:
        o = np.lexsort(words.T[::-1]) if n else np.zeros(0, np.int64)
    sw = words[o]
    new = np.ones(2 * n, dtype=bool)
    if n:
        new[1:] = (sw[1:] != sw[:-1]).any(axis=1)
    grp = np.cumsum(new) - 1
    n_grp = int(grp[-1]) + 1 if n else 0
    # each name's first appearance: its smallest position in the stream
    apos = np.arange(2 * n, dtype=np.int64)
    if intern == "split":
        half = 2 * (n // 2)
        apos = np.where(apos >= half, apos - half, apos + 2 * n)
    starts = np.flatnonzero(new)
    best = np.minimum.reduceat(apos[o], starts) if n else apos[:0]
    order = np.argsort(best, kind="stable")
    rank = np.empty(n_grp, dtype=np.int64)
    rank[order] = np.arange(n_grp)
    ids = np.empty(2 * n, dtype=np.int64)
    ids[o] = rank[grp]
    first_at = np.empty(n_grp, dtype=np.int64)
    if intern == "split":
        first_at[rank] = np.where(best >= 2 * n, best - 2 * n, best + half)
    else:
        first_at[rank] = best
    lens = lens_seq[first_at]
    name_rows = seq[first_at]
    names = [bytes(r).rstrip(b"\0").decode("latin-1") for r in name_rows]
    out = {"qid": ids[0::2], "tid": ids[1::2]}
    for k in ("qs", "qe", "ts", "te", "ml", "bl", "rev"):
        out[k] = cols[k]
    out["names"] = names
    out["lens"] = lens
    out["n_lines"] = n_lines
    return out
