"""The benchmark's read-overlap simulator, a frozen copy.

Copied from miniasm_tpu_torch/eval/simulate.py (simulate, paf_arrays) so
that a later change to the program cannot move the yardstick: long-read
intervals on a random genome with per-read orientations, and the
all-vs-all PAF a perfect overlapper would report, grouped by query as
minimap2 writes it.  The same seed gives the same bytes as that module's
write_paf.

`write_paf` here builds the lines as bytes with numpy, a chunk of lines
at a time, where the original formats each line with `%`: at 20 M lines
that saves most of a run's set-up.  The genome sequence is not drawn
into a string unless asked for (it is drawn after every other draw, so
the PAF does not depend on it).
"""

from __future__ import annotations

import numpy as np


def simulate(genome_len=200_000, coverage=20.0, mean_read=8000, sd_read=2000,
             min_read=1000, seed=42, circular=False, min_ovlp_emit=100,
             name_prefix="read", with_genome=False):
    """Returns a dict with names, gs, ge, ori, lens, order, and the genome
    string when `with_genome`."""
    rng = np.random.default_rng(seed)
    n_reads = int(genome_len * coverage / mean_read)
    lens = np.maximum(min_read, rng.normal(mean_read, sd_read, n_reads).astype(np.int64))
    if circular:
        starts = rng.integers(0, genome_len, n_reads)
    else:
        lens = np.minimum(lens, genome_len)
        starts = rng.integers(0, genome_len - lens + 1, n_reads)
    ori = rng.integers(0, 2, n_reads).astype(np.int8)
    gseq = None
    if with_genome:
        genome = rng.integers(0, 4, genome_len, dtype=np.int8)
        lut = np.frombuffer(b"ACGT", dtype=np.uint8)
        gseq = lut[genome.astype(np.uint8)].tobytes().decode("ascii")
    order = np.argsort(starts, kind="stable")
    names = ["%s%06d" % (name_prefix, i) for i in range(n_reads)]
    return {
        "names": names, "gs": starts, "ge": starts + lens, "ori": ori,
        "lens": lens, "genome": gseq, "order": order,
        "circular": circular, "genome_len": genome_len,
        "min_ovlp_emit": min_ovlp_emit,
    }


def paf_arrays(sim):
    """Every overlapping read pair (each unordered pair once, smaller sweep
    index as query) as parallel numpy arrays (qi, ql, qs, qe, rev, ti, tl,
    ts, te, ml), qi/ti indexing sim['names'], in the per-pair sweep's
    order; a circular genome appends the pairs across its origin."""
    gs, ge, ori = sim["gs"], sim["ge"], sim["ori"]
    lens = sim["lens"]
    order = np.asarray(sim["order"])
    min_emit = sim["min_ovlp_emit"]
    s_gs = gs[order]
    s_ge = ge[order]
    n = len(order)
    hi = np.searchsorted(s_gs, s_ge, side="left")
    hi = np.maximum(hi, np.arange(n) + 1)
    cnt = hi - np.arange(n) - 1
    tot = int(cnt.sum())
    oj = np.repeat(np.arange(n, dtype=np.int64), cnt)
    off = np.arange(tot, dtype=np.int64) - np.repeat(
        np.cumsum(cnt) - cnt, cnt)
    oi = oj + 1 + off
    s = np.maximum(s_gs[oi], s_gs[oj])
    e = np.minimum(s_ge[oi], s_ge[oj])
    keep = (e - s) >= min_emit
    oi, oj, s, e = oi[keep], oj[keep], s[keep], e[keep]
    sel = np.lexsort((oj, oi))
    oi, oj, s, e = oi[sel], oj[sel], s[sel], e[sel]
    qi, ti = order[oj], order[oi]

    def proj(idx, s, e):
        fwd = ori[idx] == 0
        ps = np.where(fwd, s - gs[idx], ge[idx] - e)
        pe = np.where(fwd, e - gs[idx], ge[idx] - s)
        return ps, pe

    qs, qe = proj(qi, s, e)
    ts, te = proj(ti, s, e)
    rev = (ori[qi] != ori[ti])
    out = dict(qi=qi, ql=lens[qi], qs=qs, qe=qe, rev=rev,
               ti=ti, tl=lens[ti], ts=ts, te=te, ml=e - s)

    if sim.get("circular"):
        # reads crossing the origin against shadows of low-start reads
        # shifted by +L, appended in (crosser, shadow) order
        L = sim["genome_len"]
        cross = np.flatnonzero(ge > L)
        maxov = int((ge - L).max()) if cross.size else 0
        low = np.flatnonzero(gs < maxov)
        if cross.size and low.size:
            ii, jj = np.meshgrid(cross, low, indexing="ij")
            ii, jj = ii.ravel(), jj.ravel()
            sgs, sge = gs[jj] + L, ge[jj] + L
            s2 = np.maximum(gs[ii], sgs)
            e2 = np.minimum(ge[ii], sge)
            keep2 = ((e2 - s2) >= min_emit) & (ii != jj)
            ii, jj, s2, e2 = ii[keep2], jj[keep2], s2[keep2], e2[keep2]
            sgs, sge = gs[jj] + L, ge[jj] + L
            q2s, q2e = proj(ii, s2, e2)
            fwd = ori[jj] == 0
            t2s = np.where(fwd, s2 - sgs, sge - e2)
            t2e = np.where(fwd, e2 - sgs, sge - s2)
            for k, v in zip(
                    ("qi", "ql", "qs", "qe", "rev", "ti", "tl", "ts", "te",
                     "ml"),
                    (ii, lens[ii], q2s, q2e, ori[ii] != ori[jj], jj,
                     lens[jj], t2s, t2e, e2 - s2)):
                out[k] = np.concatenate([out[k], v])
    return out


def grouped(a):
    """The pairs grouped by query, stably (minimap2 writes a query's
    records together, queries in read-file order)."""
    sel = np.argsort(a["qi"], kind="stable")
    return {k: v[sel] for k, v in a.items()}


def _digits(v: np.ndarray):
    """Decimal ASCII of non-negative values under 2**32: ((n, W) uint8
    digits, right-aligned, and the (n, W) mask of the digits printed)."""
    v = np.asarray(v)
    if v.size and (int(v.min()) < 0 or int(v.max()) >= 1 << 32):
        raise ValueError("a PAF column outside [0, 2**32)")
    W = max(1, len(str(int(v.max())))) if v.size else 1
    out = np.empty((W, v.size), dtype=np.uint8)
    x = v.astype(np.uint32)
    nd = np.ones(v.size, dtype=np.int64)
    for k in range(W - 1, -1, -1):
        q = x // 10
        out[k] = x - q * 10 + 48
        x = q
        if k:
            nd += v >= 10 ** (W - k)
    return out.T, np.arange(W)[None, :] >= (W - nd)[:, None]


def _lines(fields):
    """The bytes of n lines, each the fields in order.  A field is
    (kind, value): ("fix", (n, W) uint8 of one width), ("num", int64 values)
    or ("lit", bytes).  The fields are laid side by side in an (n, width)
    matrix, and the printed bytes taken from it row by row."""
    n = next(len(v) for k, v in fields if k != "lit")
    blocks, masks = [], []
    for kind, val in fields:
        if kind == "num":
            dig, keep = _digits(val)
            blocks.append(dig)
            masks.append(keep)
        elif kind == "fix":
            blocks.append(val)
            masks.append(np.ones(val.shape, dtype=bool))
        else:
            lit = np.frombuffer(val, dtype=np.uint8)
            blocks.append(np.broadcast_to(lit, (n, lit.size)))
            masks.append(np.ones((n, lit.size), dtype=bool))
    return np.concatenate(blocks, axis=1)[np.concatenate(masks, axis=1)]


def name_table(names) -> np.ndarray:
    """The names as an (n, W) uint8 table; all names have one width."""
    raw = np.asarray(names, dtype="S")
    W = raw.dtype.itemsize
    tab = np.frombuffer(raw.tobytes(), dtype=np.uint8).reshape(len(names), W)
    if (tab == 0).any():
        raise ValueError("read names of different widths")
    return tab


def write_paf(sim, path, a=None, chunk=1 << 18) -> int:
    """Write the query-grouped PAF of `sim` (or of the pair arrays `a`, as
    `grouped` orders them) to `path`: the bytes of
    miniasm_tpu_torch/eval/simulate.write_paf.  Returns the line count."""
    if a is None:
        a = grouped(paf_arrays(sim))
    names = name_table(sim["names"])
    cnt = len(a["qi"])
    strand = np.frombuffer(b"+-", dtype=np.uint8)
    tab = b"\t"
    with open(path, "wb") as f:
        for i0 in range(0, cnt, chunk):
            sl = slice(i0, min(i0 + chunk, cnt))
            ml = a["ml"][sl]
            buf = _lines([
                ("fix", names[a["qi"][sl]]), ("lit", tab),
                ("num", a["ql"][sl]), ("lit", tab),
                ("num", a["qs"][sl]), ("lit", tab),
                ("num", a["qe"][sl]), ("lit", tab),
                ("fix", strand[a["rev"][sl].astype(np.int64)][:, None]),
                ("lit", tab),
                ("fix", names[a["ti"][sl]]), ("lit", tab),
                ("num", a["tl"][sl]), ("lit", tab),
                ("num", a["ts"][sl]), ("lit", tab),
                ("num", a["te"][sl]), ("lit", tab),
                ("num", ml), ("lit", tab),
                ("num", ml), ("lit", b"\tcm:i:"),
                ("num", ml // 50), ("lit", b"\n")])
            f.write(buf.tobytes())
    return cnt
