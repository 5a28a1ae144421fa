"""Synthetic long-read overlap simulator.

The port's copy of miniasm_tpu/eval/simulate.py: long-read intervals on a
random genome with per-read orientations, the all-vs-all PAF a perfect
overlapper would produce, and the reads FASTA.  The same seed gives the
same PAF and FASTA bytes as the JAX package's simulator.  chip_smoke.py
makes its data with it, so the smoke run needs no download and no JAX.

Coordinates follow the PAF convention exactly: query/target starts are on
the read's forward strand; strand '-' when the two reads come from opposite
genome strands (PAF.md in the reference).
"""

from __future__ import annotations

import numpy as np


def revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def simulate(genome_len=200_000, coverage=20.0, mean_read=8000, sd_read=2000,
             min_read=1000, seed=42, circular=False, min_ovlp_emit=100,
             name_prefix="read"):
    """Returns dict with: names, gs, ge, ori, lens, genome (str), order."""
    rng = np.random.default_rng(seed)
    n_reads = int(genome_len * coverage / mean_read)
    lens = np.maximum(min_read, rng.normal(mean_read, sd_read, n_reads).astype(np.int64))
    if circular:
        starts = rng.integers(0, genome_len, n_reads)
    else:
        lens = np.minimum(lens, genome_len)
        starts = rng.integers(0, genome_len - lens + 1, n_reads)
    ori = rng.integers(0, 2, n_reads).astype(np.int8)
    # drawn after every other draw, so the PAF does not depend on it
    genome = rng.integers(0, 4, genome_len, dtype=np.int8)
    if genome_len <= 500_000_000:
        lut = np.frombuffer(b"ACGT", dtype=np.uint8)
        gseq = lut[genome.astype(np.uint8)].tobytes().decode("ascii")
    else:
        gseq = None
    order = np.argsort(starts, kind="stable")
    names = ["%s%06d" % (name_prefix, i) for i in range(n_reads)]
    return {
        "names": names, "gs": starts, "ge": starts + lens, "ori": ori,
        "lens": lens, "genome": gseq, "order": order,
        "circular": circular, "genome_len": genome_len,
        "min_ovlp_emit": min_ovlp_emit,
    }


def _proj(gs, ge, ori, s, e):
    """Project genome interval [s,e) onto a read's forward-strand coords."""
    if ori == 0:
        return s - gs, e - gs
    return ge - e, ge - s


def paf_records(sim):
    """Yield PAF tuples for every overlapping read pair (each unordered pair
    once, smaller sweep index as query)."""
    gs, ge, ori = sim["gs"], sim["ge"], sim["ori"]
    names, lens = sim["names"], sim["lens"]
    order = sim["order"]
    min_emit = sim["min_ovlp_emit"]
    n = len(order)
    active: list[int] = []
    for oi in range(n):
        i = order[oi]
        new_active = []
        for j in active:
            if ge[j] > gs[i]:
                new_active.append(j)
        active = new_active
        for j in active:
            s = max(gs[i], gs[j])
            e = min(ge[i], ge[j])
            if e - s < min_emit:
                continue
            qs, qe = _proj(gs[j], ge[j], ori[j], s, e)
            ts, te = _proj(gs[i], ge[i], ori[i], s, e)
            rev = "-" if ori[i] != ori[j] else "+"
            ml = bl = e - s
            yield (names[j], int(lens[j]), int(qs), int(qe), rev,
                   names[i], int(lens[i]), int(ts), int(te), int(ml), int(bl))
        active.append(i)


def paf_arrays(sim):
    """Every overlapping read pair (each unordered pair once, smaller sweep
    index as query) as parallel numpy arrays (qi, qs, qe, rev, ti, ts, te,
    ml) where qi/ti index sim['names'], in the per-pair sweep's order."""
    gs, ge, ori = sim["gs"], sim["ge"], sim["ori"]
    lens = sim["lens"]
    order = np.asarray(sim["order"])
    min_emit = sim["min_ovlp_emit"]
    s_gs = gs[order]          # sorted starts (stable, ties in read order)
    s_ge = ge[order]
    n = len(order)
    # pair (oj, oi), oj < oi, with gs_sorted[oi] < ge_sorted[oj]: for each
    # query oj the candidate targets are the contiguous range (oj, hi_j)
    # because starts are sorted; emission order is (oi asc, oj asc) — the
    # sweep emits, at step oi, all surviving actives in insertion order.
    hi = np.searchsorted(s_gs, s_ge, side="left")
    hi = np.maximum(hi, np.arange(n) + 1)
    cnt = hi - np.arange(n) - 1
    tot = int(cnt.sum())
    oj = np.repeat(np.arange(n, dtype=np.int64), cnt)
    # oi = oj + 1 .. hi_j - 1 per block
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
        # wrap-around pairs close the circle: reads crossing the origin
        # (ge > L) against SHADOWS of low-start reads shifted by +L; the
        # shadow frame keeps the projection arithmetic linear.  Appended
        # after the linear pairs in (crosser, shadow) lexicographic order.
        L = sim["genome_len"]
        cross = np.flatnonzero(ge > L)
        maxov = int((ge - L).max()) if cross.size else 0
        low = np.flatnonzero(gs < maxov)
        if cross.size and low.size:
            ii, jj = np.meshgrid(cross, low, indexing="ij")
            ii, jj = ii.ravel(), jj.ravel()
            sgs, sge = gs[jj] + L, ge[jj] + L  # shadow coords
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


def write_paf(sim, path) -> int:
    """Byte-identical to the original per-record writer, but vectorized:
    column int->str conversion in numpy chunks (worm-scale PAFs are ~20M
    lines; the naive loop is >10 min, this is seconds)."""
    a = paf_arrays(sim)
    # minimap2 emits all of a query's records consecutively (queries in
    # read-file order); group the sweep's target-ordered emission the
    # same way so files have realistic query-run structure (the FMT3
    # loader's qid-RLE sideband and any grouped-stream consumer see what
    # real minimap output looks like)
    sel = np.argsort(a["qi"], kind="stable")
    a = {k: v[sel] for k, v in a.items()}
    names = np.asarray(sim["names"])
    cnt = len(a["qi"])
    CH = 1 << 20
    fmt = "%s\t%d\t%d\t%d\t%s\t%s\t%d\t%d\t%d\t%d\t%d\tcm:i:%d"
    with open(path, "w", buffering=1 << 22) as f:
        for i0 in range(0, cnt, CH):
            sl = slice(i0, min(i0 + CH, cnt))
            rows = zip(names[a["qi"][sl]].tolist(), a["ql"][sl].tolist(),
                       a["qs"][sl].tolist(), a["qe"][sl].tolist(),
                       np.where(a["rev"][sl], "-", "+").tolist(),
                       names[a["ti"][sl]].tolist(), a["tl"][sl].tolist(),
                       a["ts"][sl].tolist(), a["te"][sl].tolist(),
                       a["ml"][sl].tolist())
            f.write("\n".join(
                fmt % (q, ql, qs, qe, r, t, tl, ts, te, ml, ml, ml // 50)
                for q, ql, qs, qe, r, t, tl, ts, te, ml in rows))
            f.write("\n")
    return cnt


def write_fasta(sim, path) -> None:
    g = sim["genome"]
    assert g is not None, "genome too large to materialize"
    with open(path, "w") as f:
        for name, s, e, o in zip(sim["names"], sim["gs"], sim["ge"], sim["ori"]):
            s, e = int(s), int(e)
            if e > len(g):  # circular wrap
                seq = g[s:] + g[:e - len(g)]
            else:
                seq = g[s:e]
            if o:
                seq = revcomp(seq)
            f.write(">%s\n%s\n" % (name, seq))
