"""Device-side bubble popping (reference asg_pop_bubble, asg.c:360-433).

Port of miniasm_tpu/graph/devbub.py.  The per-source Kahn BFS runs on the
device for all candidate sources at once (the `bubble_bfs` kernel, K4,
csrc/bubble.cu: one warp per source, in the serial asg_bub_pop1 order),
and the HOST commits the verdicts in the reference's ascending-source
order, in one call of the native walk (io/native/bubwalk.cpp).

Exact-semantics notes (all mirrored from asg_bub_pop1):
  - an arc pointing back at v0 aborts the bubble EVEN IF the arc is
    deleted (the w==v0 test precedes the del test, asg.c:379-381);
  - a distance overrun (d+l > max_dist) on any live arc aborts;
  - first visit sets p/d/r but NOT c (c stays 0 until a second in-edge
    relaxes it, asg.c:383-389) — the parent tie-break is c+1 > c_w, or
    c+1 == c_w and d+l > d_w, against the RUNNING values;
  - visited vertices with NO raw arc slots (idx_cnt==0) count as tips
    and never enter the stack (asg.c:393-396);
  - success == stack holds exactly one vertex (the sink) and nothing is
    pending; the kept path is the max-read-count chain via p from sink.

The kernel stops an aborted source at the offending arc, like the
reference; the JAX program processes whole rows and may visit a superset
there.  The visited set of a failed source only sets the staleness radius
of the ordered commit, and both are exact read sets of their verdicts.

Ordered commit (pop order matters: each pop mutates the graph later
sources read): walk sources ascending; a device verdict is valid while
the bubble's read set {v0,v0^1} ∪ visited ∪ visited^1 is disjoint from
rows touched by earlier commits; a stale source is recomputed by the
sequential host BFS against the live graph.  Commits only shrink
live-arc sets, so candidates never grow and the scan-order equivalence
argument of graph/hybrid.py applies unchanged.

Capacity: visited sets are capped at K per source; the sources that
overflow run again with K doubled, so results are always exact.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..cuda import I32, I64, P, SMEM_MAX, Kernel, ptr
from ..utils import timers
from .asg import Graph

# _bub_kernel: bounded Kahn BFS per bubble source
K_BUB = Kernel(
    "bubble_bfs", "bubble.cu", "ma_bubble_bfs",
    [P, P, P, P, P, P, I64, I32, I32, P, P, P, P, I32],
    replaces="miniasm_tpu/graph/devbub.py:63")


def bubble_bfs_plain(first, av, al, adel, live_out, sources, K: int,
                     max_dist: int):
    """Plain PyTorch version of the bubble_bfs kernel: the same serial
    per-source BFS, run in lockstep over all sources (one arc per source
    per step).  Returns (res (4, S) int32 [ok | ovf<<1, nb, ntip, sink],
    vis (S, K) int32, par (S, K) int32)."""
    dev = av.device
    i64 = torch.int64
    S = sources.shape[0]
    first = first.to(i64)
    cnt = first[1:] - first[:-1]
    v0 = sources.to(i64)
    vis = torch.full((S, K), -1, dtype=i64, device=dev)
    par = torch.full((S, K), -1, dtype=i64, device=dev)
    d = torch.zeros((S, K), dtype=i64, device=dev)
    c = torch.zeros((S, K), dtype=i64, device=dev)
    r = torch.zeros((S, K), dtype=i64, device=dev)
    stk = torch.zeros((S, K + 1), dtype=i64, device=dev)
    vis[:, 0] = v0
    zero = torch.zeros(S, dtype=i64, device=dev)
    sp, nb, npend, ntip = zero + 1, zero + 1, zero.clone(), zero.clone()
    cur_v, cur_d, cur_c, ai, aend = (zero.clone() for _ in range(5))
    sink = zero - 1
    no = torch.zeros(S, dtype=torch.bool, device=dev)
    ok, ovf, done, in_row = no.clone(), no.clone(), no.clone(), no.clone()
    kk = torch.arange(K, device=dev)
    while True:
        act = ~done
        if not bool(act.any()):
            break
        # pop the next vertex where no row is in progress
        pi = torch.nonzero(act & ~in_row).flatten()
        if pi.numel():
            sp[pi] -= 1
            slot = stk[pi, sp[pi]]
            v = vis[pi, slot]
            cur_v[pi], cur_d[pi], cur_c[pi] = v, d[pi, slot], c[pi, slot]
            ai[pi], aend[pi] = first[v], first[v + 1]
            in_row[pi] = True
        # one arc of the row
        idx = torch.nonzero(act & in_row & (ai < aend)).flatten()
        if idx.numel():
            a = ai[idx]
            w = av[a].to(i64)
            dl = adel[a] != 0
            dd = cur_d[idx] + al[a].to(i64)
            fail = (w == v0[idx]) | (~dl & (dd > max_dist))
            proc = ~fail & ~dl
            eq = (vis[idx] == w[:, None]) & (kk[None, :] < nb[idx][:, None])
            found = eq.any(1)
            ws = eq.to(torch.int32).argmax(1)
            full = proc & ~found & (nb[idx] == K)
            ovf[idx[full]] = True
            fail = fail | full
            proc = proc & ~full
            new = proc & ~found
            ni = idx[new]
            ns = nb[ni]
            ws[new] = ns
            vis[ni, ns] = w[new]
            par[ni, ns] = cur_v[ni]
            d[ni, ns] = dd[new]
            r[ni, ns] = live_out[w[new] ^ 1].to(i64)
            nb[ni] += 1
            npend[ni] += 1
            old = proc & found
            oi, os_ = idx[old], ws[old]
            cw, dw = c[oi, os_], d[oi, os_]
            cv1, ddo = cur_c[oi] + 1, dd[old]
            upd = (cv1 > cw) | ((cv1 == cw) & (ddo > dw))
            par[oi[upd], os_[upd]] = cur_v[oi[upd]]
            c[oi, os_] = torch.maximum(cw, cv1)
            d[oi, os_] = torch.minimum(dw, ddo)
            qi, qs = idx[proc], ws[proc]
            r[qi, qs] -= 1
            ready = r[qi, qs] == 0
            tip = cnt[w[proc]] == 0
            push = ready & ~tip
            pu = qi[push]
            stk[pu, sp[pu]] = qs[push]
            sp[pu] += 1
            ntip[qi[ready & tip]] += 1
            npend[qi[ready]] -= 1
            done[idx[fail]] = True
            ai[idx] += 1
        # end of a row: the BFS fails on an empty stack, succeeds on a
        # lone sink with nothing pending
        em = ~done & in_row & (ai >= aend)
        in_row &= ~em
        done |= em & (sp == 0)
        oi = torch.nonzero(em & (sp == 1) & (npend == 0)).flatten()
        ok[oi] = True
        done[oi] = True
        sink[oi] = vis[oi, stk[oi, 0]]
    res = torch.stack([ok.to(i64) | (ovf.to(i64) << 1), nb, ntip, sink])
    return res.to(torch.int32), vis.to(torch.int32), par.to(torch.int32)


def bubble_bfs(first, av, al, adel, live_out, sources, K: int,
               max_dist: int, *, smem_cap: int = SMEM_MAX):
    """K4.  first (V+1,) int64 CSR offsets; av/al (A,) int32; adel (A,)
    uint8 tombstones; live_out (V,) int32 live arcs per row; sources (S,)
    int32.  Returns (res (4, S), vis (S, K), par (S, K)), all int32.  A
    source's state stays in shared memory where it fits `smem_cap` bytes a
    block, else in global scratch; the card tests lower the cap to reach
    the latter."""
    if av.device.type == "cpu":
        return bubble_bfs_plain(first, av, al, adel, live_out, sources, K,
                                max_dist)
    if first.dtype != torch.int64 or av.dtype != torch.int32 \
            or al.dtype != torch.int32 or adel.dtype != torch.uint8 \
            or live_out.dtype != torch.int32 or sources.dtype != torch.int32:
        raise TypeError("bubble_bfs: int64 offsets, int32 columns and "
                        "uint8 tombstones expected")
    dev = av.device
    S = sources.shape[0]
    res = torch.empty((4, S), dtype=torch.int32, device=dev)
    vis = torch.empty((S, K), dtype=torch.int32, device=dev)
    par = torch.empty((S, K), dtype=torch.int32, device=dev)
    # a source's state (bubble.cu state_words): row starts (int64), vis,
    # par, d, c, r, row lengths, the stack of K + 1; even
    W = (9 * K + 2) & ~1
    work = (torch.empty((S, W), dtype=torch.int32, device=dev)
            if 4 * W > smem_cap else None)
    if S:
        K_BUB(ptr(first), ptr(av), ptr(al), ptr(adel), ptr(live_out),
              ptr(sources), S, int(K), int(max_dist), ptr(res), ptr(vis),
              ptr(par), None if work is None else ptr(work), int(smem_cap))
    return res, vis, par


def _arc_cols(g: Graph, device: torch.device) -> dict:
    """CSR columns of the graph (tombstoned arcs included: the back-arc
    test reads them) and the live out-degree of every row."""
    V = g.n_vtx
    first = np.empty(V + 1, dtype=np.int64)
    first[:V] = g.idx_start
    first[V] = g.n_arc
    live = ~g.adel
    row = np.repeat(np.arange(V), g.idx_cnt)
    live_out = np.bincount(row[live], minlength=V).astype(np.int32)
    cols = {"first": first, "av": g.v.astype(np.int32),
            "al": g.l.astype(np.int32), "adel": g.adel.astype(np.uint8),
            "live_out": live_out}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in cols.items()}


def _dispatch(g: Graph, cands, max_dist: int, K: int, device):
    """Run the kernel over the candidate sources; the sources whose visited
    set overflowed K run again at 2K, and so on.  Sources are independent,
    so the rows merged back (widened with -1) equal one run of every
    source at the final K."""
    c = _arc_cols(g, device)
    cols = (c["first"], c["av"], c["al"], c["adel"], c["live_out"])
    src = torch.from_numpy(np.asarray(cands, dtype=np.int32)).to(device)
    res, vis, par = bubble_bfs(*cols, src, K, int(max_dist))
    redo = torch.nonzero(res[0] & 2).flatten()
    while redo.numel():
        K *= 2
        r2, v2, p2 = bubble_bfs(*cols, src[redo], K, int(max_dist))
        wide = (0, K - vis.shape[1])
        vis = torch.nn.functional.pad(vis, wide, value=-1)
        par = torch.nn.functional.pad(par, wide, value=-1)
        res[:, redo], vis[redo], par[redo] = r2, v2, p2
        redo = redo[(r2[0] & 2) != 0]
    res = res.cpu().numpy()
    return ((res[0] & 1).astype(bool), res[1], res[2], res[3],
            vis.cpu().numpy(), par.cpu().numpy(), K)


def _col(a, dtype, shape, name: str, out: bool = False) -> int:
    """The address of a column handed to the native walk.  A column of
    another dtype, shape or layout raises: a copy would lose the walk's
    in-place writes."""
    if not isinstance(a, np.ndarray) or a.dtype != dtype:
        raise TypeError("bubble_walk: %s must be a %s ndarray, not %s"
                        % (name, np.dtype(dtype), getattr(a, "dtype",
                                                          type(a))))
    if a.shape != shape or not a.flags.c_contiguous \
            or (out and not a.flags.writeable):
        raise ValueError("bubble_walk: %s must be a C-contiguous%s array "
                         "of shape %s, not %s" % (
                             name, " writable" if out else "", shape,
                             a.shape))
    return a.ctypes.data


def bubble_walk(g: Graph, cands, verdicts, max_dist: int):
    """The ordered commit of one bubble pass (io/native/bubwalk.cpp
    ma_bubble_walk): sources `cands` (int32, ascending) with their K4
    verdicts (`_dispatch`'s tuple), re-validated, re-run on the host where
    an earlier commit touched their read set, and committed into g.adel
    and g.sdel in place.  Returns (n_popped | n_tips << 32, candidates,
    commits, sources recomputed on the host)."""
    from ..io.native.build import get_lib

    ok, nb, ntip, sink, vis, par, K = verdicts
    A, V, S = g.n_arc, g.n_vtx, len(cands)
    args = [V, _col(g.v, np.int32, (A,), "v"),
            _col(g.u, np.int32, (A,), "u"), _col(g.l, np.int32, (A,), "l"),
            _col(g.idx_start, np.int64, (V,), "idx_start"),
            _col(g.idx_cnt, np.int32, (V,), "idx_cnt"),
            _col(g.adel, np.bool_, (A,), "adel", out=True),
            _col(g.sdel, np.bool_, (g.n_seq,), "sdel", out=True),
            S, _col(cands, np.int32, (S,), "cands"),
            _col(ok, np.bool_, (S,), "ok"), _col(nb, np.int32, (S,), "nb"),
            _col(ntip, np.int32, (S,), "ntip"),
            _col(sink, np.int32, (S,), "sink"),
            _col(vis, np.int32, (S, K), "vis"),
            _col(par, np.int32, (S, K), "par"), K, int(max_dist)]
    out = np.zeros(4, dtype=np.int64)
    fn = get_lib().ma_bubble_walk
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int64] + [ctypes.c_void_p] * 7 + [
        ctypes.c_int64] + [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 2 + [
        ctypes.c_void_p]
    if fn(*args, out.ctypes.data):
        raise RuntimeError("bubble_walk: a verdict names a vertex outside "
                           "the graph or a path outside its visited set")
    return tuple(int(x) for x in out)


def pop_bubbles_dev(g: Graph, cand_mask, max_dist: int,
                    device: torch.device = torch.device("cpu")) -> int:
    """Ordered commit of device-detected bubbles: ONE kernel dispatch
    computes every source's verdict against the pass-entry graph; the
    native walk (`bubble_walk`) goes through the sources in ascending
    order, applying device verdicts whose read sets are untouched by
    earlier commits and recomputing the (rare) conflicting sources with
    the sequential host BFS, in the spans `dispatch` (K4 and its fetch)
    and `commit` (the walk).  Returns the reference's packed counter
    (n_popped | n_tips<<32, asg.c:405/431)."""
    cands = np.flatnonzero(cand_mask).astype(np.int32)
    if not cands.size:
        return 0
    with timers.span("dispatch"):
        verdicts = _dispatch(g, cands, max_dist, 64, device)
    with timers.span("commit"):
        packed, n_cand, n_pop, n_redo = bubble_walk(g, cands, verdicts,
                                                    max_dist)
    timers.count("clean.candidates", n_cand)
    timers.count("clean.commits", n_pop)
    timers.count("clean.bubble_recomputed", n_redo)
    return packed
