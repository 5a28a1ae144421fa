"""The Python spec of the bubble pass's ordered commit: the walk that
miniasm_tpu_torch/graph/devbub.py ran in Python before the native walk
(io/native/bubwalk.cpp) took its place, kept line for line as the
reference the native walk is held to (tests/test_torch_bubwalk.py on the
CPU, tests/test_torch_cuda.py on the card).  Imports no JAX."""

import numpy as np

from miniasm_tpu_torch.graph.asg import Graph, cleanup


def walk(g: Graph, cands, verdicts, max_dist: int):
    """The commit loop of pop_bubbles_dev over `_dispatch`'s verdicts of
    the sources `cands`, in place on g.  Returns (n_popped | n_tips << 32,
    candidates, commits, sources recomputed on the host), the native
    walk's tuple."""
    cands = [int(v) for v in cands]
    ok, nb, ntip, sink, vis, par, _K = verdicts
    n_pop = 0
    n_tip = 0
    n_redo = 0
    touched = np.zeros(g.n_vtx, bool)
    any_commit = False
    for j, v0 in enumerate(cands):
        # live re-validation like the reference scan (asg.c:420-424)
        if g.sdel[v0 >> 1] or g.idx_cnt[v0] < 2:
            continue
        s = g.idx_start[v0]
        if int(np.sum(~g.adel[s:s + g.idx_cnt[v0]])) < 2:
            continue
        nbj = int(nb[j])
        vset = vis[j, :nbj]
        stale = False
        if any_commit:
            rd = np.concatenate([vset, vset ^ 1, [v0, v0 ^ 1]])
            stale = bool(touched[rd].any())
        if stale:
            n_redo += 1
            okj, vlist, snk, parent, ntj = _host_pop1(g, v0, max_dist)
            if not okj:
                continue
            vset = np.asarray(vlist, dtype=np.int64)
        else:
            if not bool(ok[j]):
                continue
            snk = int(sink[j])
            parent = dict(zip(vset.tolist(), par[j, :nbj].tolist()))
            ntj = int(ntip[j])
        _commit(g, v0, vset, snk, parent)
        n_pop += 1
        n_tip += ntj
        touched[np.asarray(vset)] = True
        touched[np.asarray(vset) ^ 1] = True
        touched[[v0, v0 ^ 1]] = True
        any_commit = True
    return n_pop | (n_tip << 32), len(cands), n_pop, n_redo


def _host_pop1(g: Graph, v0: int, max_dist: int):
    """Bounded Kahn BFS for ONE source against the LIVE graph — the
    host-sequential conflict path of SURVEY §7 ("non-overlapping bubbles
    commit in parallel; conflicting bubbles serialize").  Identical
    semantics to the device kernel (and asg_bub_pop1); used only for
    sources whose device verdict went stale behind an earlier commit.

    Returns (ok, vis_list, sink, parent_map, ntip)."""
    vis = [v0]
    parent = {}
    dd = {v0: 0}
    cc = {v0: 0}
    rr = {}
    stack = [v0]
    npend = 0
    ntip = 0
    while True:
        v = stack.pop()
        dv, cv = dd[v], cc[v]
        s = int(g.idx_start[v])
        nv = int(g.idx_cnt[v])
        for ai in range(s, s + nv):
            w = int(g.v[ai])
            if w == v0:  # back-arc aborts even when deleted (asg.c:379)
                return False, vis, -1, parent, 0
            if g.adel[ai]:
                continue
            l = int(g.l[ai])
            if dv + l > max_dist:
                return False, vis, -1, parent, 0
            if w not in dd:
                vis.append(w)
                parent[w] = v
                dd[w] = dv + l
                cc[w] = 0
                sw = int(g.idx_start[w ^ 1])
                cw = int(g.idx_cnt[w ^ 1])
                rr[w] = int(np.count_nonzero(~g.adel[sw:sw + cw]))
                npend += 1
            else:
                if cv + 1 > cc[w] or (cv + 1 == cc[w] and dv + l > dd[w]):
                    parent[w] = v
                if cv + 1 > cc[w]:
                    cc[w] = cv + 1
                if dv + l < dd[w]:
                    dd[w] = dv + l
            rr[w] -= 1
            if rr[w] == 0:
                if g.idx_cnt[w]:
                    stack.append(w)
                else:
                    ntip += 1
                npend -= 1
        if not stack:
            return False, vis, -1, parent, 0
        if len(stack) == 1 and npend == 0:
            return True, vis, stack[0], parent, ntip


def _commit(g: Graph, v0: int, vset, sink: int, parent):
    """asg_bub_backtrack (asg.c:338-357): delete every visited read and
    every live out-arc of the processed vertices, then restore the
    max-count path sink -> v0."""
    for w in vset[1:]:
        g.sdel[w >> 1] = True
    for u in (int(x) for x in np.concatenate([[v0], vset[1:]])):
        if u == sink:
            continue
        s = g.idx_start[u]
        c = g.idx_cnt[u]
        for ai in range(s, s + c):
            if g.adel[ai]:
                continue
            g.adel[ai] = True
            g.arc_del(int(g.v[ai]) ^ 1, int(g.u[ai]) ^ 1, True)
    v = sink
    while v != v0:
        u = parent[v]
        g.sdel[v >> 1] = False
        g.arc_del(u, v, False)
        g.arc_del(v ^ 1, u ^ 1, False)
        v = u


def braid_graph(rng, n_back=30, n_alt=12, read_len=10_000):
    """tests/test_hybrid_clean.py's braid in the port's Graph: a backbone
    chain with parallel bypass reads, so many overlapping bubbles with
    shared sinks (the stale sources of the walk)."""
    lens = [read_len] * n_back
    us, ls, vs, ols = [], [], [], []

    def arc(a, b, l, ol):
        us.extend([a, b ^ 1])
        ls.extend([l, l])
        vs.extend([b, a ^ 1])
        ols.extend([ol, ol])

    for i in range(n_back - 1):
        arc(i << 1, (i + 1) << 1, 4000, 6000)
    for _ in range(n_alt):
        i = int(rng.integers(0, n_back - 2))
        span = int(rng.integers(1, 3))
        j = min(i + 1 + span, n_back - 1)
        alt = len(lens)
        lens.append(read_len)
        arc(i << 1, alt << 1, int(rng.integers(2000, 6000)), 5000)
        arc(alt << 1, j << 1, int(rng.integers(2000, 6000)), 5000)
    n_seq = len(lens)
    g = Graph(u=np.asarray(us, np.int32), l=np.asarray(ls, np.int32),
              v=np.asarray(vs, np.int32), ol=np.asarray(ols, np.int32),
              adel=np.zeros(len(us), bool),
              slen=np.asarray(lens, np.uint32), sdel=np.zeros(n_seq, bool),
              idx_start=np.zeros(2 * n_seq, np.int64),
              idx_cnt=np.zeros(2 * n_seq, np.int32))
    return cleanup(g)
