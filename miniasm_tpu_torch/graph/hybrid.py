"""Steps 4.1-4.5 driver: device-parallel detection, deterministic ordered
commit (the SURVEY §7 plan).  Port of miniasm_tpu/graph/hybrid.py; the
detection (graph/devclean.py) and the bubble BFS (graph/devbub.py) run on
the run's device, the commits on the host.

Every pass of the reference's graph cleaning (asg.c) is driven by a device
detection kernel (devclean.py) that computes, in one dispatch, the exact
deletion masks of the order-INdependent passes (transitive reduction,
multi/asymm, weak-overlap drops at every scheduled ratio) plus candidate
vertex sets for the order-DEPENDENT ones (tips, internal unitigs,
bi-loops, bubble sources).  The host then commits candidates in the
reference's ascending-vertex scan order, re-validating each against the
live graph; commits that mutate the graph can create NEW candidates with
higher vertex ids (which the reference's scan would also process in the
same pass) — those are discovered by re-testing every vertex whose
classification can read a mutated row and pushing them into the same
ordered worklist, which makes the commit sequence provably identical to
the reference's in-order scan:

  * the reference cuts v iff v is a candidate at the moment the scan
    passes v; candidacy only changes at commits; our worklist holds
    exactly the candidates "not yet passed" (id > last commit), so both
    traversals process the same vertices in the same order.

  * candidacy of v = f(is_utg_end(v), asg_extend(v, max_ext)); the extend
    walk reads rows up to max_ext+1 forward hops (plus one orientation
    flip) from v, so the set of vertices whose candidacy a mutation can
    change is the BACKWARD ball of radius max_ext+2 around the mutated
    rows, orientation-closed (_affected below).  A 2-hop neighborhood is
    NOT enough — cutting a tip can flip extend()'s verdict for a vertex
    four reads upstream.

On a graph where nothing fires (the common case for clean data after
transitive reduction), the entire Steps 4.1-4.5 block costs ONE device
round trip.  When a pass mutates the graph, detection is re-dispatched for
the next pass, so the dozens of passes of a noisy assembly stay
device-driven.
"""

from __future__ import annotations

import functools
import heapq

import numpy as np
import torch

from ..utils import timers
from ..utils.timers import log
from .asg import Graph, cleanup
from . import devclean

# unitig-end classification codes (semantics of asg_is_utg_end,
# asg.c:199-221; numerically identical to graph/seqclean.py's spec)
ET_MERGEABLE = 0
ET_TIP = 1
ET_MULTI_OUT = 2
ET_MULTI_NEI = 3


def _end_class(g: Graph, v: int):
    """Classify vertex v's backward side by its live in-arcs.  Returns
    (code, next_l, next_v): the unique predecessor edge when one exists.
    Reads row v^1 (in-arcs of v are out-arcs of v^1, complemented)."""
    s = int(g.idx_start[v ^ 1])
    c = int(g.idx_cnt[v ^ 1])
    live = np.flatnonzero(~g.adel[s:s + c])
    if live.size == 0:
        return ET_TIP, 0, -1
    if live.size > 1:
        return ET_MULTI_OUT, 0, -1
    i0 = s + int(live[-1])
    nl, nv = int(g.l[i0]), int(g.v[i0])
    w = nv ^ 1
    sw = int(g.idx_start[w])
    cw = int(g.idx_cnt[w])
    if int(np.count_nonzero(~g.adel[sw:sw + cw])) != 1:
        return ET_MULTI_NEI, nl, nv
    return ET_MERGEABLE, nl, nv


def is_utg_end(g: Graph, v: int):
    """(code, (l, next_v) | None) — the shape the ordered commits use."""
    code, nl, nv = _end_class(g, v)
    return code, ((nl, nv) if nv >= 0 else None)


def extend(g: Graph, v: int, max_ext: int):
    """Follow the mergeable chain up to max_ext classification steps
    (semantics of asg_extend, asg.c:223-236): evaluates the end class at
    v^1 (i.e. v's forward continuation), appending the unique next vertex
    while MERGEABLE.  Returns (terminating code, chain) with chain[0] =
    (0, v) and chain[i>0] = (l, vertex)."""
    chain = [(0, v)]
    ret = ET_MERGEABLE
    while True:
        ret, nl, nv = _end_class(g, v ^ 1)
        if ret != ET_MERGEABLE:
            break
        chain.append((nl, nv))
        v = nv
        max_ext -= 1
        if max_ext <= 0:
            break
    return ret, chain


def _pass(name):
    """Run a cleaning pass inside the span `name` (utils/timers.py): its
    detections, commits and cleanups are its children."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args):
            with timers.span(name):
                return fn(*args)
        return run
    return wrap


class _Cleaner:
    """Holds the graph + the currently-valid detection; re-detects after
    mutations."""

    def __init__(self, g: Graph, opt, do_trans: bool,
                 device: torch.device = torch.device("cpu"), group=None):
        self.g = g
        self.opt = opt
        self.device = device
        self.group = group  # detection shared with the group's ranks
        # symm_mode: whether detection chains candidate masks through the
        # multi/asymm live set.  True except in the rare trans==0 window
        # where the reference leaves the graph unsymmetrized (see
        # devclean._clean_kernel's do_symm).
        self.symm_mode = True
        self.det = devclean.detect(g, opt, do_trans=do_trans, device=device,
                                   group=group)
        self.trans_done = not do_trans

    def redetect(self):
        self.det = devclean.detect(self.g, self.opt, do_trans=False,
                                   do_symm=self.symm_mode, device=self.device,
                                   group=self.group)

    # ---- order-independent mask application ----

    @_pass("trans")
    def apply_trans(self):
        det = self.det
        n = int(det["trans"].sum())
        log("del_trans", "transitively reduced %d arcs", n)
        if n:
            self.g.adel |= det["trans"]
            # multi/asymm masks were chained on the post-trans live set in
            # the same kernel, so they remain valid for apply_symm
        elif int(det["multi"].sum()) or int(det["asymm"].sum()):
            # trans reduced nothing -> the reference skips the symm, so the
            # downstream candidates must be re-classified on the
            # unsymmetrized live set (one extra dispatch, rare case)
            self.symm_mode = False
            self.redetect()
        self.trans_done = True
        return n

    @_pass("symm")
    def apply_symm(self):
        det = self.det
        n_multi = int(det["multi"].sum())
        if n_multi:
            self.g.adel |= det["multi"]
        log("del_multi", "removed %d multi-arcs", n_multi)
        n_asymm = int(det["asymm"].sum())
        if n_asymm:
            self.g.adel |= det["asymm"]
        log("del_asymm", "removed %d asymmetric arcs", n_asymm)
        was_symm_mode = self.symm_mode
        self.symm_mode = True
        if n_multi or n_asymm or int(det["trans"].sum()):
            g = self.g
            if was_symm_mode:
                # the detection chained every downstream mask on the
                # post-symm live set inside one kernel, and cleanup only
                # compacts (relative arc order preserved, asg.c:75-78) —
                # so remap the arc masks through the compaction instead
                # of paying a second detection dispatch
                keep = ~g.adel & ~g.sdel[g.u >> 1] & ~g.sdel[g.v >> 1]
                self.g = cleanup(g)
                det2 = dict(det)
                for k in ("trans", "multi", "asymm"):
                    det2[k] = det[k][keep]  # all-False after the apply
                det2["shorts"] = [m[keep] for m in det["shorts"]]
                self.det = det2
            else:
                # trans==0 window: masks were computed on the
                # UNsymmetrized live set; downstream candidates need a
                # fresh post-symm classification
                self.g = cleanup(g)
                self.redetect()
        self.g.is_symm = True

    @_pass("del_short")
    def del_short(self, ratio_idx: int):
        det = self.det
        mask = det["shorts"][ratio_idx]
        n = int(mask.sum())
        if n:
            self.g.adel |= mask
            self.g = cleanup(self.g)
            # reference: asg_cleanup + asg_symm after a productive drop
            # (asg.c:96-99); symm masks must come from a fresh detection
            self.redetect()
            self.apply_symm()
        log("del_short", "removed %d short overlaps", n)
        return n

    # ---- ordered commits ----

    def _affected(self, touched_rows):
        """Superset of vertices whose (is_utg_end, extend) classification
        can have changed after a commit that mutated `touched_rows`.

        A vertex w's classification reads rows along its forward extend
        walk (<= max_ext hops following unique live out-arcs) plus one
        extra hop with an orientation flip; so w is affected iff a mutated
        row lies in that reading set, i.e. w is in the BACKWARD ball of
        radius max_ext+2 around the mutated rows.  Predecessors of row r
        (vertices with an arc into r) are targets(row r^1)^1 — tombstoned
        arcs included, which only widens the superset.  Every returned
        vertex is fully re-validated at commit time, so over-approximation
        is safe and under-approximation is the only hazard.

        Vectorized frontier expansion: each hop gathers ALL frontier rows'
        target slices with one repeat/arange flat-index build (the Python
        per-row loop was the hot spot of noisy worm-scale cleaning)."""
        g = self.g
        cur = np.unique(np.asarray(list(touched_rows), dtype=np.int64))
        cur = np.unique(np.concatenate([cur, cur ^ 1]))
        seen = set(cur.tolist())
        out = set(seen)
        for _ in range(self.opt.max_ext + 2):
            rows = cur ^ 1
            starts = g.idx_start[rows]
            cnts = g.idx_cnt[rows].astype(np.int64)
            tot = int(cnts.sum())
            if tot == 0:
                break
            base = np.repeat(np.cumsum(cnts) - cnts, cnts)
            flat = np.repeat(starts, cnts) + (np.arange(tot) - base)
            t = g.v[flat].astype(np.int64)
            cand = np.unique(np.concatenate([t, t ^ 1]))
            nxt = [w for w in cand.tolist() if w not in out]
            if not nxt:
                break
            out.update(nxt)
            cur = np.asarray(nxt, dtype=np.int64)
        return out

    def _ordered_commit(self, cand_mask, want_start, want_ext, commit_fn,
                        max_ext=None):
        """Reference in-order scan over candidates with worklist expansion.
        commit_fn(v, chain_code, chain) mutates the graph and returns the
        vertex set it touched (or None if it declined); returns #commits.
        max_ext defaults to opt.max_ext (tips/bi-loops); cut_internal must
        pass 1 (reference hard-codes asg_cut_internal(sg, 1), main.c:177).
        The device candidate masks are computed with opt.max_ext and remain
        a valid superset; _affected also keeps the opt.max_ext+2 radius."""
        g = self.g
        if max_ext is None:
            max_ext = self.opt.max_ext
        heap = [int(v) for v in np.flatnonzero(cand_mask)]
        heapq.heapify(heap)
        cnt = 0
        popped = 0
        last = -1
        while heap:
            v = heapq.heappop(heap)
            if v == last:
                continue  # duplicate push
            last = v
            popped += 1
            if g.sdel[v >> 1]:
                continue
            if is_utg_end(g, v)[0] != want_start:
                continue
            ret, chain = extend(g, v, max_ext)
            if not want_ext(ret):
                continue
            touched = commit_fn(v, ret, chain)
            if touched is None:
                continue
            cnt += 1
            for w in self._affected(touched):
                if w > v and not g.sdel[w >> 1] \
                        and is_utg_end(g, w)[0] == want_start:
                    heapq.heappush(heap, w)
        timers.count("clean.candidates", popped)
        timers.count("clean.commits", cnt)
        return cnt

    def _chain_rows(self, chain):
        """Rows whose arc set a seq_del over the chain mutates: the chain
        vertices (both orientations) and every row holding an arc into
        them (arc_del(w^1, vv^1) tombstones in row w^1; _affected
        orientation-closes, so plain targets suffice)."""
        g = self.g
        base = np.asarray([vv for _, vv in chain], dtype=np.int64)
        rows = np.unique(np.concatenate([base, base ^ 1]))
        starts = g.idx_start[rows]
        cnts = g.idx_cnt[rows].astype(np.int64)
        tot = int(cnts.sum())
        out = set(rows.tolist())
        if tot:
            off = np.repeat(np.cumsum(cnts) - cnts, cnts)
            flat = np.repeat(starts, cnts) + (np.arange(tot) - off)
            out.update(g.v[flat].tolist())
        return out

    @_pass("cut_tip")
    def cut_tip(self):
        g = self.g

        def commit(v, ret, chain):
            touched = self._chain_rows(chain)
            for _, vv in chain:
                g.seq_del(vv >> 1)
            return touched

        cnt = self._ordered_commit(self.det["tip"], ET_TIP,
                                   lambda r: r != ET_MERGEABLE, commit)
        if cnt > 0:
            self.g = cleanup(self.g)
            self.redetect()
        log("cut_tip", "cut %d tips", cnt)
        return cnt

    @_pass("cut_internal")
    def cut_internal(self):
        g = self.g

        def commit(v, ret, chain):
            touched = self._chain_rows(chain)
            for _, vv in chain:
                g.seq_del(vv >> 1)
            return touched

        cnt = self._ordered_commit(self.det["internal"], ET_MULTI_NEI,
                                   lambda r: r == ET_MULTI_NEI, commit,
                                   max_ext=1)
        if cnt > 0:
            self.g = cleanup(self.g)
            self.redetect()
        log("cut_internal", "cut %d internal sequences", cnt)
        return cnt

    @_pass("cut_biloop")
    def cut_biloop(self):
        g = self.g

        def commit(v, ret, chain):
            x = chain[-1][1] ^ 1
            w = None
            sl = g.arcs_of(v ^ 1)
            for i in range(sl.start, sl.stop):
                if not g.adel[i]:
                    w = int(g.v[i]) ^ 1
            assert w is not None
            ov = ox = 0
            sw = g.arcs_of(w)
            for i in range(sw.start, sw.stop):
                if g.adel[i]:
                    continue
                if g.v[i] == x:
                    ox = int(g.ol[i])
                if g.v[i] == v:
                    ov = int(g.ol[i])
            if ov == 0 and ox == 0:
                return None
            if ov > ox:
                g.arc_del(w, x, True)
                g.arc_del(x ^ 1, w ^ 1, True)
                return {w, x, w ^ 1, x ^ 1}
            return None

        cnt = self._ordered_commit(self.det["biloop"], ET_MULTI_NEI,
                                   lambda r: r == ET_MULTI_OUT, commit)
        if cnt > 0:
            self.g = cleanup(self.g)
            self.redetect()
        log("cut_biloop", "cut %d small bi-loops", cnt)
        return cnt

    @_pass("pop_bubble")
    def pop_bubble(self, max_dist: int):
        """Device-detected bubble sources (>=2 live out-arcs); the Kahn
        BFS for ALL sources runs in one device dispatch and the host
        commits verdicts in ascending-source order with staleness-driven
        re-dispatch (graph/devbub.py; reference asg.c:360-433).  Pops only
        delete arcs, so no new sources can appear mid-pass."""
        from .devbub import pop_bubbles_dev

        g = self.g
        if not g.is_symm:
            self.apply_symm()
            g = self.g
        n_pop = pop_bubbles_dev(g, self.det["bubble"], max_dist,
                                self.device)
        if n_pop:
            self.g = cleanup(g)
            self.redetect()
        log("pop_bubble", "popped %d bubbles and trimmed %d tips",
            n_pop & 0xFFFFFFFF, n_pop >> 32)
        return n_pop


def clean_graph(g: Graph, opt, stage: int,
                device: torch.device = torch.device("cpu"),
                group=None) -> Graph:
    """Steps 4.1-4.5 (main.c:156-188), every pass detected on the device.
    With a process group (rank 0 calls this; the others run
    devclean.follow), every detection runs K3 on every rank's block of
    vertex rows, as the JAX clean_graph(mesh=) row-shards its tables."""
    import sys

    cl = _Cleaner(g, opt, do_trans=stage >= 6, device=device, group=group)
    if stage >= 6:
        sys.stderr.write("[M::main] ===> Step 4.1: transitive reduction <===\n")
        n = cl.apply_trans()
        if n:
            cl.apply_symm()
        # n == 0: like the reference (asg.c:187-192), the graph stays
        # un-symmetrized; pop_bubble will symm it on first use (asg.c:417)
    if stage >= 7:
        sys.stderr.write("[M::main] ===> Step 4.2: initial tip cutting and "
                         "bubble popping <===\n")
        cl.cut_tip()
        cl.pop_bubble(opt.bub_dist)
    if stage >= 9:
        sys.stderr.write("[M::main] ===> Step 4.3: cutting short overlaps "
                         "(%d rounds in total) <===\n" % (opt.n_rounds + 1))
        for i in range(opt.n_rounds + 1):
            if cl.del_short(i):
                cl.cut_tip()
                cl.pop_bubble(opt.bub_dist)
    if stage >= 10:
        sys.stderr.write("[M::main] ===> Step 4.4: removing short internal "
                         "sequences and bi-loops <===\n")
        cl.cut_internal()
        cl.cut_biloop()
        cl.cut_tip()
        cl.pop_bubble(opt.bub_dist)
    if stage >= 11:
        sys.stderr.write("[M::main] ===> Step 4.5: aggressively cutting "
                         "short overlaps <===\n")
        if cl.del_short(opt.n_rounds + 1):
            cl.cut_tip()
            cl.pop_bubble(opt.bub_dist)
    return cl.g
