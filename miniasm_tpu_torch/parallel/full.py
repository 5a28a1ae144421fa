"""End-to-end sharded pipeline: PAF -> GFA over a process group.

Port of miniasm_tpu/parallel/full.py (_load_originals l.57, _mirror_ranks
l.98, _partition l.126, _make_select_step l.151, run_sharded l.391).
The sharding model is the JAX package's, with one rank (process) per
shard in place of one device of a mesh:

  - reads are partitioned into contiguous id blocks; rank k owns reads
    [k*block, (k+1)*block).  Every original row lives at its QUERY's
    owner and carries its implied mirror as a second lane, so the q-side
    events of a read are rank-local;
  - per sweep pass, the m-side events (target id, clipped interval,
    flags) go to the target's owner: K11 `route` buckets them and one
    all_to_all_single sends them.  Each rank sweeps its q-events plus the
    received m-events with K2 `sweep`;
  - the per-read tables are combined by an owner-masked all_reduce(SUM)
    (the trims) and a MAX reduce (the 0/1 tables, an OR); K1
    `cut_hit2arc` then cuts, classifies and filters every local row
    against the replicated tables, for both passes;
  - the marks are scatter_reduce(amax) per rank, then an OR across ranks;
  - each rank compacts its arcs with their global emission id (gid) and
    hit key; one all_gather brings them to every rank, and rank 0
    restores the reference's exact arc insertion order, builds the
    graph, cleans it and prints.  Under the group, the cleaner's
    detection runs K3 on every rank's block of vertex rows
    (graph/devclean.py); rank 0 alone commits.

Counters are int64 sums (the JAX step's 10-bit split sums are a TPU
choice and go, as in select/fused2.py), and the buffers are exact-size
(no `_round_up` quantum, no arc_cap or tr_cap).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import Opt
from ..core.hit2arc import MA_HT_QCONT, MA_HT_TCONT
from ..select import fused2
from ..utils.timers import StageClock, log
from . import group as grp
from .route import Layout, route

# cumulative per-stage wall times of rank 0's last run_sharded (stage ->
# seconds since the run's start)
LAST_TIMING: dict = {}


def _load_originals(paf_fn, opt, excl):
    """Host load of the unmirrored originals: (8, n) int32 rows in parse
    order (gid row = 2*j, so a mirror is 2*j+1), the SeqDict, and the
    line and mirrored-hit totals."""
    from ..io.native.pafload import load_hits_mt

    cm, d, h3 = load_hits_mt(paf_fn, opt.min_span, opt.min_match,
                             excl=excl, bi_dir=True,
                             min_iden=float(opt.min_iden), upload=False)
    n_lines, n_mirror = h3.n_lines, h3.n_mirror
    h3.free()
    cols = cm.numpy()
    gid = (np.arange(cols.shape[1], dtype=np.int64) * 2).astype(np.int32)
    return np.vstack([cols, gid[None, :]]), d, n_lines, n_mirror


def _mirror_ranks(cols, d):
    """rank[gid] = position of that (original, side) row in the reference's
    radix-sorted mirrored hit array (ksort.h tie permutation via
    utils.exact_sort), used to restore the exact arc insertion order."""
    from ..utils.exact_sort import radix_argsort

    qid = cols[0].astype(np.uint64)
    qs = cols[1].astype(np.uint64)
    tid = cols[3].astype(np.uint64)
    ts = cols[4].astype(np.uint64)
    n = qid.shape[0]
    not_self = cols[0] != cols[3]
    keys = np.empty(2 * n, dtype=np.uint64)
    gids = np.empty(2 * n, dtype=np.int64)
    keys[0::2] = (qid << np.uint64(32)) | qs
    keys[1::2] = (tid << np.uint64(32)) | ts
    gids[0::2] = np.arange(n, dtype=np.int64) * 2
    gids[1::2] = np.arange(n, dtype=np.int64) * 2 + 1
    sel = np.ones(2 * n, dtype=bool)
    sel[1::2] = not_self  # self matches are not mirrored (hit.c:92)
    order = radix_argsort(keys[sel])
    rank = np.full(2 * n, -1, dtype=np.int64)
    rank[gids[sel][order]] = np.arange(len(order), dtype=np.int64)
    return rank


def _partition(cols, n_seq, n_sh):
    """Each original to its query's owner: the per-rank (8, n_k) host
    column blocks in parse order, and the block size."""
    block = grp.block_size(n_seq, n_sh)
    owner = cols[0] // block
    return [np.ascontiguousarray(cols[:, owner == k])
            for k in range(n_sh)], block


def _owner_of(ids, block: int, n_sh: int, valid):
    """Destination shard of each id, n_sh (dropped) where not valid."""
    return torch.where(valid, torch.div(ids, block, rounding_mode="floor"),
                       n_sh).to(torch.int32).contiguous()


def select_step(rows, n_seq: int, block: int, opt, g):
    """Sharded Steps 2-3 on this rank's rows (8, n) int32 [qid qs qe tid ts
    te flags gid], all owned by this rank (qid // block == g.rank).

    Returns (arcmat, meta, counts): arcmat (7, n_arc_local) int32 [u l v ol
    gid hit_key_hi hit_key_lo] of this rank's surviving arcs (hit key =
    qid<<32|qs of the arc's side, original coordinates); meta (6, n_seq)
    int32 [sub_s sub_e sub_del cont used pal], the same on every rank;
    counts [n_rem1, n_cut1, n_flt, n_rem2, n_cut2, m_contained, n_arc,
    tot_dp, tot_len], global."""
    dev = rows.device
    i32, i64 = torch.int32, torch.int64
    n_sh = g.size
    T = n_seq + 2  # slot T-1 is never a real read
    dump = T - 1
    qid, tid, fl, gid = rows[0], rows[3], rows[6], rows[7]
    valid0 = (fl & 1) != 0
    iden = ((fl >> 2) & 1) != 0
    is_self = qid == tid
    not_self = ~is_self
    vq = valid0
    vm = valid0 & not_self
    coords = rows[[1, 2, 4, 5]].contiguous()
    lo, hi = g.block(n_seq)
    own = torch.zeros(T, dtype=torch.bool, device=dev)
    own[lo:hi] = True

    # the exchange layout is fixed for both passes: the m-side payload of
    # row j always goes to tid // block (rows that lose their m-side later
    # travel with their presence bit cleared)
    layout = Layout(_owner_of(tid, block, n_sh, vm), n_sh)
    recv_counts = None

    def exchange(payload):
        nonlocal recv_counts
        recv, recv_counts = g.all_to_all_rows(route(layout, payload),
                                              layout.sizes, recv_counts)
        return recv.t()

    def sweep(coords, vq, vm, end_clip):
        """One ma_hit_sub pass: local q-events + received m-events ->
        this rank's per-read tables (4, T) [s e del has_query]."""
        cqs, cqe, cts, cte = coords[0], coords[1], coords[2], coords[3]
        esq, eeq = cqs + end_clip, cqe - end_clip
        est, eet = cts + end_clip, cte - end_clip
        okq = vq & not_self & iden & (eeq > esq)
        okm = vm & not_self & iden & (eet > est)
        r = exchange(torch.stack([tid, est, eet, vm.to(i32)
                                  | (okm.to(i32) << 1)]).contiguous())
        rpres = (r[3] & 1) != 0
        rok = (r[3] & 2) != 0
        segq = torch.where(vq, qid, T)
        segr = torch.where(rpres, r[0], T)
        seg = torch.cat([segq, segq, segr, segr])
        key = torch.cat([
            torch.where(okq, esq * 2, fused2.SKIP),
            torch.where(okq, eeq * 2 + 1, fused2.SKIP),
            torch.where(rok, r[1] * 2, fused2.SKIP),
            torch.where(rok, r[2] * 2 + 1, fused2.SKIP)])
        return fused2.sweep_events(seg, key, T, opt.min_dp, end_clip)

    def combine(tab):
        """The JAX step's combine_tab for the trims (owner-masked sum) and
        combine_or for the 0/1 tables."""
        se = torch.where(own, tab[:2], 0).contiguous()
        g.all_reduce(se, "sum")
        dh = tab[2:4].contiguous()
        g.all_reduce(dh, "max")
        return torch.cat([se, dh])

    def lanes_of(a, b):
        return (a.to(torch.uint8) | (b.to(torch.uint8) << 1)).contiguous()

    # --- Step 2: crude sweep + cut + relaxed filter (main.c:122-125) ---
    tab1 = combine(sweep(coords, vq, vm, 0))
    s1, e1 = tab1[0], tab1[1]
    out = fused2.cut_hit2arc(rows, coords, lanes_of(vq, vm),
                             tab1[:3].contiguous(), min_span=opt.min_span,
                             max_hang=int(opt.max_hang * 1.5), int_frac=0.5,
                             min_ovlp=int(opt.min_ovlp * 0.5),
                             final_pass=False)
    coords = out[:4].contiguous()
    bits = out[4]
    n_cut1 = (bits & 1).sum() + ((bits >> 1) & 1).sum()
    vq = (bits & 4) != 0
    vm = (bits & 8) != 0
    n_flt = vq.sum() + vm.sum()
    tot_dp = out[5].to(i64).sum()

    # --- Step 3: fine sweep + cut (main.c:132-135); its has_query table is
    #     the crude coverage denominator set ---
    tab2 = combine(sweep(coords, vq, vm, opt.min_span // 2))
    s2, e2 = tab2[0], tab2[1]
    has_flt = tab2[3] != 0
    tot_len = torch.where(has_flt, (e1 - s1).to(i64), 0).sum()
    out = fused2.cut_hit2arc(rows, coords, lanes_of(vq, vm),
                             tab2[:3].contiguous(), min_span=opt.min_span,
                             max_hang=opt.max_hang,
                             int_frac=float(opt.int_frac),
                             min_ovlp=opt.min_ovlp, final_pass=True)
    bits = out[4]
    vq = (bits & 1) != 0
    vm = (bits & 2) != 0
    n_cut2 = vq.sum() + vm.sum()
    qs, qe, ts, te = out[0], out[1], out[2], out[3]
    rq_raw, rm_raw = out[5], out[10]

    # --- merge (ma_sub_merge, hit.c:218-223) ---
    ms = s1 + s2
    me = s1 + e2
    mdel = (tab1[2] != 0) | (tab2[2] != 0)

    # --- containment / used / palindrome marks (hit.c:225-236,
    #     asm.c:9-39): amax per rank, then an OR across ranks ---
    rq = torch.where(vq, rq_raw, 0)
    rm = torch.where(vm, rm_raw, 0)
    rev = ((fl >> 1) & 1) != 0
    vqm = vq | vm
    pal_rows = vq & (rq_raw >= 0) & is_self & (qs == ts) & (qe == te) & rev
    qbits = (vqm.to(i32)
             | (((rq == MA_HT_QCONT) | (rm == MA_HT_TCONT)).to(i32) << 1)
             | (pal_rows.to(i32) << 2))
    tbits = (vqm.to(i32)
             | (((rq == MA_HT_TCONT) | (rm == MA_HT_QCONT)).to(i32) << 1))
    qsl = qid.clamp(0, dump).long()
    tsl = tid.clamp(0, dump).long()
    tab = torch.zeros(T, dtype=i32, device=dev)
    tab.scatter_reduce_(0, qsl, qbits, "amax")
    tab.scatter_reduce_(0, tsl, tbits, "amax")
    marks = torch.stack([tab & 1, (tab >> 1) & 1, (tab >> 2) & 1])
    g.all_reduce(marks, "max")
    used, cont, pal = marks[0] != 0, marks[1] != 0, marks[2] != 0

    # a read survives iff used, not sub-deleted, not contained
    # (hit.c:237-251); arcs touching dropped reads go here
    read_alive = used & ~mdel & ~cont
    aq = read_alive[qsl]
    at = read_alive[tsl]
    m_cont = (vq & aq & at).sum() + (vm & aq & at).sum()
    arc_q = vq & (rq_raw >= 0) & not_self & aq & at
    arc_m = vm & (rm_raw >= 0) & not_self & aq & at
    idx = torch.nonzero(torch.cat([arc_q, arc_m])).flatten()
    arcmat = torch.stack([
        torch.cat([out[6], out[11]])[idx], torch.cat([out[8], out[13]])[idx],
        torch.cat([out[7], out[12]])[idx], torch.cat([out[9], out[14]])[idx],
        torch.cat([gid, gid | 1])[idx], torch.cat([qid, tid])[idx],
        torch.cat([rows[1], rows[4]])[idx]]).contiguous()

    c = torch.stack([n_cut1, n_flt, n_cut2, m_cont,
                     torch.tensor(idx.shape[0], device=dev), tot_dp]).to(i64)
    g.all_reduce(c, "sum")
    n_cut1, n_flt, n_cut2, m_cont, n_arc, tot_dp = [int(x) for x in c.cpu()]
    counts = [int(fused2._n_region(tab1)), n_cut1, n_flt,
              int(fused2._n_region(tab2)), n_cut2, m_cont, n_arc, tot_dp,
              int(tot_len)]
    meta = torch.stack([ms, me, mdel.to(i32), cont.to(i32), used.to(i32),
                        pal.to(i32)])[:, :n_seq].cpu().numpy()
    return arcmat, meta, counts


def gather_arcs(arcmat, g):
    """Every rank's surviving arcs (7, n) in rank order, on every rank, as
    a host array."""
    return torch.cat(g.all_gather_cols(arcmat), dim=1).cpu().numpy()


def order_arcs(allarcs, rank_fn):
    """The reference's arc insertion order over the gathered arcs (as
    pipeline._run_main and full.py:452-484): the stable order by hit key
    is exact unless some graph key (u<<32|l) AND some hit key are both
    duplicated among the survivors; only then rank_fn() gives the full
    exact permutation (rank by gid).  Returns (arcs dict, used_fallback)."""
    u, l, v, ol = (allarcs[k].astype(np.int32) for k in range(4))
    ag = allarcs[4].astype(np.int64)
    keys = ((allarcs[5].astype(np.uint64) << np.uint64(32))
            | allarcs[6].astype(np.uint64))
    ul = (u.astype(np.uint64) << np.uint64(32)) | l.astype(np.uint64)
    su = np.sort(ul)
    need_full = bool(np.any(su[1:] == su[:-1])) if su.size > 1 else False
    if need_full and keys.size > 1:
        ks = np.sort(keys)
        need_full = bool(np.any(ks[1:] == ks[:-1]))
    if need_full:
        order = np.argsort(rank_fn()[ag], kind="stable")
    else:
        order = np.argsort(keys, kind="stable")
    return {"u": u[order], "l": l[order], "v": v[order],
            "ol": ol[order]}, need_full


def log_select(counts):
    """The select step's stderr lines (full.py:440-450)."""
    n_rem1, n_cut1, n_flt, n_rem2, n_cut2, _, _, tot_dp, tot_len = counts
    log("hit_sub", "%d query sequences remain after sub", n_rem1)
    log("hit_cut", "%d hits remain after cut", n_cut1)
    cov = tot_dp / tot_len if tot_len else 0.0
    log("hit_flt", "%d hits remain after filtering; crude coverage after "
        "filtering: %.2f", n_flt, cov)
    sys.stderr.write("[M::main] ===> Step 3: 2-pass (fine) read selection "
                     "<===\n")
    log("hit_sub", "%d query sequences remain after sub", n_rem2)
    log("hit_cut", "%d hits remain after cut", n_cut2)


def finish(d, meta, arcs, m_cont, opt, *, outfmt, fn_reads, stage, out,
           dev, clock, group=None):
    """Rank 0's tail: the graph from the ordered arcs, then -p bed, or the
    clean (detection shared with `group` when given) and -p ug|sg;
    `clock` (utils/timers.py StageClock) times each stage."""
    from ..graph.asg import graph_from_arcs
    from ..gfa.writer import print_subs
    from ..pipeline import _clean_and_print

    with clock.stage("graph_build"):
        g, sub_s, sub_e, _ = graph_from_arcs(
            d, meta[0].astype(np.uint32), meta[1].astype(np.uint32),
            meta[2].astype(bool), meta[3].astype(bool),
            meta[4].astype(bool), meta[5].astype(bool), arcs,
            m_hits=m_cont)
    if outfmt == "bed":
        with clock.stage("print"):
            print_subs(d, sub_s, sub_e, out)
        return None
    sys.stderr.write("[M::main] ===> Step 4: graph cleaning <===\n")
    return _clean_and_print(g, d, sub_s, sub_e, opt=opt, stage=stage,
                            outfmt=outfmt, fn_reads=fn_reads, out=out,
                            dev=dev, clock=clock, group=group)


def run_sharded(paf_fn, opt: Opt, *, outfmt: str = "ug", fn_reads=None,
                stage: int = 100, out=None, excl=None, group=None):
    """Full PAF -> GFA over the process group (default: the one `group.init`
    made); every rank calls it.  Byte-identical to the single-card
    pipeline (same arc insertion order, same graph path).  Rank 0 reads
    the PAF and writes -p ug|sg|bed to `out` (default stdout); the other
    ranks return None.  LAST_TIMING holds rank 0's cumulative stage
    times."""
    from ..graph import devclean

    if outfmt not in ("ug", "sg", "bed"):
        raise ValueError("run_sharded prints -p ug, sg or bed, not %r"
                         % outfmt)
    g = group or grp.current()
    clock = StageClock(LAST_TIMING, g.device)
    rows, n_seq, block, host = shard_rows(paf_fn, opt, excl, g, clock)
    if host is not None:
        sys.stderr.write("[M::main] ===> Step 2: 1-pass (crude) read "
                         "selection <===\n")
    with clock.stage("select"):
        arcmat, meta, counts = select_step(rows, n_seq, block, opt, g)
        del rows
    with clock.stage("gather"):
        allarcs = gather_arcs(arcmat, g)
    if host is None:
        # serve the cleaner's detections until rank 0 releases the group
        devclean.follow(g)
        return None
    cols, d = host
    try:
        log_select(counts)
        with clock.stage("order"):
            arcs, _ = order_arcs(allarcs, lambda: _mirror_ranks(cols, d))
        return finish(d, meta, arcs, counts[5], opt, outfmt=outfmt,
                      fn_reads=fn_reads, stage=stage, out=out or sys.stdout,
                      dev=g.device, group=g, clock=clock)
    finally:
        devclean.release(g)


def shard_rows(paf_fn, opt, excl, g, clock):
    """Rank 0 loads the PAF and scatters each rank its rows.  Returns, on
    every rank, (rows (8, n) on the rank's device, n_seq, block, host):
    host is (cols, SeqDict) on rank 0, None on the others.  `clock`
    times the load, partition and scatter stages."""
    parts = head = host = None
    if g.rank == 0:
        sys.stderr.write("[M::main] ===> Step 1: reading read mappings "
                         "<===\n")
        with clock.stage("load"):
            cols, d, n_lines, n_mirror = _load_originals(paf_fn, opt, excl)
            log("hit_read", "read %d hits; stored %d hits and %d sequences "
                "(%d bp)", n_lines, n_mirror, d.n_seq,
                int(np.sum(d.lens_array(), dtype=np.uint64)))
        with clock.stage("partition"):
            parts, block = _partition(cols, d.n_seq, g.size)
            parts = [torch.from_numpy(p) for p in parts]
        head = (d.n_seq, block)
        host = (cols, d)
    with clock.stage("scatter"):
        n_seq, block = g.broadcast_object(head)
        rows = g.scatter_cols(parts)
    return rows, n_seq, block, host
