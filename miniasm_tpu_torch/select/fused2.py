"""Dual-sided selection: Steps 2-3 + arc classification on the device.

Port of miniasm_tpu/select/fused2.py (_select2_kernel, select_build2).
The reference materializes a mirrored hit array (each PAF record pushed
twice with query/target swapped, hit.c:92-98) and runs every pass over 2N
records.  Here every original row carries its implied mirror as a second
lane ("q-side" = the record, "m-side" = its mirror):

  - the coverage sweeps (ma_hit_sub, hit.c:109-160) take 4 events per
    original, unsorted, into the `sweep` kernel (K2, csrc/select.cu),
    which buckets them by read, sorts each read's and sweeps it;
  - cutting (ma_hit_cut, hit.c:162-193), both hit2arc lanes and the filter
    (hit.c:195-216) run fused per row in the `cut_hit2arc` kernel (K1);
  - the containment/used/palindrome marks, the per-read flags row, the
    arc compaction and the stable arc ordering by the mirrored-hit key
    (qid<<32|qs) run in one launch, the `arc_order` kernel (K13, with the
    marks of K12 `read_marks`, which the sharded step launches alone);
  - the counts and the per-read tables come to the host in one copy, then
    the ordered arcs in a second one, sized by their count.

Every kernel has a plain PyTorch twin in this module; the wrapper runs the
twin for CPU tensors and the kernel for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..cuda import F32, I32, I64, P, SMEM_MAX, Kernel, ptr
from ..core.hit2arc import hit2arc, MA_HT_QCONT, MA_HT_TCONT
from ..device import to_host
from ..utils import timers
from ..utils.u32 import as_i32, as_u32
from .cut import cut_project

SKIP = 0x7FFFFFFF  # event key of a skipped event (the JAX program's BIG)

# _cut_pass + both hit2arc lanes (core/hit2arc.py:28) + the filter masks
# and dp values, inside _select2_kernel (fused2.py:305)
K_CUT = Kernel(
    "cut_hit2arc", "select.cu", "ma_cut_hit2arc",
    [P, P, P, P, P, P, I64, I64, I32, I32, F32, I32, I32, P],
    replaces="miniasm_tpu/select/fused2.py:254")
# sweep_events (the event sort and sweep, first longest region per read),
# inside _select2_kernel (fused2.py:305)
K_SWEEP = Kernel(
    "sweep", "select.cu", "ma_sweep_events",
    [P, P, I64, I64, I32, I32, P, P, I32, P],
    replaces="miniasm_tpu/select/fused2.py:131")

# the containment/used/palindrome marks of the final pass, inside
# _select2_kernel (fused2.py:401-426): the sharded step's launch
K_MARKS = Kernel(
    "read_marks", "select.cu", "ma_read_marks",
    [P, P, P, P, I64, I64, P],
    replaces="miniasm_tpu/select/fused2.py:401")
# the marks, the flags row, the arc compaction and the stable hit-key
# order, inside _select2_kernel (fused2.py:401-520)
K_ARCS = Kernel(
    "arc_order", "select.cu", "ma_arc_order",
    [P, P, P, P, P, P, I64, P, I64, I64, P, I64, P, I32, P, P, P, P],
    replaces="miniasm_tpu/select/fused2.py:428")

# rows of the cut_hit2arc output
CUT_ROWS_RELAXED = 6   # qs qe ts te lanes dp
CUT_ROWS_FINAL = 15    # qs qe ts te lanes rq uq vq lq olq rm um vm lm olm


def cut_hit2arc_plain(colmat, coords, lanes, tab, *, min_span, max_hang,
                      int_frac, min_ovlp, final_pass):
    """Plain PyTorch version of the cut_hit2arc kernel (see csrc/select.cu):
    ma_hit_cut against the trim tables `tab` (3, T) [s, e, del], then both
    hit2arc lanes, then (relaxed pass) the filter masks and dp values."""
    qid, tid, flags = colmat[0], colmat[3], colmat[6]
    T = tab.shape[1]
    qi = qid.clamp(0, T - 1).long()
    ti = tid.clamp(0, T - 1).long()
    rq_s, rq_e, rq_d = tab[0][qi], tab[1][qi], tab[2][qi]
    rt_s, rt_e, rt_d = tab[0][ti], tab[1][ti], tab[2][ti]
    alive = (rq_d == 0) & (rt_d == 0)
    rev = ((flags >> 1) & 1).to(torch.bool)
    qs1, qe1, ts1, te1 = cut_project(coords[0], coords[1], coords[2],
                                     coords[3], rev, rq_s, rq_e, rt_s, rt_e)
    w = torch.where
    # clamp + rebase (hit.c:181-184): the e-side min is UNSIGNED (the
    # reference compares int qe against the uint32 ma_sub_t.e)
    qs2 = torch.maximum(qs1, rq_s) - rq_s
    ts2 = torch.maximum(ts1, rt_s) - rt_s
    qe2 = as_i32(torch.minimum(as_u32(qe1), as_u32(rq_e)) - as_u32(rq_s))
    te2 = as_i32(torch.minimum(as_u32(te1), as_u32(rt_e)) - as_u32(rt_s))
    keep = alive & (qe2 - qs2 >= min_span) & (te2 - ts2 >= min_span)
    slq, slt = rq_e - rq_s, rt_e - rt_s
    vq = ((lanes & 1) != 0) & keep
    vm = ((lanes & 2) != 0) & keep
    cq = hit2arc(qid, qs2, qe2, tid, ts2, te2, rev, slq, slt,
                 max_hang, int_frac, min_ovlp)
    cm = hit2arc(tid, ts2, te2, qid, qs2, qe2, rev, slt, slq,
                 max_hang, int_frac, min_ovlp)
    rows = [qs2, qe2, ts2, te2]
    i32 = torch.int32
    if not final_pass:
        def flt_keep(r):
            return (r >= 0) | (r == MA_HT_QCONT) | (r == MA_HT_TCONT)

        def flt_dp(r, sq, st):
            return w(r >= 0, r, w(r == MA_HT_QCONT, sq, st))

        fq = vq & flt_keep(cq["r"])
        fm = vm & flt_keep(cm["r"])
        bits = (vq.to(i32) | (vm.to(i32) << 1) | (fq.to(i32) << 2)
                | (fm.to(i32) << 3))
        dp = (w(fq, flt_dp(cq["r"], slq, slt), 0)
              + w(fm, flt_dp(cm["r"], slt, slq), 0))
        rows += [bits, dp]
    else:
        rows += [vq.to(i32) | (vm.to(i32) << 1)]
        rows += [cq[k] for k in ("r", "u", "v", "l", "ol")]
        rows += [cm[k] for k in ("r", "u", "v", "l", "ol")]
    return torch.stack([x.to(i32) for x in rows])


def cut_hit2arc(colmat, coords, lanes, tab, *, min_span, max_hang, int_frac,
                min_ovlp, final_pass):
    """K1.  colmat (7, n) int32 [qid qs qe tid ts te flags]; coords (4, n)
    int32 current [qs qe ts te]; lanes (n,) uint8 (bit0 q-side valid,
    bit1 m-side valid); tab (3, T) int32 trim tables [s, e, del].
    Returns (6, n) int32 [qs qe ts te lanes dp] for the relaxed pass
    (lanes: bit0/1 survive the cut, bit2/3 also the filter), or (15, n)
    [qs qe ts te lanes, r u v l ol of the q-side, then of the m-side]
    for the final pass."""
    if colmat.device.type == "cpu":
        return cut_hit2arc_plain(colmat, coords, lanes, tab,
                                 min_span=min_span, max_hang=max_hang,
                                 int_frac=int_frac, min_ovlp=min_ovlp,
                                 final_pass=final_pass)
    n = colmat.shape[1]
    T = tab.shape[1]
    if colmat.dtype != torch.int32 or coords.dtype != torch.int32 \
            or tab.dtype != torch.int32 or lanes.dtype != torch.uint8:
        raise TypeError("cut_hit2arc: int32 columns and uint8 lanes expected")
    if coords.shape != (4, n) or lanes.shape != (n,) or tab.shape[0] != 3:
        raise ValueError("cut_hit2arc: shape mismatch")
    out = torch.empty((CUT_ROWS_FINAL if final_pass else CUT_ROWS_RELAXED,
                       n), dtype=torch.int32, device=colmat.device)
    if n:
        K_CUT(ptr(colmat[0]), ptr(colmat[3]), ptr(colmat[6]), ptr(coords),
              ptr(lanes), ptr(tab), T, n, int(min_span), int(max_hang),
              float(np.float32(int_frac)), int(min_ovlp),
              1 if final_pass else 0, ptr(out))
    return out


def sweep_events_plain(seg, key, T: int, min_dp: int, end_clip: int):
    """Plain PyTorch version of the sweep kernel: the events sorted by one
    torch.sort of the int64 key seg<<32 | key (the in-read order is the
    unsigned order of the keys; a seg outside [0, T) is an absent side,
    sorted after every read), then per read the FIRST longest region of
    depth >= min_dp.  The depth is one global cumsum (every valid side
    adds a (+1, -1) pair, so each read's depth starts at 0), and crossings
    alternate start/end globally, so an end crossing's start is the
    previous crossing."""
    seg = torch.where((seg >= 0) & (seg < T), seg, T).to(torch.int64)
    keys = torch.sort((seg << 32) | (key.to(torch.int64) & 0xFFFFFFFF)).values
    dev = keys.device
    i64 = torch.int64
    seg = keys >> 32
    key = keys & 0xFFFFFFFF
    valid = key != SKIP
    is_end = (key & 1) == 1
    pos = key >> 1
    delta = torch.where(valid, torch.where(is_end, -1, 1), 0)
    depth = torch.cumsum(delta, 0)
    old = depth - delta
    start_tr = valid & (old < min_dp) & (depth >= min_dp)
    end_tr = valid & (old >= min_dp) & (depth < min_dp)
    tr = start_tr | end_tr
    ti = torch.nonzero(tr).flatten()
    t_pos = pos[ti]
    t_prev = torch.cat([torch.zeros(1, dtype=i64, device=dev), t_pos[:-1]])
    t_seg = seg[ti]
    length = torch.where(end_tr[ti], t_pos - t_prev, -1)
    best = torch.full((T + 1,), -1, dtype=i64, device=dev).scatter_reduce(
        0, t_seg, length, "amax")
    big = ti.shape[0]
    tie = (length == best[t_seg]) & (length > 0)
    first = torch.full((T + 1,), big, dtype=i64, device=dev).scatter_reduce(
        0, t_seg, torch.where(tie, torch.arange(big, device=dev), big),
        "amin")
    n_ev = torch.zeros(T + 1, dtype=i64, device=dev).scatter_add(
        0, seg, torch.ones_like(seg))
    has_query = n_ev[:T] > 0
    has_region = has_query & (best[:T] > 0)
    fi = first[:T].clamp(max=max(big - 1, 0))
    s = torch.where(has_region, t_prev[fi] - end_clip, 0) if big else \
        torch.zeros(T, dtype=i64, device=dev)
    e = torch.where(has_region, t_pos[fi] + end_clip, 0) if big else \
        torch.zeros(T, dtype=i64, device=dev)
    dele = has_query & ~has_region
    return torch.stack([s, e, dele.to(i64),
                        has_query.to(i64)]).to(torch.int32)


def sweep_events(seg, key, T: int, min_dp: int, end_clip: int, *,
                 smem_cap: int = SMEM_MAX):
    """K2.  seg, key: (n,) int32 events, unsorted: seg the read (outside
    [0, T) for an absent side), key pos*2 + is_end, or SKIP for a skipped
    event (it still marks its read as having a query: hit.c:115,152).
    Returns (4, T) int32 [s, e, del, has_query] per read: the first
    longest region of depth >= min_dp, widened by end_clip (int32 wrap).
    A read's sort takes at most `smem_cap` bytes of registers or shared
    memory, else it runs in device memory; the card tests lower the cap
    to reach the latter."""
    if seg.device.type == "cpu":
        return sweep_events_plain(seg, key, T, min_dp, end_clip)
    return sweep_events_tiers(seg, key, T, min_dp, end_clip,
                              smem_cap=smem_cap)[0]


def sweep_events_tiers(seg, key, T: int, min_dp: int, end_clip: int, *,
                       smem_cap: int = SMEM_MAX):
    """The sweep kernel on CUDA tensors, as sweep_events, and the branches
    its reads took: returns (out, tiers), tiers a (2,) int32 tensor on the
    card [the reads sorted by a block, those of them sorted in device
    memory]; every other read was sorted by a warp in registers."""
    if seg.device.type != "cuda":
        raise ValueError("sweep_events_tiers: CUDA tensors expected")
    if seg.dtype != torch.int32 or key.dtype != torch.int32 \
            or seg.dim() != 1 or key.shape != seg.shape:
        raise TypeError("sweep_events: two 1-D int32 columns of one length "
                        "expected")
    n = seg.shape[0]
    if n >= 1 << 31 or T >= 1 << 31:
        raise ValueError("sweep_events: at most 2**31 - 1 events and reads")
    dev = seg.device
    out = torch.empty((4, T), dtype=torch.int32, device=dev)
    if T == 0:
        return out, torch.zeros(2, dtype=torch.int32, device=dev)
    buf = torch.empty(max(n, 1), dtype=torch.int32, device=dev)
    # csrc/select.cu ma_sweep_events: cnt[T] has[T bytes] nbig ndev total
    # off[T] cur[T] big[T]
    has_words = (T + 3) // 4
    aux = torch.empty(4 * T + 3 + has_words, dtype=torch.int32, device=dev)
    K_SWEEP(ptr(seg), ptr(key), n, T, int(min_dp), int(end_clip), ptr(buf),
            ptr(aux), int(smem_cap), ptr(out))
    return out, aux[T + has_words:T + has_words + 2]


def _sub_pass(colmat, coords, vq, vm, iden, not_self, T, min_dp, end_clip):
    """Coverage sweep over the 4 events per original (ma_hit_sub,
    hit.c:109-160).  A read keeps its table entry (has_query) whenever any
    of its rows' sides is valid, even when all its events are skipped
    (self matches, identity failures): hit.c:115,152."""
    qid, tid = colmat[0], colmat[3]
    cqs, cqe, cts, cte = coords[0], coords[1], coords[2], coords[3]
    okq = vq & not_self & iden
    okm = vm & not_self & iden
    esq = cqs + end_clip
    eeq = cqe - end_clip
    est = cts + end_clip
    eet = cte - end_clip
    okq = okq & (eeq > esq)
    okm = okm & (eet > est)
    segq = torch.where(vq, qid, T)
    segm = torch.where(vm, tid, T)
    seg = torch.cat([segq, segq, segm, segm])
    key = torch.cat([
        torch.where(okq, esq * 2, SKIP), torch.where(okq, eeq * 2 + 1, SKIP),
        torch.where(okm, est * 2, SKIP), torch.where(okm, eet * 2 + 1, SKIP)])
    out = sweep_events(seg, key, T, min_dp, end_clip)
    return out[:3], out[3] != 0


def mark_words(colmat, out, T: int):
    """Per row the mark words of its query (used, contained, palindrome)
    and of its target (used, contained): (query index, query word, target
    index, target word), the indices clamped into [0, T)."""
    i32 = torch.int32
    qid, tid, fl = colmat[0], colmat[3], colmat[6]
    bits = out[4]
    vq = (bits & 1) != 0
    vm = (bits & 2) != 0
    rq_raw, rm_raw = out[5], out[10]
    rq = torch.where(vq, rq_raw, 0)
    rm = torch.where(vm, rm_raw, 0)
    rev = ((fl >> 1) & 1) != 0
    vqm = vq | vm
    pal_rows = (vq & (rq_raw >= 0) & (qid == tid) & (out[0] == out[2])
                & (out[1] == out[3]) & rev)
    qbits = (vqm.to(i32)
             | (((rq == MA_HT_QCONT) | (rm == MA_HT_TCONT)).to(i32) << 1)
             | (pal_rows.to(i32) << 2))
    tbits = (vqm.to(i32)
             | (((rq == MA_HT_TCONT) | (rm == MA_HT_QCONT)).to(i32) << 1))
    return (qid.clamp(0, T - 1).long(), qbits, tid.clamp(0, T - 1).long(),
            tbits)


def read_marks_plain(colmat, out, T: int):
    """Plain PyTorch version of the read_marks kernel: the rows' mark words
    (mark_words) reduced per read by two amax scatters."""
    qi, qbits, ti, tbits = mark_words(colmat, out, T)
    tab = torch.zeros(T, dtype=torch.int32, device=colmat.device)
    tab.scatter_reduce_(0, qi, qbits, "amax")
    tab.scatter_reduce_(0, ti, tbits, "amax")
    return tab


def read_marks(colmat, out, T: int):
    """K12.  colmat (7, n) int32 [qid qs qe tid ts te flags]; out: the
    final-pass output of cut_hit2arc (15, n).  Returns (T,) int32 per
    read: the max over its rows of bit 0 used, bit 1 contained, bit 2
    palindrome (hit.c:225-236, asm.c:9-39).  A max, as both packages
    reduce, not an or: a read with a palindromic self-hit row (5) and a
    row that marks it contained (3) keeps 5."""
    if colmat.device.type == "cpu":
        return read_marks_plain(colmat, out, T)
    n = colmat.shape[1]
    if colmat.dtype != torch.int32 or out.dtype != torch.int32:
        raise TypeError("read_marks: int32 columns expected")
    if out.shape != (CUT_ROWS_FINAL, n):
        raise ValueError("read_marks: the final pass's (15, n) output "
                         "expected")
    if T <= 0:
        raise ValueError("read_marks: at least one read slot expected")
    tab = torch.empty(T, dtype=torch.int32, device=colmat.device)
    K_MARKS(ptr(colmat[0]), ptr(colmat[3]), ptr(colmat[6]), ptr(out), n, T,
            ptr(tab))
    return tab


# arc_order's result: the head [m_contained, n_arc, dup_hit]; `meta` rows
# of n_seq words, of which it writes row 2, the flags row; then the arcs,
# the columns u, v, l, ol, row, each n_arc long.  The caller sizes it by
# the 2n bound on the arcs (tail_words) and writes the other meta rows.
ARC_HEAD = 3
ARC_COLS = 5
META_ROWS = 3        # ms, me, flags
FLAGS_ROW = 2
# the int64 counts at the head of select_build2's fetch buffer: n_rem1,
# n_cut1, n_flt, n_rem2, n_cut2, tot_dp, tot_len
_N_COUNTS = 7
# the most blocks of arc_order's launch (its scratch has room for two
# counts and two list entries a block)
TAIL_GRID = 4096


def tail_words(n: int, n_seq: int, meta: int = META_ROWS) -> int:
    """The int32 words of arc_order's result for n rows: the head, the meta
    rows and the arcs at their 2n bound."""
    return ARC_HEAD + meta * n_seq + ARC_COLS * 2 * n


def arc_live(res, n_seq: int, meta: int = META_ROWS):
    """What arc_order writes into its result: the head (3,), the flags row
    (n_seq,) and the arcs (5, n_arc), u, v, l, ol, row."""
    a0 = ARC_HEAD + meta * n_seq
    f0 = ARC_HEAD + FLAGS_ROW * n_seq
    n_arc = int(res[1])
    return (res[:ARC_HEAD], res[f0:f0 + n_seq],
            res[a0:a0 + ARC_COLS * n_arc].view(ARC_COLS, n_arc))


def arc_order_plain(colmat, out, mdel, n_seq: int, *, meta: int = META_ROWS,
                    res=None):
    """Plain PyTorch version of the arc_order kernel: the marks by
    read_marks_plain, the flags row from them and mdel, the arc rows by
    torch.nonzero in row order (q-side rows, then m-side rows), ordered by
    one stable torch.sort of the int64 hit key read<<32 | start (the
    side's read and ORIGINAL start; the start's sign bit flipped, so the
    order is the signed one of the JAX program's int32 sort keys).  It
    writes what the kernel writes (arc_live), into `res` when given."""
    dev = colmat.device
    i32, i64 = torch.int32, torch.int64
    n = colmat.shape[1]
    T = mdel.shape[0]
    tab = read_marks_plain(colmat, out, T)
    qid, oqs, tid, ots = colmat[0], colmat[1], colmat[3], colmat[4]
    bits = out[4]
    vq = (bits & 1) != 0
    vm = (bits & 2) != 0
    qsl = qid.clamp(0, T - 1).long()
    tsl = tid.clamp(0, T - 1).long()
    alive = ((tab & 1) != 0) & ((tab & 2) == 0) & ~mdel
    aq = alive[qsl]
    at = alive[tsl]
    m_contained = (vq & aq & at).sum() + (vm & aq & at).sum()
    not_self = qid != tid
    arc_q = vq & (out[5] >= 0) & not_self & aq & at
    arc_m = vm & (out[10] >= 0) & not_self & aq & at
    idx = torch.nonzero(torch.cat([arc_q, arc_m])).flatten()
    n_arc = idx.shape[0]
    hkey = ((torch.cat([qsl, tsl])[idx] << 32)
            | ((torch.cat([oqs, ots]).to(i64)[idx] + 2**31) & 0xFFFFFFFF))
    skey, perm = torch.sort(hkey, stable=True)
    dup_hit = (skey[1:] == skey[:-1]).sum()
    idx = idx[perm]
    if res is None:
        res = torch.empty(tail_words(n, n_seq, meta), dtype=i32, device=dev)
    res[:ARC_HEAD] = torch.stack([m_contained,
                                  torch.tensor(n_arc, device=dev), dup_hit])
    f0 = ARC_HEAD + FLAGS_ROW * n_seq
    res[f0:f0 + n_seq] = (mdel.to(i32) | (tab & 2) | ((tab & 1) << 2)
                          | ((tab & 4) << 1))[:n_seq]
    a0 = ARC_HEAD + meta * n_seq
    cols = res[a0:a0 + ARC_COLS * n_arc].view(ARC_COLS, n_arc)
    for j in range(4):
        cols[j] = torch.cat([out[6 + j], out[11 + j]])[idx]
    cols[4] = idx.to(i32)
    return res


def arc_order(colmat, out, mdel, n_seq: int, *, meta: int = META_ROWS,
              res=None, smem_cap: int = SMEM_MAX, grid=None):
    """K13, with K12's marks.  colmat (7, n) int32 [qid qs qe tid ts te
    flags], its starts the ORIGINAL ones; out: the final-pass output of
    cut_hit2arc (15, n); mdel: (T,) bool, the merged sub-deletion; n_seq
    (at most T): the reads of the flags row.  Returns the (tail_words(n,
    n_seq, meta),) int32 result, into `res` when given: the head
    [m_contained, n_arc, dup_hit], `meta` rows of n_seq words, of which it
    writes the flags row (mdel | cont << 1 | used << 2 | pal << 3), then
    the columns u, v, l, ol and row (q-side j, m-side n + j) of the arcs in
    the stable hit-key order, each n_arc long (arc_live).  A read's arcs
    are sorted in registers, or by a block in at most `smem_cap` bytes of
    shared memory, else in device memory; the card tests lower the cap to
    reach the latter.  grid: a list of 4 that receives the launch's
    [blocks, reads a block, the most blocks the card holds, grid syncs]."""
    if colmat.device.type == "cpu":
        return arc_order_plain(colmat, out, mdel, n_seq, meta=meta, res=res)
    return arc_order_tiers(colmat, out, mdel, n_seq, meta=meta, res=res,
                           smem_cap=smem_cap, grid=grid)[0]


def arc_order_tiers(colmat, out, mdel, n_seq: int, *, meta: int = META_ROWS,
                    res=None, smem_cap: int = SMEM_MAX, grid=None):
    """The arc_order kernel on CUDA tensors, as arc_order, and the
    branches its reads took: returns (res, tiers), tiers a (2,) int32
    tensor on the card [the reads sorted by a block, those of them sorted
    in device memory]; every other read was sorted by a warp in
    registers."""
    if colmat.device.type != "cuda":
        raise ValueError("arc_order_tiers: CUDA tensors expected")
    n = colmat.shape[1]
    T = mdel.shape[0]
    dev = colmat.device
    if colmat.dtype != torch.int32 or out.dtype != torch.int32 \
            or mdel.dtype != torch.bool:
        raise TypeError("arc_order: int32 columns, a bool mask expected")
    if colmat.shape[0] != 7 or out.shape != (CUT_ROWS_FINAL, n) \
            or mdel.dim() != 1 or not 0 <= n_seq <= T \
            or meta < META_ROWS:
        raise ValueError("arc_order: shape mismatch")
    if n >= 1 << 30 or not 0 < T < 1 << 31:
        raise ValueError("arc_order: at most 2**30 - 1 rows and 2**31 - 1 "
                         "reads")
    size = tail_words(n, n_seq, meta)
    if res is None:
        res = torch.empty(size, dtype=torch.int32, device=dev)
    elif res.shape != (size,) or res.dtype != torch.int32:
        raise ValueError("arc_order: res must be (%d,) int32" % size)
    # one allocation of scratch (csrc/select.cu ma_arc_order): the int64
    # keys, the buckets [2n] and the blocks' lists [2n + 2 TAIL_GRID]; then
    # the int32 words tab[T] cnt[T] cur[T] bsum[2 TAIL_GRID] aux[2], the
    # lists' reads [2n + 2 TAIL_GRID] and a byte a row
    lst = 2 * n + 2 * TAIL_GRID
    k = 2 * n + lst
    words = 3 * T + 2 * TAIL_GRID + 2 + lst + (n + 3) // 4
    scratch = torch.empty(k + (words + 1) // 2, dtype=torch.int64,
                          device=dev)
    g = (ctypes.c_int * 4)()
    base = ptr(res)
    K_ARCS(ptr(colmat[0]), ptr(colmat[1]), ptr(colmat[3]), ptr(colmat[4]),
           ptr(colmat[6]), ptr(out), n, ptr(mdel.view(torch.uint8)), T,
           n_seq, scratch.data_ptr() + 8 * k, TAIL_GRID, scratch.data_ptr(),
           int(smem_cap), base, base + 4 * (ARC_HEAD + FLAGS_ROW * n_seq),
           base + 4 * (ARC_HEAD + meta * n_seq), ctypes.addressof(g))
    if grid is not None:
        grid[:] = list(g)
    a = 2 * k + 3 * T + 2 * TAIL_GRID
    return res, scratch.view(torch.int32)[a:a + 2]


def select_build2(colmat, d, opt, *, bi_dir: bool, paf_tables: bool = False):
    """Run Steps 2-3 on colmat's device.  Returns (arcs, md, counts):
    arcs = numpy {u, v, l, ol, idx} in the stable hit-key order; md =
    numpy {sub_s, sub_e, sub_del, cont, used, pal, tot_dp, tot_len};
    counts = [n_rem1, n_cut1, n_flt, n_rem2, n_cut2, m_contained, n_arc,
    dup_hit]: counters 0-6 and 13 of the JAX program.  paf_tables adds
    md["sub1"] and md["sub2"], each pass's per-read (s, e, del) as int32,
    int32, uint8 arrays, for the -p paf replay (HitsMt.print_paf).  Its
    spans: `enqueue`, the host's launching of the layer's work, and
    `fetch`, the two copies to the host, which wait for the card."""
    n_seq = d.n_seq
    timers.count("select.hits", colmat.shape[1])
    with timers.span("enqueue"):
        buf, meta = _enqueue(colmat, n_seq, opt, bi_dir, paf_tables)
    m0 = 2 * _N_COUNTS
    a0 = m0 + ARC_HEAD + meta * n_seq  # the arcs
    # two copies: the counts, the head and the meta rows, then the arcs at
    # their own size (the second copy reuses the staging block: the first
    # is read out before it)
    with timers.span("fetch"):
        host = to_host(buf[:a0]).numpy()
        (n_rem1, n_cut1, n_flt, n_rem2, n_cut2, tot_dp,
         tot_len) = (int(x) for x in host[:m0].view(np.int64))
        m_contained, n_arc, dup_hit = (int(x)
                                       for x in host[m0:m0 + ARC_HEAD])
        meta_h = host[m0 + ARC_HEAD:a0].reshape(meta, n_seq).copy()
        cols = (to_host(buf[a0:a0 + ARC_COLS * n_arc]).numpy()
                .reshape(ARC_COLS, n_arc) if n_arc
                else np.zeros((ARC_COLS, 0), np.int32))
    timers.count("select.arcs", n_arc)
    c = [n_rem1, n_cut1, n_flt, n_rem2, n_cut2, m_contained, n_arc, dup_hit]
    arcs = {k: cols[j].copy() for j, k in enumerate(("u", "v", "l", "ol"))}
    arcs["idx"] = cols[4].astype(np.int64)
    flags = meta_h[FLAGS_ROW]
    md = {
        "sub_s": meta_h[0].astype(np.uint32),
        "sub_e": meta_h[1].astype(np.uint32),
        "sub_del": (flags & 1).astype(bool),
        "cont": ((flags >> 1) & 1).astype(bool),
        "used": ((flags >> 2) & 1).astype(bool),
        "pal": ((flags >> 3) & 1).astype(bool),
        "tot_dp": tot_dp,
        "tot_len": tot_len,
    }
    if paf_tables:
        for k, r in (("sub1", 3), ("sub2", 6)):
            md[k] = (meta_h[r], meta_h[r + 1], meta_h[r + 2].astype(np.uint8))
    return arcs, md, c


def _enqueue(colmat, n_seq, opt, bi_dir, paf_tables):
    """Launch Steps 2-3 on colmat's device into one buffer [7 int64
    counts | K13's head, meta rows and arcs]; returns (buffer, number of
    meta rows)."""
    dev = colmat.device
    i32, i64 = torch.int32, torch.int64
    T = n_seq + 2  # slot T-1 is never a real read
    n = colmat.shape[1]
    qid, tid, fl = colmat[0], colmat[3], colmat[6]
    valid0 = (fl & 1) != 0
    iden = ((fl >> 2) & 1) != 0
    not_self = qid != tid
    vq = valid0
    vm = valid0 & not_self if bi_dir else torch.zeros_like(valid0)
    # rows stacked, not fancy-indexed: the path launches no index kernel,
    # whose first launch in a process loads its module (about 18 ms)
    coords = torch.stack([colmat[1], colmat[2], colmat[4], colmat[5]])

    def lanes_of(a, b):
        return (a.to(torch.uint8) | (b.to(torch.uint8) << 1)).contiguous()

    # --- Step 2: crude sweep, end_clip=0 (main.c:122) + cut + relaxed
    #     filter (main.c:125; hit.c:195-216) ---
    tab1, _ = _sub_pass(colmat, coords, vq, vm, iden, not_self, T,
                               opt.min_dp, 0)
    s1, e1, d1 = tab1[0], tab1[1], tab1[2] != 0
    out = cut_hit2arc(colmat, coords, lanes_of(vq, vm), tab1.contiguous(),
                      min_span=opt.min_span,
                      max_hang=int(opt.max_hang * 1.5), int_frac=0.5,
                      min_ovlp=int(opt.min_ovlp * 0.5), final_pass=False)
    coords = out[:4]
    bits = out[4]
    n_cut1 = (bits & 1).sum() + ((bits >> 1) & 1).sum()
    vq = (bits & 4) != 0
    vm = (bits & 8) != 0
    n_flt = vq.sum() + vm.sum()
    dpv = out[5].to(i64)
    tot_dp = dpv.sum()

    # --- Step 3: fine sweep, end_clip=min_span/2 (main.c:132) + cut; its
    #     has_query table == "read kept a hit after the filter", the crude
    #     coverage denominator set ---
    tab2, has_flt = _sub_pass(colmat, coords, vq, vm, iden,
                                     not_self, T, opt.min_dp,
                                     opt.min_span // 2)
    s2, e2, d2 = tab2[0], tab2[1], tab2[2] != 0
    sl1 = (e1 - s1).to(i64)
    tot_len = torch.where(has_flt, sl1, 0).sum()
    out = cut_hit2arc(colmat, coords.contiguous(), lanes_of(vq, vm),
                      tab2.contiguous(), min_span=opt.min_span,
                      max_hang=opt.max_hang, int_frac=float(opt.int_frac),
                      min_ovlp=opt.min_ovlp, final_pass=True)
    bits = out[4]
    vq = (bits & 1) != 0
    vm = (bits & 2) != 0
    n_cut2 = vq.sum() + vm.sum()

    # --- merge (ma_sub_merge, hit.c:218-223) ---
    mdel = d1 | d2

    # --- the containment / used / palindrome marks (hit.c:225-236,
    #     asm.c:9-39), the flags row, and the arcs between surviving reads
    #     (hit.c:237-251), compacted and ordered by their mirrored-hit key
    #     (qid<<32|qs of the side, ORIGINAL coordinates: the reference sorts
    #     hits before cutting, hit.c:100), ties in row order: K13, one
    #     launch, into one buffer [7 int64 counts | head | meta rows | arcs
    #     at a stride of n_arc]; the merged trims ms = s1 + s2, me = s1 +
    #     e2 and the -p paf tables fill the other meta rows ---
    meta = META_ROWS + (6 if paf_tables else 0)
    m0 = 2 * _N_COUNTS
    a0 = m0 + ARC_HEAD + meta * n_seq  # the arcs
    buf = torch.empty(m0 + tail_words(n, n_seq, meta), dtype=i32, device=dev)
    arc_order(colmat, out, mdel, n_seq, meta=meta, res=buf[m0:])
    buf[:m0].view(i64).copy_(torch.stack([
        _n_region(tab1), n_cut1, n_flt, _n_region(tab2), n_cut2, tot_dp,
        tot_len]))
    rows = buf[m0 + ARC_HEAD:a0].view(meta, n_seq)
    torch.add(s1[:n_seq], s2[:n_seq], out=rows[0])
    torch.add(s1[:n_seq], e2[:n_seq], out=rows[1])
    if paf_tables:
        # the JAX program's s|del<<31 rows (fused2.py:506-514), unpacked
        rows[META_ROWS:].copy_(torch.stack([
            tab1[0] & 0x7FFFFFFF, e1, d1.to(i32), tab2[0] & 0x7FFFFFFF, e2,
            d2.to(i32)])[:, :n_seq])
    return buf, meta


def _n_region(tab):
    """Reads with a depth >= min_dp region (the n_rem counter)."""
    return (tab[0] != tab[1]).sum()
