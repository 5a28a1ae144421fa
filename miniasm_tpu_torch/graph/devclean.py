"""One-pass device graph-cleaning detection: transitive reduction,
symmetry enforcement, and candidate detection for every order-dependent
pass.

Port of miniasm_tpu/graph/devclean.py.  On one entry state it computes,
chained like the reference's pass sequence:

  1. Myers transitive-reduction elimination marks (asg.c:148-193);
  2. multi-arc marks on the post-trans live set (asg.c:104-121);
  3. asymmetric-arc marks on the post-multi live set (asg.c:124-138);
  4. weak-overlap (del_short) marks at EVERY drop ratio of the 4.3/4.5
     schedule on the post-symm live set (asg.c:83-101);
  5. tip / internal / bi-loop candidate vertices (asg_is_utg_end +
     asg_extend classification, asg.c:199-306);
  6. bubble-source candidates (>= 2 live out-arcs, asg.c:420-424).

Chaining masks in one pass is order-equivalent to the reference's
pass-compact-pass sequence because asg_cleanup never re-sorts after the
first sort (the is_srt latch, asg.c:75-78): compaction preserves relative
arc order, so "live slots in slot order" here is the sequence the
reference's next pass scans.

Steps 1-2 are the `trans_multi` kernel (K3, csrc/clean.cu), a group of
lanes per vertex row over the CSR arc list; steps 3-6 are one
cooperative launch of the `clean_stage_b` kernel (K14): steps 3-4 and
each row's live count and first live arc by lane groups per row, the
same shape, then behind a grid-wide sync steps 5-6 by a thread per
vertex.  The arc words, the candidate bytes and the counters come to the
host in one copy.  The host applies the masks and commits the candidates
in reference order (graph/hybrid.py).  Under a process group (the
sharded path) every rank runs K3 on its block of vertex rows
(detect(group=), follow, release).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..cuda import F32, I32, I64, P, SMEM_MAX, Kernel, ptr
from ..device import to_host
from ..utils import timers
from .asg import Graph

# _clean_kernel stage A (l.179-225): transitive-reduction and multi-arc marks
K_TRANS = Kernel(
    "trans_multi", "clean.cu", "ma_trans_multi",
    [P, P, P, P, I64, I64, I32, I32, I32, P],
    replaces="miniasm_tpu/graph/devclean.py:143")

# _clean_kernel stage B (l.236-308): asymmetric arcs, each row's live
# count and first live arc, the weak-overlap masks at every ratio, then
# behind a grid-wide sync the unitig ends and the candidates
K_STAGE_B = Kernel(
    "clean_stage_b", "clean.cu", "ma_clean_stage_b",
    [P, P, P, P, P, I64, I32, P, I32, F32, I32, I32, P, P, P, P],
    replaces="miniasm_tpu/graph/devclean.py:236")
# the ratios an arc's word holds: bits 3..31
MAX_RATIOS = 29

# compare-tensor budget of the plain version: rows * D * D bools per chunk
_CHUNK_ELEMS = 1 << 26


def build_arcs(g: Graph, device: torch.device) -> dict:
    """Per-arc CSR columns and per-vertex delete bits of a compacted graph
    (no tombstones: detection runs right after a cleanup, like every
    reference pass), on `device`."""
    if g.adel.any():
        raise ValueError("detect() requires a compacted graph")
    V = g.n_vtx
    first = np.empty(V + 1, dtype=np.int64)
    first[:V] = g.idx_start
    first[V] = g.n_arc
    cols = {
        "first": first,
        "au": g.u.astype(np.int32), "av": g.v.astype(np.int32),
        "al": g.l.astype(np.int32), "aol": g.ol.astype(np.int32),
        "sdel_v": g.sdel[np.arange(V) >> 1].astype(np.uint8),
    }
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in cols.items()}
    out["V"] = V
    out["D"] = max(int(g.idx_cnt.max()) if g.n_arc else 1, 1)
    return out


def _short_frac_cut() -> float:
    """Exact emulation of the reference's weak-arc threshold rounding
    (asg.c:90): thres = (uint32_t)((float)(ol * ratio) + .499) — an f32
    product, an f64 add of .499, then truncation.  Equivalently:
    thres = floor(part32) + [frac(part32) >= 1 - 0.499_f64].  The cut
    constant is the smallest float32 >= (1 - 0.499) in f64, so the float32
    comparison of the (exact) fraction matches the f64 semantics."""
    c = 1.0 - 0.499  # f64
    c32 = np.float32(c)
    if float(c32) < c:
        c32 = np.nextafter(c32, np.float32(2.0))
    return float(c32)


_FRAC_CUT = _short_frac_cut()


def _ratio_schedule(opt):
    """The 4.3 + 4.5 drop-ratio sequence (main.c:167-188), float32 chain
    like the reference's float ma_opt_t members."""
    fmin = np.float32(opt.min_ovlp_drop_ratio)
    fmax = np.float32(opt.max_ovlp_drop_ratio)
    rs = []
    for i in range(opt.n_rounds + 1):
        rs.append(float(fmin + (fmax - fmin) / np.float32(opt.n_rounds)
                        * np.float32(i)))
    rs.append(float(np.float32(opt.final_ovlp_drop_ratio)))
    return tuple(rs)


def trans_multi_plain(first, av, al, sdel_v, D: int, fuzz: int,
                      do_trans: bool, rows=None):
    """Plain PyTorch version of the trans_multi kernel, the JAX program's
    table form: scatter the CSR rows into (V, D) tables, run the slot loop
    vectorized over rows, then the multi-arc compare.  Returns (A,) uint8
    bits: bit0 eliminated, bit1 multi-arc; with rows = (r0, r1) only the
    bits of the arcs of rows r0..r1-1."""
    dev = av.device
    i32 = torch.int32
    V = first.shape[0] - 1
    A = av.shape[0]
    r0, r1 = rows if rows is not None else (0, V)
    in_rows = torch.zeros(V, dtype=torch.bool, device=dev)
    in_rows[r0:r1] = True
    nv = (first[1:] - first[:-1]).to(i32)
    au = torch.repeat_interleave(torch.arange(V, device=dev), nv.long())
    slots = torch.arange(A, device=dev) - first[:-1][au]
    nbr_v = torch.full((V, D), -1, dtype=i32, device=dev)
    nbr_l = torch.full((V, D), 2**31 - 1, dtype=i32, device=dev)
    nbr_v[au, slots] = av
    nbr_l[au, slots] = al
    slot = torch.arange(D, device=dev)
    in_table = slot[None, :] < nv[:, None]
    elim = torch.zeros((V, D), dtype=torch.bool, device=dev)
    if do_trans:
        last = (nv - 1).clamp(min=0).long()
        bound = torch.where(
            nv > 0, nbr_l.gather(1, last[:, None])[:, 0] + fuzz, 0)
        active = (nv > 0) & (sdel_v == 0) & in_rows
        mark = torch.where(in_table & active[:, None], 1, 0).to(torch.int8)
        step = max(_CHUNK_ELEMS // D // D, 1)
        for i in range(D):
            # slot i is scanned only while still in play (earlier slots'
            # demotions count), so the slots run in order
            scan = torch.nonzero(active & (i < nv)
                                 & (mark[:, i] == 1)).flatten()
            for c0 in range(0, scan.shape[0], step):
                r = scan[c0:c0 + step]
                wi = nbr_v[r, i].long()
                wn_v = nbr_v[wi]
                # the neighbour's row sorted by length: the <= bound mask
                # equals the reference's break on the first violation
                within = nbr_l[wi] + nbr_l[r, i][:, None] <= bound[r][:, None]
                cand = within & (slot[None, :] < nv[wi][:, None])
                hit = (nbr_v[r][:, :, None] == wn_v[:, None, :]) \
                    & cand[:, None, :]
                # duplicate targets demote together
                demote = hit.any(2) & (mark[r] != 0)
                mark[r] = torch.where(demote, 2, mark[r])
        elim = mark == 2
    live = in_table & ~elim
    multi = torch.zeros((V, D), dtype=torch.bool, device=dev)
    step = max(_CHUNK_ELEMS // D // D, 1)
    earlier = slot[None, :] < slot[:, None]  # [j, j2]: j2 before j
    for c0 in range(r0, r1, step):
        c1 = min(c0 + step, r1)
        cv = nbr_v[c0:c1]
        lv = live[c0:c1]
        eq = cv[:, :, None] == cv[:, None, :]
        multi[c0:c1] = (eq & earlier[None] & lv[:, None, :]).any(2) & lv
    bits = elim.to(torch.uint8) | (multi.to(torch.uint8) << 1)
    a0, a1 = int(first[r0]), int(first[r1])
    return bits[au[a0:a1], slots[a0:a1]].contiguous()


def trans_multi(first, av, al, sdel_v, D: int, fuzz: int, do_trans: bool,
                rows=None):
    """K3.  first (V+1,) int64 CSR offsets; av/al (A,) int32 targets and
    lengths (rows sorted by length); sdel_v (V,) uint8.  Returns (A,) uint8
    [bit0 transitively reduced, bit1 multi-arc]; with rows = (r0, r1) the
    bits of the arcs of rows r0..r1-1 only (first[r0]..first[r1])."""
    if av.device.type == "cpu":
        return trans_multi_plain(first, av, al, sdel_v, D, fuzz, do_trans,
                                 rows)
    if first.dtype != torch.int64 or av.dtype != torch.int32 \
            or al.dtype != torch.int32 or sdel_v.dtype != torch.uint8:
        raise TypeError("trans_multi: int64 offsets, int32 arcs, uint8 "
                        "delete bits expected")
    if 3 * 4 * D > SMEM_MAX:  # a row holds 3 int32 per arc
        raise ValueError("trans_multi: a row of %d arcs does not fit the "
                         "kernel's shared memory (at most %d)"
                         % (D, SMEM_MAX // 12))
    V = first.shape[0] - 1
    r0, r1 = rows if rows is not None else (0, V)
    a0, a1 = (0, av.shape[0]) if rows is None else \
        (int(first[r0]), int(first[r1]))
    bits = torch.empty(a1 - a0, dtype=torch.uint8, device=av.device)
    if a1 > a0:
        K_TRANS(ptr(first), ptr(av), ptr(al), ptr(sdel_v), r0, r1 - r0,
                int(D), int(fuzz), 1 if do_trans else 0, ptr(bits))
    return bits


def comp_keys(first, av, bits):
    """The complement test's int64 keys (asg.c:124-138), as the twin
    sorts and searches them: (au, live1, key, q), each arc's source row,
    whether it is live before symm (K3's bits 0 and 1 clear), its key
    u<<32 | v (-1 where not live1), and the key v^1<<32 | u^1 of the arc
    that its complement must be."""
    V = first.shape[0] - 1
    au = torch.repeat_interleave(torch.arange(V, device=av.device),
                                 first[1:] - first[:-1])
    av64 = av.to(torch.int64)
    live1 = (bits & 3) == 0
    key = torch.where(live1, (au << 32) | av64, -1)
    q = ((av64 ^ 1) << 32) | (au ^ 1)
    return au, live1, key, q


def clean_arcs_plain(first, av, aol, bits, ratios, do_symm: bool):
    """Plain PyTorch version of clean_stage_b's arc half: the complement
    test by one int64 torch.sort and searchsorted, each row's live count
    and first live slot by scatters, one mask per ratio.  Returns (res,
    rows): res (3 + R + A,) int32, the counters [elim, multi, asymm, weak
    at each ratio] then one word an arc (bit 0 eliminated, 1 multi, 2
    asymmetric, 3 + k weak at ratio k); rows (2, V) int32 [live arcs,
    first live target (0 without one)]; at most MAX_RATIOS ratios."""
    dev = av.device
    i32, i64 = torch.int32, torch.int64
    R = len(ratios)
    V = first.shape[0] - 1
    A = av.shape[0]
    au, live1, key, q = comp_keys(first, av, bits)
    elim = (bits & 1) != 0
    multi = (bits & 2) != 0

    # asymmetric arcs (asg.c:124-138): live u->v needs a live v^1 -> u^1
    key = torch.sort(key).values
    if A:
        pos = torch.searchsorted(key, q).clamp(max=A - 1)
        has_comp = key[pos] == q
    else:
        has_comp = torch.zeros(0, dtype=torch.bool, device=dev)
    asymm = live1 & ~has_comp
    # downstream masks see the post-symm live set when the graph will be
    # symmetric at their apply point; when trans reduced nothing the
    # reference leaves multi/asymm arcs until pop_bubble symms the graph
    live = (live1 & ~asymm) if do_symm else ~elim

    nlive = torch.zeros(V, dtype=i64, device=dev).scatter_add(
        0, au, live.to(i64))
    arc_id = torch.arange(A, device=dev)
    first_live = torch.full((V,), A, dtype=i64, device=dev).scatter_reduce(
        0, au, torch.where(live, arc_id, A), "amin")
    fa = first_live.clamp(max=max(A - 1, 0))

    # weak-overlap masks at every scheduled ratio (asg.c:83-101); ol is
    # non-increasing in slot order, so "the suffix below the first live
    # arc's threshold" is a plain mask on the non-first live arcs
    words = (elim.to(i32) | (multi.to(i32) << 1) | (asymm.to(i32) << 2))
    counters = [elim.sum(), multi.sum(), asymm.sum()]
    if A:
        first_ol = aol[fa].to(torch.float32)
        is_first = arc_id == first_live[au]
        frac_cut = torch.tensor(np.float32(_FRAC_CUT), device=dev)
        for k, r in enumerate(ratios):
            part = first_ol * torch.tensor(np.float32(r), device=dev)
            base = torch.floor(part)
            thres = (base + (part - base >= frac_cut).to(torch.float32))
            thres = thres.to(i64)
            m = (live & (nlive >= 2)[au] & ~is_first
                 & (aol.to(i64) < thres[au]))
            words |= m.to(i32) << (3 + k)
            counters.append(m.sum())
    else:
        counters += [torch.zeros((), dtype=i64, device=dev)] * R
    fl_v = (torch.where(nlive > 0, av[fa].to(i64), 0) if A
            else torch.zeros(V, dtype=i64, device=dev))
    res = torch.cat([torch.stack(counters).to(i32), words])
    return res, torch.stack([nlive, fl_v]).to(i32)


def clean_ends_plain(nlive, fl_v, sdel_v, max_ext: int):
    """Plain PyTorch version of clean_stage_b's vertex half: the end code
    of every row as a table, the asg_extend walk as max_ext vectorized
    steps.  Returns (V,) uint8 [bit 0 tip, 1 internal, 2 bi-loop, 3
    bubble source]."""
    dev = nlive.device
    i64 = torch.int64
    V = nlive.shape[0]
    nlive = nlive.to(i64)
    fl_v = fl_v.to(i64)
    # unitig-end classification per vertex row (asg.c:204-221):
    # code_row[r] = what asg_is_utg_end(r^1) returns: TIP/MO/MN/ME
    nw = nlive[fl_v ^ 1]
    code_row = torch.where(nlive == 0, 1, torch.where(
        nlive > 1, 2, torch.where(nw != 1, 3, 0)))
    # asg_extend(v, max_ext) (asg.c:223-236)
    vids = torch.arange(V, device=dev)
    cur = vids
    final = torch.full((V,), -1, dtype=i64, device=dev)
    for _ in range(int(max_ext)):
        cc = code_row[cur]
        final = torch.where((final < 0) & (cc != 0), cc, final)
        cur = torch.where(final < 0, fl_v[cur], cur)
    ext_code = torch.where(final < 0, 0, final)
    not_sdel = sdel_v == 0
    start_code = code_row[vids ^ 1]
    tip = not_sdel & (start_code == 1) & (ext_code != 0)
    mn_start = not_sdel & (start_code == 3)
    internal = mn_start & (ext_code == 3)
    biloop = mn_start & (ext_code == 2)
    bubble = not_sdel & (nlive >= 2)
    u8 = torch.uint8
    return (tip.to(u8) | (internal.to(u8) << 1) | (biloop.to(u8) << 2)
            | (bubble.to(u8) << 3))


def _stage_b_size(V: int, A: int, R: int) -> int:
    """int32 words of stage B's buffer: [counters (3 + R) | one word an
    arc (A) | one byte a vertex, padded with zero bytes to a word]."""
    return 3 + R + A + (V + 3) // 4


def clean_stage_b_plain(first, av, aol, bits, sdel_v, ratios,
                        do_symm: bool, max_ext: int):
    """Plain PyTorch version of the clean_stage_b kernel: clean_arcs_plain,
    then clean_ends_plain on its rows, into stage B's buffer (the
    counters, the arc words, the candidate bytes; _stage_b_size)."""
    V = first.shape[0] - 1
    A = av.shape[0]
    R = len(ratios)
    res, rows = clean_arcs_plain(first, av, aol, bits, ratios, do_symm)
    ends = clean_ends_plain(rows[0], rows[1], sdel_v, max_ext)
    buf = torch.zeros(_stage_b_size(V, A, R), dtype=torch.int32,
                      device=av.device)
    buf[:3 + R + A] = res
    buf[3 + R + A:].view(torch.uint8)[:V] = ends
    return buf


def clean_stage_b(first, av, aol, bits, sdel_v, ratios, do_symm: bool,
                  D: int, max_ext: int, *, out=None, grid=None):
    """K14.  first (V+1,) int64 CSR offsets (V even); av/aol (A,) int32
    targets and overlaps; bits: trans_multi's (A,) uint8; sdel_v (V,)
    uint8; ratios: the R drop ratios (R <= 29); D: the longest row.
    Returns stage B's buffer as clean_stage_b_plain, written into `out`
    when given.  On CUDA tensors one cooperative launch, whose blocks and
    lanes a row a list `grid` receives ([0, 0] where V == 0, no launch);
    it raises where the card cannot launch one."""
    R = len(ratios)
    if R > MAX_RATIOS:
        raise ValueError("clean_stage_b: %d drop ratios, an arc's word "
                         "holds at most %d" % (R, MAX_RATIOS))
    V = first.shape[0] - 1
    A = av.shape[0]
    size = _stage_b_size(V, A, R)
    if out is not None and (out.shape != (size,) or out.dtype != torch.int32):
        raise ValueError("clean_stage_b: out must be (%d,) int32" % size)
    if av.device.type == "cpu":
        got = clean_stage_b_plain(first, av, aol, bits, sdel_v, ratios,
                                  do_symm, max_ext)
        return got if out is None else out.copy_(got)
    if first.dtype != torch.int64 or av.dtype != torch.int32 \
            or aol.dtype != torch.int32 or bits.dtype != torch.uint8 \
            or sdel_v.dtype != torch.uint8:
        raise TypeError("clean_stage_b: int64 offsets, int32 arcs, uint8 "
                        "bits and delete bits expected")
    if aol.shape != (A,) or bits.shape != (A,) or sdel_v.shape != (V,) \
            or V % 2:
        raise ValueError("clean_stage_b: shape mismatch (or an odd V)")
    if out is None:
        out = torch.empty(size, dtype=torch.int32, device=av.device)
    rows = torch.empty(2 * V, dtype=torch.int32, device=av.device)
    rs = (ctypes.c_float * max(R, 1))(*[float(np.float32(r))
                                        for r in ratios])
    g = (ctypes.c_int * 2)()
    K_STAGE_B(ptr(first), ptr(av), ptr(aol), ptr(bits), ptr(sdel_v), V,
              int(D), ctypes.addressof(rs), R, _FRAC_CUT,
              1 if do_symm else 0, int(max_ext), ptr(out),
              ptr(out[3 + R + A:]), ptr(rows), ctypes.addressof(g))
    if grid is not None:
        grid[:] = list(g)
    return out


def _stage_a(group, first, av, al, sdel_v, D, fuzz, do_trans):
    """K3 on this rank's block of vertex rows; an all_gather joins the
    ranks' arc bits in row order."""
    V = first.shape[0] - 1
    blocks = [group.block(V, k) for k in range(group.size)]
    f = first.cpu()
    sizes = [int(f[r1] - f[r0]) for r0, r1 in blocks]
    bits = trans_multi(first, av, al, sdel_v, D, fuzz, do_trans,
                       rows=blocks[group.rank])
    return torch.cat(group.all_gather_cols(bits, sizes=sizes))


def follow(group) -> None:
    """The other ranks' side of a sharded clean (rank 0 runs the cleaner
    and calls detect(group=)): for each detection rank 0 announces, take
    its arc table and run K3 on this rank's block of rows, until rank 0
    calls release()."""
    dev = group.device
    while True:
        head = group.broadcast_object()
        if head is None:
            return
        V, A, D, fuzz, do_trans = head
        first = group.broadcast(torch.empty(V + 1, dtype=torch.int64,
                                            device=dev))
        av = group.broadcast(torch.empty(A, dtype=torch.int32, device=dev))
        al = group.broadcast(torch.empty(A, dtype=torch.int32, device=dev))
        sdel_v = group.broadcast(torch.empty(V, dtype=torch.uint8,
                                             device=dev))
        _stage_a(group, first, av, al, sdel_v, D, fuzz, do_trans)


def release(group) -> None:
    """Rank 0: end the other ranks' follow()."""
    group.broadcast_object(None)


def detect(g: Graph, opt, *, do_trans: bool, do_symm: bool = True,
           device: torch.device = torch.device("cpu"), group=None) -> dict:
    """Run detection on the current graph.  Returns a dict with per-arc
    masks (numpy (n_arc,) bool in CSR arc order), candidate vertex masks
    ((n_vtx,) bool), and counters.

    With a group (the counterpart of the JAX detect(mesh=), devclean.py:
    341-386), rank 0 calls this while the other ranks run follow(): every
    rank runs K3 stage A on its block of vertex rows of the table rank 0
    broadcasts, and an all_gather joins the arc bits; the rest of the
    detection runs on rank 0.  Its span `detect` holds `build` (the
    graph's columns to the device) and `fetch` (the copy back, which
    waits for K3 and K14)."""
    timers.count("clean.detects")
    with timers.span("detect"):
        with timers.span("build"):
            c = build_arcs(g, device)
        ratios = _ratio_schedule(opt)
        V, A = c["V"], g.n_arc
        args = (c["first"], c["av"], c["al"], c["sdel_v"], c["D"],
                int(opt.gap_fuzz), do_trans)
        if group is None or A == 0:
            bits = trans_multi(*args)
        else:
            group.broadcast_object((V, A, c["D"], int(opt.gap_fuzz),
                                    do_trans))
            for t in args[:4]:
                group.broadcast(t)
            bits = _stage_a(group, *args)
        # stage B (K14) into one buffer, which comes to the host in one
        # copy: [counters (3 + R) | one word an arc (A) | one byte a vertex]
        R = len(ratios)
        buf = clean_stage_b(c["first"], c["av"], c["aol"], bits, c["sdel_v"],
                            ratios, do_symm, c["D"], int(opt.max_ext))
        with timers.span("fetch"):
            host = to_host(buf).numpy()
        counters = [int(x) for x in host[:3 + R]]
        words = host[3 + R:3 + R + A]
        masks = [((words >> k) & 1).astype(bool) for k in range(3 + R)]
        cands = host[3 + R + A:].view(np.uint8)[:V]
        cands = [((cands >> k) & 1).astype(bool) for k in range(4)]
    return {
        "trans": masks[0], "multi": masks[1], "asymm": masks[2],
        "shorts": [masks[3 + k] for k in range(len(ratios))],
        "ratios": ratios,
        "tip": cands[0], "internal": cands[1], "biloop": cands[2],
        "bubble": cands[3],
        "counters": counters,
    }
