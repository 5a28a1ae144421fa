"""End-to-end pipeline driver (reference main.c:32-211), PAF -> GFA.

Port of miniasm_tpu/pipeline.py.  The main path (_run_fast_v2 and the
hybrid branch of _emit):

  0. -R: contained-read prefilter                     [host stream]
  1. PAF load: host C++ parser threads fill pinned
     pieces, each copied and decoded on a side stream
     (K9 decode3), then unpacked into one colmat
     (K10 unpack4)                                    [host -> device]
  2-3. crude + fine read selection, containment,
       arc classification and ordering               [device kernels]
  -p paf: the C++ replay of the cut and filter passes
       over the retained records                      [host]
  order: the reference's arc insertion order          [host]
  4. string-graph build + cleaning                    [device detection +
                                                       host ordered commit]
  5. unitigs (+ -f sequences) + GFA                   [host]

With a snapshot directory (MINIASM_TPU_SNAPSHOT) the main path saves the
Step 3/4 boundary state after the graph build, and a later -p ug|sg|bed
run on the same input and options restores it and skips Steps 1-3
(io/snapshot.py); neither happens with -R, as in the JAX package
(pipeline.py:62-74,318-323).

The staged path (-1, -2, -S below 5; pipeline.py:96-151 and the staged
part of _emit) runs the reference's own control flow pass by pass over a
device-resident hit matrix (core/hits.py): load + mirror + exact sort on
the host, one upload, then sub / cut / filter / sub / cut / merge /
containment on the device (K2 sweep, K5 hit_cut, K6 hit2arc), the graph
built from the surviving hits, and the same cleaning and output.

Step 4 of both paths is the hybrid cleaner unless MINIASM_TPU_CLEAN names
an oracle: `native` (transitive reduction on the device, then the C++
sequential passes, graph/finalize_native.py) or any other value but
`hybrid` (the same reduction, then the Python sequential passes,
graph/seqclean.py), as in the JAX package's _emit (pipeline.py:372-462).

Outputs -p ug|sg|bed|paf, -f and -R on both paths.

Run switches, as in the JAX package: MINIASM_TPU_LOADER=v2 loads the main
path's colmat with the single-pass v2 loader (io/native/pafload.py
load_hits_v2; one copy, no K9/K10) and sends -p paf down the staged path
(pipeline.py:58-61,178); each stage is a profiler range `stage:<name>`,
and MINIASM_TPU_TIMING writes its cumulative end time to stderr
(utils/timers.py StageClock), on every path.
"""

from __future__ import annotations

import io
import os
import sys
import tempfile
import time

import numpy as np
import torch

from .config import Opt
from .device import get_device
from .gfa.writer import print_hits, print_subs, sg_print, ug_print
from .graph.asg import graph_from_arcs
from .unitig.unitig import ug_gen
from .utils import timers
from .utils.timers import log

# cumulative per-stage wall times of the last run (stage -> seconds since
# run start)
LAST_TIMING: dict = {}


def run(paf_fn: str, opt: Opt, *, outfmt: str = "ug",
        fn_reads: str | None = None, stage: int = 100,
        no_first: bool = False, no_second: bool = False,
        bi_dir: bool = True, no_cont: bool = False, out=None,
        device: str | torch.device | None = None,
        snapshot_dir: str | None = None):
    """Assemble `paf_fn` and write -p `outfmt` to `out` (default stdout).
    Runs on `device`: `cuda` unless the caller asks for `cpu`.  -1, -2 or
    a stage below 5 take the staged path, as in the JAX package
    (pipeline.py:58-61), and so does -p paf under MINIASM_TPU_LOADER=v2.
    `snapshot_dir` saves and restores the main path's Step 3/4 boundary
    state."""
    out = out or sys.stdout
    v2 = os.environ.get("MINIASM_TPU_LOADER") == "v2"
    staged = (no_first or no_second or stage < 5
              or (v2 and outfmt == "paf"))
    if outfmt not in ("ug", "sg", "bed", "paf"):
        raise ValueError("unknown output format %r" % outfmt)
    dev = get_device(device)

    timers.EXTRA.clear()
    clock = timers.StageClock(LAST_TIMING, dev)
    emit = dict(opt=opt, stage=stage, outfmt=outfmt, fn_reads=fn_reads,
                out=out, dev=dev, clock=clock)
    if not staged and snapshot_dir and not no_cont and outfmt != "paf":
        from .io.snapshot import load_graph_state

        with clock.stage("restore"):
            st = load_graph_state(snapshot_dir, paf_fn, opt, bi_dir=bi_dir)
        if st is not None:
            d, g, sub_s, sub_e, _sub_del = st
            sys.stderr.write("[M::main] ===> Steps 1-3 restored from "
                             "snapshot <===\n")
            if outfmt == "bed":
                with clock.stage("print"):
                    print_subs(d, sub_s, sub_e, out)
                return None
            sys.stderr.write("[M::main] ===> Step 4: graph cleaning <===\n")
            return _clean_and_print(g, d, sub_s, sub_e, **emit)
    excl = None
    if no_cont:
        from .io.paf import no_cont_prefilter

        sys.stderr.write("[M::main] ===> Step 0: removing contained reads "
                         "<===\n")
        with clock.stage("no_cont"):
            excl = no_cont_prefilter(paf_fn, opt.min_span, opt.min_match,
                                     opt.max_hang, opt.int_frac)
    if staged:
        return _run_staged(paf_fn, excl, no_first, no_second, bi_dir, emit)
    return _run_main(paf_fn, excl, bi_dir, emit,
                     None if no_cont else snapshot_dir, v2)


def _run_main(paf_fn, excl, bi_dir, emit, snapshot_dir, v2=False):
    """The main path: Steps 2-3 fused on the device (select/fused2.py),
    on the colmat of the streamed loader, or of the v2 loader."""
    from .io.native.pafload import load_hits_mt, load_hits_v2
    from .select.fused2 import select_build2

    opt, outfmt, out, clock = (emit[k] for k in ("opt", "outfmt", "out",
                                                 "clock"))
    sys.stderr.write("[M::main] ===> Step 1: reading read mappings <===\n")
    with clock.stage("load+upload"):
        if v2:
            colmat, d, h3 = load_hits_v2(
                paf_fn, opt.min_span, opt.min_match, excl=excl,
                bi_dir=bi_dir, min_iden=float(opt.min_iden),
                device=emit["dev"])
        else:
            colmat, d, h3 = load_hits_mt(
                paf_fn, opt.min_span, opt.min_match, excl=excl,
                bi_dir=bi_dir, min_iden=float(opt.min_iden),
                device=emit["dev"], retain_full=outfmt == "paf")
    log("hit_read", "read %d hits; stored %d hits and %d sequences (%d bp)",
        h3.n_lines, h3.n_mirror, d.n_seq,
        int(np.sum(d.lens_array(), dtype=np.uint64)))

    sys.stderr.write("[M::main] ===> Step 2: 1-pass (crude) read selection <===\n")
    with clock.stage("select+fetch"):
        arcs, md, counts = select_build2(colmat, d, opt, bi_dir=bi_dir,
                                         paf_tables=outfmt == "paf")
        del colmat
    n_rem1, n_cut1, n_flt, n_rem2, n_cut2, m_cont = counts[:6]
    log("hit_sub", "%d query sequences remain after sub", n_rem1)
    log("hit_cut", "%d hits remain after cut", n_cut1)
    cov = md["tot_dp"] / md["tot_len"] if md["tot_len"] else 0.0
    log("hit_flt", "%d hits remain after filtering; crude coverage after "
        "filtering: %.2f", n_flt, cov)
    sys.stderr.write("[M::main] ===> Step 3: 2-pass (fine) read selection <===\n")
    log("hit_sub", "%d query sequences remain after sub", n_rem2)
    log("hit_cut", "%d hits remain after cut", n_cut2)

    if outfmt == "bed":
        # sub-interval dump (-p bed): merged trim tables + containment
        # deletions straight from the select step; no arc ordering needed
        with clock.stage("emit_done"):
            d.mark_deleted(md["sub_del"] | md["cont"])
            d.mark_deleted(~md["used"])
            h3.free()
            log("hit_contained", "%d sequences and %d hits remain after "
                "containment removal", int(np.sum(~d.del_array())), m_cont)
            print_subs(d, md["sub_s"], md["sub_e"], out)
        return None
    if outfmt == "paf":
        with clock.stage("emit_done"):
            _print_paf(h3, d, md, m_cont, opt, out)
        return None

    # Restore the reference's arc insertion order (the exact ksort radix
    # permutation of the mirrored hit array, hit.c:100) over the surviving
    # arcs.  The insertion order matters only through the graph build's
    # (u<<32|l) radix sort (asg.c:75-78 via cleanup), which is payload-
    # oblivious: when no two surviving arcs share a graph key, any order
    # with the right per-key occupants is exact.  When graph keys do
    # collide, the arcs' stable order by mirrored-hit key (qid<<32|qs of
    # their side), in which select_build2 returns them, is still exact as
    # long as no two surviving arcs share a hit key.  Only the double
    # collision falls back to the full exact permutation.
    with clock.stage("order"):
        t_rank = time.time()
        ul = ((arcs["u"].astype(np.uint64) << np.uint64(32))
              | arcs["l"].astype(np.uint64))
        sk = np.sort(ul)
        has_dup = bool(np.any(sk[1:] == sk[:-1])) if sk.size > 1 else False
        if has_dup and counts[7]:
            timers.add_extra("rank.fallback", 1)
            h3.build_rank()
            order = np.argsort(h3.arc_ranks(arcs["idx"]), kind="stable")
            arcs = {k: arcs[k][order] for k in ("u", "l", "v", "ol")}
        h3.free()
        timers.add_extra("rank.join_s", time.time() - t_rank)

    with clock.stage("graph_build"):
        g, sub_s, sub_e, sub_del = graph_from_arcs(
            d, md["sub_s"], md["sub_e"], md["sub_del"], md["cont"],
            md["used"], md["pal"], arcs, m_hits=m_cont)
    if snapshot_dir:
        from .io.snapshot import save_graph_state

        with clock.stage("snapshot"):
            save_graph_state(snapshot_dir, paf_fn, opt, d, g, sub_s, sub_e,
                             sub_del, bi_dir=bi_dir)
    sys.stderr.write("[M::main] ===> Step 4: graph cleaning <===\n")
    return _clean_and_print(g, d, sub_s, sub_e, **emit)


def _print_paf(h3, d, md, m_cont, opt, out):
    """-p paf on the main path (print_hits, main.c:21-30; JAX
    pipeline.py:224-269): the C++ replay re-derives each surviving hit's
    cut coordinates from the per-read trim tables in the exact sorted
    mirrored order and writes to out's file descriptor, or through a
    temporary file when out has none."""
    alive = md["used"] & ~md["sub_del"] & ~md["cont"]
    d.mark_deleted(~alive)
    log("hit_contained", "%d sequences and %d hits remain after "
        "containment removal", int(np.sum(alive)), m_cont)
    tmpf = None
    try:
        out.flush()
        fd = out.fileno()
    except (OSError, AttributeError, io.UnsupportedOperation):
        tmpf = tempfile.TemporaryFile()
        fd = tmpf.fileno()
    try:
        printed = h3.print_paf(md["sub1"], md["sub2"], alive, opt.min_span,
                               int(opt.max_hang * 1.5),
                               int(opt.min_ovlp * 0.5), fd)
        h3.free()
        if printed < 0:
            raise OSError("-p paf output write failed (disk full / broken "
                          "pipe?); output is truncated")
        if printed != m_cont:
            sys.stderr.write("[W::main] -p paf replay printed %d hits, "
                             "kernel counted %d\n" % (printed, m_cont))
        if tmpf is not None:
            tmpf.seek(0)
            data = tmpf.read()
            # the bytes as written: a latin-1 round trip through a text
            # stream would change non-ASCII name bytes
            buf = getattr(out, "buffer", None)
            if buf is not None:
                out.flush()
                buf.write(data)
            else:
                out.write(data.decode("latin-1"))
    finally:
        if tmpf is not None:
            tmpf.close()


def _clean_and_print(g, d, sub_s, sub_e, *, opt, stage, outfmt, fn_reads,
                     out, dev, clock, group=None):
    """Steps 4.1-5 of both paths: the clean MINIASM_TPU_CLEAN names
    (hybrid by default), then -p ug (with -f sequences) or sg.  `group`
    (rank 0 of a sharded run) shares the hybrid cleaner's detections with
    the group's ranks; the oracle modes run on rank 0 alone.  `clock`
    (utils/timers.py StageClock) times each stage."""
    mode = os.environ.get("MINIASM_TPU_CLEAN", "hybrid")
    ug = None
    with clock.stage("clean"):
        if mode == "hybrid":
            # production path: every pass detected on the device, the
            # order-dependent candidates committed on the host in
            # reference scan order (graph/hybrid.py)
            from .graph.hybrid import clean_graph

            g = clean_graph(g, opt, stage, device=dev, group=group)
        else:
            from .graph.clean import del_trans

            if stage >= 6:
                sys.stderr.write("[M::main] ===> Step 4.1: transitive "
                                 "reduction <===\n")
                g = del_trans(g, opt.gap_fuzz, device=dev)
            if mode == "native":
                # the host C++ sequential oracle (graph/finalize_native.py)
                from .graph.finalize_native import finalize_native

                sys.stderr.write("[M::main] ===> Steps 4.2-4.5: graph "
                                 "cleaning (native) <===\n")
                g, ug = finalize_native(g, opt, stage,
                                        do_ug=(outfmt == "ug"))
            else:
                g = _clean_py(g, opt, stage, dev)
    if outfmt != "ug":
        with clock.stage("print"):
            sg_print(g, d, sub_s, sub_e, out)
        return g
    sys.stderr.write("[M::main] ===> Step 5: generating unitigs <===\n")
    with clock.stage("unitig"):
        if ug is None:
            ug = ug_gen(g)
    if fn_reads:
        from .unitig.seq import ug_seq

        with clock.stage("seq"):
            ug_seq(ug, d, sub_s, sub_e, fn_reads)
    with clock.stage("print"):
        ug_print(ug, d, sub_s, sub_e, out)
    return ug


def _clean_py(g, opt, stage, dev):
    """Steps 4.2-4.5 of MINIASM_TPU_CLEAN=py: the sequential Python oracle
    (graph/seqclean.py transliterates the reference passes), stage-gated
    like main.c:160-188; symm's masks are computed on `dev`."""
    from .graph.clean import del_short
    from .graph.seqclean import cut_biloop, cut_internal, cut_tip, pop_bubble

    def tip_bubble(g):
        g, _ = cut_tip(g, opt.max_ext)
        g, _ = pop_bubble(g, opt.bub_dist, dev)
        return g

    if stage >= 7:
        sys.stderr.write("[M::main] ===> Step 4.2: initial tip cutting and "
                         "bubble popping <===\n")
        g = tip_bubble(g)
    if stage >= 9:
        sys.stderr.write("[M::main] ===> Step 4.3: cutting short overlaps "
                         "(%d rounds in total) <===\n" % (opt.n_rounds + 1))
        fmin = np.float32(opt.min_ovlp_drop_ratio)
        fmax = np.float32(opt.max_ovlp_drop_ratio)
        for i in range(opt.n_rounds + 1):
            # float32 arithmetic chain, matching the reference's float
            # ma_opt_t members (main.c:168)
            r = fmin + (fmax - fmin) / np.float32(opt.n_rounds) * np.float32(i)
            g, n_short = del_short(g, r, dev)
            if n_short:
                g = tip_bubble(g)
    if stage >= 10:
        sys.stderr.write("[M::main] ===> Step 4.4: removing short internal "
                         "sequences and bi-loops <===\n")
        g, _ = cut_internal(g, 1)
        g, _ = cut_biloop(g, opt.max_ext)
        g = tip_bubble(g)
    if stage >= 11:
        sys.stderr.write("[M::main] ===> Step 4.5: aggressively cutting "
                         "short overlaps <===\n")
        g, n_short = del_short(g, opt.final_ovlp_drop_ratio, dev)
        if n_short:
            g = tip_bubble(g)
    return g


def _run_staged(paf_fn, excl, no_first, no_second, bi_dir, emit):
    """The staged path (JAX pipeline.py:96-151 and the staged part of
    _emit, pipeline.py:346-398): each pass of Steps 2-3 on its own, gated
    by -1, -2 and -S.  The trim tables are (3, n_seq) int32 [s, e, del] on
    the device, None until a selection pass runs."""
    from .core.hits import build_hits
    from .graph.asg import graph_from_hits
    from .io.paf import load_paf

    opt, stage, outfmt, out, dev, clock = (
        emit[k] for k in ("opt", "stage", "outfmt", "out", "dev", "clock"))
    sys.stderr.write("[M::main] ===> Step 1: reading read mappings <===\n")
    with clock.stage("load+upload"):
        load = load_paf(paf_fn, opt.min_span, opt.min_match, excl=excl)
        d = load.d
        hits = build_hits(load, bi_dir=bi_dir, device=dev)
        del load

    with clock.stage("select"):
        hits, sub = _select_staged(hits, d, opt, stage, no_first, no_second)

    if outfmt in ("bed", "paf") and sub is None:
        # the flag combination never ran a selection pass (-1 with -S<4,
        # or -1 -2): the reference dereferences a NULL sub table here
        # (main.c print_subs/print_hits); the JAX package warns instead
        sys.stderr.write("[W::main] no selection pass ran (-1/-2/-S); "
                         "nothing to print for -p %s\n" % outfmt)
        return None
    sub_s = sub_e = None
    if sub is not None:
        s, e = sub[:2].cpu().numpy()
        sub_s, sub_e = s.view(np.uint32), e.view(np.uint32)
    if outfmt in ("bed", "paf"):
        with clock.stage("print"):
            if outfmt == "bed":
                print_subs(d, sub_s, sub_e, out)
            else:
                print_hits(hits, d, sub_s, sub_e, out)
        return None

    sys.stderr.write("[M::main] ===> Step 4: graph cleaning <===\n")
    with clock.stage("graph_build"):
        g = graph_from_hits(opt, d.lens_array(), d.del_array(), sub, hits)
        del hits
    return _clean_and_print(g, d, sub_s, sub_e, **emit)


def _select_staged(hits, d, opt, stage, no_first, no_second):
    """Steps 2-3 of the staged path, pass by pass as -1, -2 and -S gate
    them; returns (hits, sub): the surviving hits and the (3, n_seq)
    trim tables, None when no selection pass ran."""
    from .select.contained import hit_contained
    from .select.cut import apply_cut
    from .select.filter import flt_coverage, hit_flt
    from .select.subregion import hit_sub, log_sub

    sub = None
    if not no_first:
        sys.stderr.write("[M::main] ===> Step 2: 1-pass (crude) read "
                         "selection <===\n")
        if stage >= 2:
            sub = hit_sub(hits, d.n_seq, opt.min_dp, opt.min_iden, 0)
            log_sub(sub)
            hits = apply_cut(hits, sub, opt.min_span)
            log("hit_cut", "%d hits remain after cut", hits.n)
        if stage >= 3:
            keep, dp = hit_flt(hits, sub, int(opt.max_hang * 1.5),
                               int(opt.min_ovlp * 0.5))
            dp_sum = int(dp.to(torch.int64).sum())
            hits = hits.take(keep)
            log("hit_flt", "%d hits remain after filtering; crude coverage "
                "after filtering: %.2f", hits.n,
                flt_coverage(hits.qid, dp_sum, sub))
    if not no_second:
        sys.stderr.write("[M::main] ===> Step 3: 2-pass (fine) read "
                         "selection <===\n")
        if stage >= 4:
            sub2 = hit_sub(hits, d.n_seq, opt.min_dp, opt.min_iden,
                           opt.min_span // 2)
            log_sub(sub2)
            hits = apply_cut(hits, sub2, opt.min_span)
            log("hit_cut", "%d hits remain after cut", hits.n)
            if not no_first:
                # compose the pass-2 intervals into the pass-1 frame in
                # wrapping (uint32) arithmetic (ma_sub_merge, hit.c:218-223)
                sub = torch.stack([sub[0] + sub2[0], sub[0] + sub2[1],
                                   sub[2] | sub2[2]])
            else:
                sub = sub2
        if stage >= 5:
            hits, sub = hit_contained(opt, d, sub, hits)
    return hits, sub
