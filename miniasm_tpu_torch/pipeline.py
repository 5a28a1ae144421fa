"""End-to-end pipeline driver (reference main.c:32-211), PAF -> GFA.

Port of miniasm_tpu/pipeline.py.  The main path (_run_fast_v2 and the
hybrid branch of _emit):

  1. PAF load (host C++ loader) + one upload        [host -> device]
  2-3. crude + fine read selection, containment,
       arc classification and ordering               [device kernels]
  order: the reference's arc insertion order          [host]
  4. string-graph build + cleaning                    [device detection +
                                                       host ordered commit]
  5. unitigs + GFA                                    [host]

The staged path (-1, -2, -S below 5; pipeline.py:96-151 and the staged
part of _emit) runs the reference's own control flow pass by pass over a
device-resident hit matrix (core/hits.py): load + mirror + exact sort on
the host, one upload, then sub / cut / filter / sub / cut / merge /
containment on the device (K2 sweep, K5 hit_cut, K6 hit2arc), the graph
built from the surviving hits, and the same cleaning and output.

Outputs -p ug|sg|bed, and -p paf on the staged path.  The other flags of
the JAX package (-R, -f, the main path's -p paf, snapshot restore) are
not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

import sys
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


def _not_ported(what: str):
    raise NotImplementedError(
        "miniasm_tpu_torch: %s is not ported yet (use miniasm_tpu)" % what)


def run(paf_fn: str, opt: Opt, *, outfmt: str = "ug",
        fn_reads: str | None = None, stage: int = 100,
        no_first: bool = False, no_second: bool = False,
        bi_dir: bool = True, no_cont: bool = False, out=None,
        device: str | torch.device | None = None):
    """Assemble `paf_fn` and write -p `outfmt` to `out` (default stdout).
    Runs on `device`: `cuda` unless the caller asks for `cpu`.  -1, -2 or
    a stage below 5 take the staged path, as in the JAX package
    (pipeline.py:58-61)."""
    out = out or sys.stdout
    staged = no_first or no_second or stage < 5
    if no_cont:
        _not_ported("-R (contained-read prefilter)")
    if fn_reads:
        _not_ported("-f (read sequences)")
    if outfmt == "paf" and not staged:
        _not_ported("-p paf without -1, -2 or -S below 5")
    if outfmt not in ("ug", "sg", "bed", "paf"):
        raise ValueError("unknown output format %r" % outfmt)
    dev = get_device(device)

    t0 = time.time()
    LAST_TIMING.clear()
    timers.EXTRA.clear()

    def tick(name):
        # the stage's device work ends inside its tick
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        LAST_TIMING[name] = time.time() - t0

    if staged:
        return _run_staged(paf_fn, opt, outfmt, stage, no_first, no_second,
                           bi_dir, out, dev, tick)
    return _run_main(paf_fn, opt, outfmt, stage, bi_dir, out, dev, tick)


def _run_main(paf_fn, opt, outfmt, stage, bi_dir, out, dev, tick):
    """The main path: Steps 2-3 fused on the device (select/fused2.py)."""
    from .io.native.pafload import load_hits_mt
    from .select.fused2 import select_build2

    sys.stderr.write("[M::main] ===> Step 1: reading read mappings <===\n")
    colmat, d, h3 = load_hits_mt(
        paf_fn, opt.min_span, opt.min_match, bi_dir=bi_dir,
        min_iden=float(opt.min_iden), device=dev)
    tick("load+upload")
    log("hit_read", "read %d hits; stored %d hits and %d sequences (%d bp)",
        h3.n_lines, h3.n_mirror, d.n_seq,
        int(np.sum(d.lens_array(), dtype=np.uint64)))

    sys.stderr.write("[M::main] ===> Step 2: 1-pass (crude) read selection <===\n")
    arcs, md, counts = select_build2(colmat, d, opt, bi_dir=bi_dir)
    del colmat
    tick("select+fetch")
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
        d.mark_deleted(md["sub_del"] | md["cont"])
        d.mark_deleted(~md["used"])
        h3.free()
        log("hit_contained", "%d sequences and %d hits remain after "
            "containment removal", int(np.sum(~d.del_array())), m_cont)
        print_subs(d, md["sub_s"], md["sub_e"], out)
        tick("emit_done")
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
    tick("order")

    g, sub_s, sub_e, sub_del = graph_from_arcs(
        d, md["sub_s"], md["sub_e"], md["sub_del"], md["cont"],
        md["used"], md["pal"], arcs, m_hits=m_cont)
    tick("graph_build")
    sys.stderr.write("[M::main] ===> Step 4: graph cleaning <===\n")
    return _clean_and_print(g, d, sub_s, sub_e, opt, stage, outfmt, out,
                            dev, tick)


def _clean_and_print(g, d, sub_s, sub_e, opt, stage, outfmt, out, dev,
                     tick):
    """Steps 4.1-5 of both paths: the hybrid clean, then -p ug or sg."""
    from .graph.hybrid import clean_graph

    g = clean_graph(g, opt, stage, device=dev)
    tick("clean")
    if outfmt == "ug":
        sys.stderr.write("[M::main] ===> Step 5: generating unitigs <===\n")
        ug = ug_gen(g)
        tick("unitig")
        ug_print(ug, d, sub_s, sub_e, out)
        tick("print")
        return ug
    sg_print(g, d, sub_s, sub_e, out)
    tick("print")
    return g


def _run_staged(paf_fn, opt, outfmt, stage, no_first, no_second, bi_dir,
                out, dev, tick):
    """The staged path (JAX pipeline.py:96-151 and the staged part of
    _emit, pipeline.py:346-398): each pass of Steps 2-3 on its own, gated
    by -1, -2 and -S.  The trim tables are (3, n_seq) int32 [s, e, del] on
    the device, None until a selection pass runs."""
    from .core.hits import build_hits
    from .graph.asg import graph_from_hits
    from .io.paf import load_paf
    from .select.contained import hit_contained
    from .select.cut import apply_cut
    from .select.filter import flt_coverage, hit_flt
    from .select.subregion import hit_sub, log_sub

    sys.stderr.write("[M::main] ===> Step 1: reading read mappings <===\n")
    load = load_paf(paf_fn, opt.min_span, opt.min_match)
    d = load.d
    hits = build_hits(load, bi_dir=bi_dir, device=dev)
    del load
    tick("load+upload")

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
    tick("select")

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
    if outfmt == "bed":
        print_subs(d, sub_s, sub_e, out)
        tick("print")
        return None
    if outfmt == "paf":
        print_hits(hits, d, sub_s, sub_e, out)
        tick("print")
        return None

    sys.stderr.write("[M::main] ===> Step 4: graph cleaning <===\n")
    g = graph_from_hits(opt, d.lens_array(), d.del_array(), sub, hits)
    del hits
    tick("graph_build")
    return _clean_and_print(g, d, sub_s, sub_e, opt, stage, outfmt, out,
                            dev, tick)
