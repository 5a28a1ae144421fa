"""End-to-end pipeline driver (reference main.c:32-211), PAF -> GFA.

Port of the main path of miniasm_tpu/pipeline.py (_run_fast_v2 and the
hybrid branch of _emit):

  1. PAF load (host C++ loader) + one upload        [host -> device]
  2-3. crude + fine read selection, containment,
       arc classification and ordering               [device kernels]
  order: the reference's arc insertion order          [host]
  4. string-graph build + cleaning                    [device detection +
                                                       host ordered commit]
  5. unitigs + GFA                                    [host]

Outputs -p ug|sg|bed.  The other flags of the JAX package (-1, -2, -S
below 5, -R, -f, -p paf, snapshot restore) are not ported yet and raise
NotImplementedError.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .config import Opt
from .device import get_device
from .gfa.writer import print_subs, sg_print, ug_print
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
    Runs on `device`: `cuda` unless the caller asks for `cpu`."""
    out = out or sys.stdout
    if no_first:
        _not_ported("-1 (skip 1-pass selection)")
    if no_second:
        _not_ported("-2 (skip 2-pass selection)")
    if stage < 5:
        _not_ported("-S %d (stages below 5)" % stage)
    if no_cont:
        _not_ported("-R (contained-read prefilter)")
    if fn_reads:
        _not_ported("-f (read sequences)")
    if outfmt == "paf":
        _not_ported("-p paf")
    if outfmt not in ("ug", "sg", "bed"):
        raise ValueError("unknown output format %r" % outfmt)
    dev = get_device(device)

    from .io.native.pafload import load_hits_mt
    from .select.fused2 import select_build2

    t0 = time.time()
    LAST_TIMING.clear()
    timers.EXTRA.clear()

    def tick(name):
        # the stage's device work ends inside its tick
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        LAST_TIMING[name] = time.time() - t0

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

    from .graph.hybrid import clean_graph

    sys.stderr.write("[M::main] ===> Step 4: graph cleaning <===\n")
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
