"""Multi-process pipeline: every process reads its own byte range of the
PAF, and the processes run the sharded select step together.

Port of miniasm_tpu/parallel/multihost.py over torch.distributed, one
rank (process, card) per shard:

  - each process reads only its byte range of the PAF (snapped to line
    boundaries, the 10-field bl carry seeded by a bounded backward scan,
    paf.c:34-67 semantics across the split), interns names locally, and
    the processes agree on the GLOBAL id space by exchanging their name
    tables: ranges are in file order, so merging the per-range
    first-appearance lists in process order reproduces the reference's
    single-stream id assignment (query before target, surviving lines
    only, hit.c:87-88);
  - every process uploads its own rows; K11 `route` buckets them by
    their query's owner and one all_to_all_single repartitions them (the
    JAX `repart`, l.337-357); the sharded select step of full.py runs on
    every rank;
  - one all_gather brings every rank's surviving arcs with their hit keys
    (qid<<32|qs of the arc's side, from the rows themselves) to every
    process: the JAX package's O(arcs) key exchange.  The order by hit
    key is exact unless a graph key AND a hit key are both duplicated;
    only then every record's key columns are all_gathered to rebuild the
    full radix permutation;
  - process 0 builds the graph, cleans it on its own (as the JAX worker
    does, without the mesh) and writes the GFA.

A gzipped input can't be byte-range split: each process spools it to a
local file once and range-reads the spool.

    python -m miniasm_tpu_torch.parallel.multihost --coordinator H:P \\
        --num-procs N --proc-id K --out OUT.gfa in.paf

--coordinator also takes tcp://H:P or file://PATH (a file every process
can reach, for processes of one machine).  Each process runs on the card
cuda:{K % cards} over NCCL, or on the CPU over gloo with
MINIASM_TPU_TORCH_DEVICE=cpu; --backend gloo runs several processes on
one card.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch


# ---------------------------------------------------------------------------
# range splitting + carry seeding (host; copies of the JAX package's)

def spool_gz(paf_fn: str, tmpdir: str) -> str:
    """Decompress a .gz PAF to a local spool file so byte-range splitting
    works (the compressed stream can't seek).  Each process spools its own
    copy: O(file) work per process, but parallel and free of any rank-0
    centralization (the reference reads .paf.gz natively, paf.c:9-20)."""
    import gzip
    import shutil

    out = os.path.join(tmpdir, "spool.paf")
    with gzip.open(paf_fn, "rb") as fi, open(out, "wb") as fo:
        shutil.copyfileobj(fi, fo, 1 << 22)
    return out


def split_ranges(paf_fn: str, n: int):
    """[(off, end)] byte ranges covering the file, snapped so each range
    starts right after a newline (range 0 starts at 0).  Gz streams can't
    seek cheaply -> single range (callers should spool_gz first; the
    worker does)."""
    if paf_fn.endswith(".gz"):
        sys.stderr.write("[W::multihost] gz input not range-splittable; "
                         "process 0 reads it whole (spool_gz to "
                         "parallelize)\n")
        return [(0, os.path.getsize(paf_fn))] + [(0, 0)] * (n - 1)
    size = os.path.getsize(paf_fn)
    cuts = [0]
    with open(paf_fn, "rb") as f:
        for k in range(1, n):
            tgt = size * k // n
            f.seek(tgt)
            f.readline()  # advance to the next line start
            cuts.append(min(f.tell(), size))
    cuts.append(size)
    return [(cuts[k], cuts[k + 1]) for k in range(n)]


def _carry_seed(paf_fn: str, off: int) -> int | None:
    """bl of the nearest complete line with >= 11 fields ending before
    `off` (the reference reuses the previous line's bl for 10-field
    lines, paf.c:56-60); bounded backward scan."""
    if off == 0:
        return None
    win = 1 << 16
    with open(paf_fn, "rb") as f:
        while True:
            start = max(0, off - win)
            f.seek(start)
            buf = f.read(off - start)
            lines = buf.split(b"\n")
            # lines[0] may be partial unless start == 0
            cand = lines[1:-1] if start > 0 else lines[:-1]
            for ln in reversed(cand):
                t = ln.split(b"\t")
                if len(t) >= 11:
                    try:
                        return int(t[10])
                    except ValueError:
                        return None
            if start == 0:
                return None
            win *= 4


def extract_range(paf_fn: str, off: int, end: int, out_fn: str):
    """Copy [off, end) to out_fn and return the bl-carry seed for the
    range (the bl of the nearest complete 11-field line before `off`,
    None at file start), which the loader takes as carry_seed."""
    seed = _carry_seed(paf_fn, off)
    with open(out_fn, "wb") as out, open(paf_fn, "rb") as f:
        f.seek(off)
        left = end - off
        while left > 0:
            chunk = f.read(min(left, 1 << 24))
            if not chunk:
                break
            out.write(chunk)
            left -= len(chunk)
    return seed


# ---------------------------------------------------------------------------
# worker

def _gather_name_tables(names, lens, g):
    """Every process's (names, lens) merged in process order -> (global
    SeqDict, local-id -> global-id map of this process)."""
    from ..io.seqdict import SeqDict

    d = SeqDict()
    gmap = None
    for p, (pnames, plens) in enumerate(g.all_gather_object(
            (list(names), [int(x) for x in lens]))):
        m = np.empty(len(pnames), np.int32)
        for i, nm in enumerate(pnames):
            m[i] = d.put(nm, plens[i])
        if p == g.rank:
            gmap = m
    return d, gmap


def _load_local(paf_fn, opt, rng, tmpdir):
    """Parse this process's byte range into host (7, n) columns with
    LOCAL ids, the local name table (first-appearance order) and the
    range's line count."""
    from ..io.native.pafload import load_hits_mt

    off, end = rng
    whole = off == 0 and end >= os.path.getsize(paf_fn)
    if whole:
        # the whole file (one process): parse the original directly
        part, seed = paf_fn, None
    else:
        part = os.path.join(tmpdir, "part_%d.paf" % off)
        seed = extract_range(paf_fn, off, end, part)
    cm, d, h3 = load_hits_mt(part, opt.min_span, opt.min_match, bi_dir=True,
                             min_iden=float(opt.min_iden), upload=False,
                             carry_seed=seed)
    n_lines = h3.n_lines
    h3.free()
    if not whole:
        os.unlink(part)
    return cm.numpy(), d, n_lines


def _init_method(coordinator: str) -> str:
    if coordinator.startswith(("tcp://", "file://")):
        return coordinator
    return "tcp://" + coordinator


def worker(paf_fn: str, out_fn: str, *, coordinator: str, num_procs: int,
           proc_id: int, backend: str | None = None,
           stats_fn: str | None = None):
    """One process of the multi-process run.  `backend` names the
    torch.distributed backend (default NCCL on a card, gloo on the CPU;
    the device is the card unless MINIASM_TPU_TORCH_DEVICE=cpu); stats_fn
    gets this process's kernel launches (every kernel of the package
    named) and stage times as JSON, and stats_fn + ".route.pt" the
    inputs of its repartition's K11 call."""
    from .. import cuda
    from ..config import Opt
    # the modules of the kernels this process may not launch, so that the
    # launch counts name every kernel
    from ..graph import clean, devbub, devclean  # noqa: F401
    from ..select import cut, filter as _filter  # noqa: F401
    from ..utils import arrays  # noqa: F401
    from ..utils.timers import StageClock, log
    from . import group as grp
    from .full import (_mirror_ranks, _owner_of, finish, gather_arcs,
                       log_select, order_arcs, select_step)
    from .route import Layout, route

    opt = Opt()
    stages = {}
    route_in = None
    # the device is the group's: the clock starts on the host and
    # synchronizes the card from the first stage after the init
    clock = StageClock(stages, torch.device("cpu"))
    with clock.stage("init"):
        g = grp.init(proc_id, num_procs, _init_method(coordinator),
                     backend=backend)
    clock.dev = g.device
    try:
        me, procs, dev = g.rank, g.size, g.device
        cuda.reset_launches()
        import tempfile

        with clock.stage("load"), tempfile.TemporaryDirectory() as td:
            src_fn = spool_gz(paf_fn, td) if paf_fn.endswith(".gz") \
                else paf_fn
            rng = split_ranges(src_fn, procs)[me]
            cols, dloc, n_lines_l = _load_local(src_fn, opt, rng, td)

        # ---- the name tables, then upload + repartition by query owner
        #      (K11 + all_to_all) ----
        with clock.stage("repart"):
            d, gmap = _gather_name_tables(dloc.names, dloc.lens, g)
            n_seq = d.n_seq
            n_local = cols.shape[1]
            not_self = cols[0] != cols[3]
            per = np.array(g.all_gather_object(
                (n_local, n_local + int(np.sum(not_self)), n_lines_l)))
            g_off = int(per[:me, 0].sum())
            n_mirror, n_lines = int(per[:, 1].sum()), int(per[:, 2].sum())
            if n_local:
                cols[0] = gmap[cols[0]]
                cols[3] = gmap[cols[3]]
            gid = ((g_off + np.arange(n_local, dtype=np.int64)) * 2
                   ).astype(np.int32)
            cols = np.vstack([cols, gid[None, :]])
            if me == 0:
                sys.stderr.write("[M::main] ===> Step 1: reading read "
                                 "mappings (multi-host, %d processes) "
                                 "<===\n" % procs)
                log("hit_read",
                    "read %d hits; stored %d hits and %d sequences (%d bp)",
                    n_lines, n_mirror, n_seq,
                    int(np.sum(d.lens_array(), dtype=np.uint64)))

            block = grp.block_size(n_seq, procs)
            local = torch.from_numpy(cols).to(dev)
            layout = Layout(_owner_of(local[0], block, procs,
                                      (local[6] & 1) != 0), procs)
            send = route(layout, local)
            if stats_fn:
                route_in = (layout.dest, local)
            del local
            recv, _ = g.all_to_all_rows(send, layout.sizes)
            rows = recv.t().contiguous()
            del send, recv

        if me == 0:
            sys.stderr.write("[M::main] ===> Step 2: 1-pass (crude) read "
                             "selection <===\n")
        with clock.stage("select"):
            arcmat, meta, counts = select_step(rows, n_seq, block, opt, g)
            del rows
            allarcs = gather_arcs(arcmat, g)

        def rank_fn():
            # every record's key columns, gathered (a collective: the
            # double-collision test reads the gathered arcs, so every
            # process takes this branch together)
            kc = torch.from_numpy(np.ascontiguousarray(cols[[0, 1, 3, 4]]))
            gcols = torch.cat(g.all_gather_cols(kc.to(dev)),
                              dim=1).cpu().numpy()
            # _mirror_ranks reads rows 0 qid, 1 qs, 3 tid, 4 ts
            return _mirror_ranks(np.vstack([gcols[0], gcols[1], gcols[1],
                                            gcols[2], gcols[3]]), d)

        with clock.stage("order"):
            arcs, fell_back = order_arcs(allarcs, rank_fn)
        if fell_back and me == 0:
            sys.stderr.write("[W::multihost] duplicate graph AND hit keys; "
                             "falling back to the full exact-rank "
                             "gather\n")
        if me == 0:
            log_select(counts)
            with open(out_fn, "w") as out:
                finish(d, meta, arcs, counts[5], opt, outfmt="ug",
                       fn_reads=None, stage=100, out=out, dev=dev,
                       clock=clock)
    finally:
        grp.destroy()
    if stats_fn:
        torch.save({"dest": route_in[0].cpu(), "payload": route_in[1].cpu(),
                    "n_sh": procs}, stats_fn + ".route.pt")
        with open(stats_fn, "w") as f:
            json.dump({"rank": me, "device": str(dev), "backend": g.backend,
                       "launches": cuda.launch_counts(),
                       "stages_s": stages}, f)
    return None


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="multi-process miniasm_tpu_torch worker "
        "(torch.distributed)")
    ap.add_argument("--coordinator", required=True,
                    help="H:P, tcp://H:P or file://PATH")
    ap.add_argument("--num-procs", type=int, required=True)
    ap.add_argument("--proc-id", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend [nccl on a card, gloo "
                    "on the CPU]")
    ap.add_argument("--stats", default=None,
                    help="write this process's kernel launches and stage "
                    "times to this JSON file, and its repartition's K11 "
                    "inputs to this path + .route.pt")
    ap.add_argument("paf")
    a = ap.parse_args(argv)
    worker(a.paf, a.out, coordinator=a.coordinator, num_procs=a.num_procs,
           proc_id=a.proc_id, backend=a.backend, stats_fn=a.stats)


if __name__ == "__main__":
    main()
