"""Entry points of the port: the single-card forward step and the
multi-rank dry run.

The port's counterpart of __graft_entry__.py (which stays the JAX
package's): `entry` is the same forward step over 4,096 padded hit
columns, here the port's hit_sub (K2 `sweep`), hit_cut (K5) and the rest
of the step in one launch (K6 `hit2arc_tail`); `dryrun_multichip`
assembles the same 5 Mb read set over `group.launch(n)` and holds the
sharded GFA byte-equal to the single-card run.
"""

from __future__ import annotations

import io
import os
import random
import shutil
import tempfile

import numpy as np
import torch


def _example_cols(n_pad=4096, n_seq=512, mirror=True):
    """Small synthetic hit columns, padded to n_pad: (10, n_pad) int32
    [qid qs qe tid ts te ml bl rev valid] and the read count.  With
    mirror=False the bi-directional mirror is left to the consumer (the
    sharded step mirrors internally, reference hit.c:92-98)."""
    from ..core.hits import build_hits
    from ..io.paf import PafLoad
    from ..io.seqdict import SeqDict
    from .simulate import paf_records, simulate

    sim = simulate(genome_len=60_000, coverage=8.0, mean_read=6000, seed=3)
    d = SeqDict()
    rows = list(paf_records(sim))
    cols = {k: [] for k in ("qid", "qs", "qe", "tid", "ts", "te", "ml", "bl",
                            "rev")}
    for qn, ql, qs, qe, strand, tn, tl, ts, te, ml, bl in rows:
        if qe - qs < 2000 or te - ts < 2000 or ml < 100:
            continue
        cols["qid"].append(d.put(qn, ql))
        cols["qs"].append(qs)
        cols["qe"].append(qe)
        cols["tid"].append(d.put(tn, tl))
        cols["ts"].append(ts)
        cols["te"].append(te)
        cols["ml"].append(ml)
        cols["bl"].append(bl)
        cols["rev"].append(1 if strand == "-" else 0)
    load = PafLoad(**{k: np.asarray(v, dtype=np.int32 if k in ("qid", "tid")
                                    else np.uint32)
                      for k, v in cols.items()}, d=d, n_lines=len(rows))
    h = build_hits(load, bi_dir=mirror)
    n = min(h.n, n_pad)
    colmat = np.zeros((10, n_pad), dtype=np.int32)
    colmat[:9, :n] = h.cols[:, :n].numpy()
    colmat[9, :n] = 1  # valid flag
    return colmat, max(d.n_seq, 1)


def entry(device=None):
    """The single-card forward step and its input: (fwd, (colmat,)), colmat
    the (10, 4096) int32 columns of `_example_cols` on `device` (the card
    unless the caller asks for the CPU).  fwd returns (good, u, v, l, ol,
    sub_s, sub_e, sub_del) over every column: good and sub_del bool, sub_s
    and sub_e the uint32 bit patterns as int32, the rest int32."""
    from ..config import Opt
    from ..core import hit2arc as h2a
    from ..core.hits import Hits
    from ..device import get_device
    from ..select import cut, subregion

    opt = Opt()
    colmat, n_seq = _example_cols()
    colmat = torch.from_numpy(colmat).to(get_device(device))

    def fwd(colmat):
        qid, qs, qe, tid, ts, te, ml, bl, rev, valid = colmat
        mvalid = valid != 0
        w = torch.where
        # a padded column keys its events on read n_seq, outside the trim
        # tables, with an empty span: the sweep skips both of its events
        sub = subregion.hit_sub(
            Hits(torch.stack([w(mvalid, qid, n_seq), w(mvalid, qs, 0),
                              w(mvalid, qe, 0), w(mvalid, tid, n_seq + 1),
                              ts, te, ml, bl, rev])),
            n_seq, opt.min_dp, opt.min_iden, 0)
        coords, keep = cut.hit_cut(colmat[:9], sub, opt.min_span)
        # the rest of the step in one launch: the trimmed lengths, hit2arc
        # on the cut columns, good and sub_del
        arcs, good, sub_del = h2a.hit2arc_tail(
            colmat, coords, keep, sub, opt.max_hang, opt.int_frac,
            opt.min_ovlp)
        return (good, arcs[1], arcs[2], arcs[3], arcs[4], sub[0], sub[1],
                sub_del)

    return fwd, (colmat,)


def dryrun_paf(path: str) -> None:
    """The dry run's input: 5 Mb at 12x with 50% random dropout, large
    enough that every order-dependent cleaning pass fires (~1000 tips, ~40
    bubbles, asymmetric arcs, short-overlap drops), so the sharded path is
    held under real cleaning load, not just plumbing."""
    from .simulate import simulate, write_paf

    sim = simulate(genome_len=5_000_000, coverage=12.0, seed=5)
    write_paf(sim, path)
    rng = random.Random(3)
    with open(path) as f:
        kept = [ln for ln in f if rng.random() > 0.5]
    with open(path, "w") as f:
        f.writelines(kept)


def _dryrun_rank(paf: str, out_dir: str) -> None:
    """One rank of the dry run: rank 0 runs the single-card pipeline on its
    device, then every rank runs run_sharded; rank 0 writes both GFAs."""
    from ..config import Opt
    from ..parallel import group as grp
    from ..parallel.full import run_sharded
    from ..pipeline import run

    g = grp.current()
    single = io.StringIO()
    if g.rank == 0:
        run(paf, Opt(), outfmt="ug", out=single, device=g.device)
    sharded = io.StringIO()
    run_sharded(paf, Opt(), outfmt="ug", out=sharded)
    if g.rank == 0:
        for name, buf in (("single", single), ("sharded", sharded)):
            with open(os.path.join(out_dir, name + ".gfa"), "w") as f:
                f.write(buf.getvalue())


def dryrun_multichip(n_devices: int, *, backend=None, device=None) -> str:
    """Run the full pipeline over an n-rank group (`group.launch`: NCCL
    on cards, gloo on the CPU or where `backend` names it): PAF -> sharded
    selection (K11 exchanges, owner-masked all_reduce combines) -> graph
    build -> cleaning with row-sharded detection -> unitigs -> GFA, and
    assert the output is byte-identical to the single-card pipeline on the
    same input.  Prints one line and returns the GFA."""
    from ..parallel import group as grp

    td = tempfile.mkdtemp(prefix="miniasm_dryrun_")
    try:
        paf = os.path.join(td, "reads.paf")
        dryrun_paf(paf)
        grp.launch(n_devices, _dryrun_rank, paf, td, backend=backend,
                   device=device)
        with open(os.path.join(td, "single.gfa")) as f:
            single = f.read()
        with open(os.path.join(td, "sharded.gfa")) as f:
            sharded = f.read()
    finally:
        shutil.rmtree(td, ignore_errors=True)

    if sharded != single:
        raise AssertionError("sharded GFA differs from single-device GFA")
    n_utg = sum(1 for ln in sharded.splitlines() if ln.startswith("S\t"))
    print("dryrun_multichip: n_devices=%d unitigs=%d gfa_bytes=%d "
          "(byte-identical to single-device)"
          % (n_devices, n_utg, len(sharded)), flush=True)
    return sharded
