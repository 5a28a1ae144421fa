"""Stage-boundary snapshots: the port's copy of miniasm_tpu/io/snapshot.py.

MINIASM_TPU_SNAPSHOT=DIR persists the pipeline state at the Step 3/4
boundary (the graph, the per-read trim tables and the SeqDict that the
cleaning and unitig stages consume), keyed by the input PAF's identity
and the options.  A later run with the same input and options restores
it and skips Steps 1-3 (while debugging a Step-4 pass with -S, say).

The format is the JAX package's FORMAT 2 (state.npz + meta.json), so a
snapshot written by either package restores in the other: the option
record holds the JAX package's execution options at the single-card
values the port runs (_JAX_EXEC_OPTS) beside the reference options.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

FORMAT = 2

# miniasm_tpu's Opt fields that the port's Opt lacks: one shard, the
# exact (hybrid) cleaner
_JAX_EXEC_OPTS = {"n_shards": 1, "exact": True}


def _paf_key(paf_fn: str) -> dict:
    st = os.stat(paf_fn)
    return {"paf": os.path.abspath(paf_fn), "size": st.st_size,
            "mtime": st.st_mtime}


def _opt_fields(opt) -> dict:
    return dict(dataclasses.asdict(opt), **_JAX_EXEC_OPTS)


def save_graph_state(dirn: str, paf_fn: str, opt, d, g, sub_s, sub_e,
                     sub_del, bi_dir: bool = True) -> None:
    """Persist the post-Step-3 state (graph built, before cleaning)."""
    os.makedirs(dirn, exist_ok=True)
    np.savez_compressed(
        os.path.join(dirn, "state.npz"),
        u=g.u, l=g.l, v=g.v, ol=g.ol, adel=g.adel, slen=g.slen,
        sdel=g.sdel, idx_start=g.idx_start, idx_cnt=g.idx_cnt,
        sub_s=np.asarray(sub_s), sub_e=np.asarray(sub_e),
        sub_del=np.asarray(sub_del),
        lens=d.lens_array(),
        names=np.array("\0".join(d.names).encode("latin-1")),
        flags=np.array([int(g.is_symm), int(g.is_srt)], np.int32))
    meta = {"format": FORMAT, "key": _paf_key(paf_fn),
            "opt": _opt_fields(opt), "bi_dir": bool(bi_dir),
            "n_seq": d.n_seq}
    with open(os.path.join(dirn, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_graph_state(dirn: str, paf_fn: str, opt, bi_dir: bool = True):
    """Return (d, g, sub_s, sub_e, sub_del) when a valid snapshot for
    this (PAF, options, bi_dir) triple exists, else None."""
    meta_fn = os.path.join(dirn, "meta.json")
    npz_fn = os.path.join(dirn, "state.npz")
    if not (os.path.exists(meta_fn) and os.path.exists(npz_fn)):
        return None
    try:
        with open(meta_fn) as f:
            meta = json.load(f)
    except ValueError:
        return None
    if (meta.get("format") != FORMAT or meta.get("key") != _paf_key(paf_fn)
            or meta.get("opt") != _opt_fields(opt)
            or meta.get("bi_dir") != bool(bi_dir)):
        return None
    from ..graph.asg import Graph
    from .seqdict import SeqDict

    z = np.load(npz_fn)
    names = bytes(z["names"].item()).decode("latin-1")
    d = SeqDict.from_arrays(names.split("\0") if names else [],
                            z["lens"].tolist())
    flags = z["flags"]
    g = Graph(u=z["u"], l=z["l"], v=z["v"], ol=z["ol"], adel=z["adel"],
              slen=z["slen"], sdel=z["sdel"], idx_start=z["idx_start"],
              idx_cnt=z["idx_cnt"], is_symm=bool(flags[0]),
              is_srt=bool(flags[1]))
    return d, g, z["sub_s"], z["sub_e"], z["sub_del"]
