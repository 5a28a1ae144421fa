"""Order-independent graph-cleaning passes of the oracle clean modes
(MINIASM_TPU_CLEAN=native|py).  Port of miniasm_tpu/graph/clean.py.

Each pass is a pure function of the pre-pass graph (these passes never
read mid-pass mutations, asg.c), so a data-parallel implementation is
exactly order-equivalent to the reference's sequential scan:

  - del_multi  (asg.c:104-121): keep the first arc per (v, w) in arc order
    -- the K8 dup_mark kernel (csrc/symm.cu) on the uploaded (u, v);
  - del_asymm  (asg.c:124-138): delete u->v lacking complement v'->u' --
    the K7 key_member kernel (utils/arrays.py) on the same columns;
  - del_trans  (asg.c:148-193): Myers transitive reduction -- the K3
    trans_multi kernel of the hybrid cleaner (graph/devclean.py), bit 0;
  - del_short  (asg.c:83-101): per-vertex weak-overlap threshold drop
    (host numpy).

All passes compute a bool deletion mask over the arc array, then recompact
(cleanup) and re-run symm exactly where the reference does.  The graph
stays on the host; the masks are computed on `device`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cuda import P, I64, Kernel, ptr
from ..utils.arrays import (check_cols, check_cuda_cols, key_column,
                            key_member, pack_keys, table_slots)
from ..utils.timers import log
from .asg import Graph, cleanup

CPU = torch.device("cpu")

K_DUP = Kernel("dup_mark", "symm.cu", "ma_dup_mark", [P, P, I64, P, I64, P],
               replaces="miniasm_tpu/graph/clean.py:32")


def dup_mark_plain(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K8: the packed (u, v) keys sorted stably,
    each entry marked when it repeats the key before it in sorted order."""
    check_cols("dup_mark", [u, v])
    key, perm = torch.sort(pack_keys([u, v]), stable=True)
    dup = torch.zeros(key.shape[0], dtype=torch.bool, device=key.device)
    dup[1:] = key[1:] == key[:-1]
    mask = torch.empty_like(dup)
    mask[perm] = dup
    return mask


def dup_mark(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K8.  u, v (n,) int32 arc columns.  Returns (n,) bool: an arc j < i
    has the same (u, v) as arc i."""
    check_cols("dup_mark", [u, v])
    if u.device.type == "cpu" and v.device.type == "cpu":
        return dup_mark_plain(u, v)
    dev = check_cuda_cols("dup_mark", [u, v])
    n = u.shape[0]
    if n >= 2**31:
        raise ValueError("dup_mark: at most 2^31 - 1 arcs")
    mask = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        cap = table_slots(n)
        table = torch.empty(cap, dtype=torch.int32, device=dev)
        K_DUP(ptr(u), ptr(v), n, ptr(table), cap, ptr(mask))
    return mask


def del_multi_mask(u, vcol, device: torch.device = CPU) -> np.ndarray:
    """Mask of duplicate arcs: same (u, v) as an earlier arc (the reference
    keeps the first occurrence in arc order, asg.c:108-115).  Any arc
    order."""
    return dup_mark(key_column(u, device),
                    key_column(vcol, device)).cpu().numpy()


def del_asymm_mask(u, vcol, device: torch.device = CPU) -> np.ndarray:
    """Mask of arcs u->v with no complement v^1 -> u^1 present
    (asg.c:124-138): K7 on the uploaded (u, v), whose needles are the
    same columns swapped, xor 1."""
    uc, vc = key_column(u, device), key_column(vcol, device)
    n = uc.shape[0]
    return ~key_member([uc, vc], n, [vc, uc], n, needle_xor=1).cpu().numpy()


def del_multi(g: Graph, device: torch.device = CPU) -> Graph:
    if g.n_arc:
        mask = del_multi_mask(g.u, g.v, device)
        n = int(mask.sum())
    else:
        n = 0
    if n:
        g.adel |= mask
        g = cleanup(g)
    log("del_multi", "removed %d multi-arcs", n)
    return g


def del_asymm(g: Graph, device: torch.device = CPU) -> Graph:
    if g.n_arc:
        mask = del_asymm_mask(g.u, g.v, device)
        n = int(mask.sum())
    else:
        n = 0
    if n:
        g.adel |= mask
        g = cleanup(g)
    log("del_asymm", "removed %d asymmetric arcs", n)
    return g


def symm(g: Graph, device: torch.device = CPU) -> Graph:
    """asg_symm (asg.c:140-145)."""
    g = del_multi(g, device)
    g = del_asymm(g, device)
    g.is_symm = True
    return g


def del_short(g: Graph, drop_ratio: float,
              device: torch.device = CPU) -> tuple[Graph, int]:
    """Weak-overlap drop (asg.c:83-101): per vertex with >=2 arcs, delete
    the suffix of arcs with ol below av[0].ol * ratio.  ol is non-increasing
    within a vertex (ol = ql - l with a fixed per-read ql), so the
    reference's backward suffix scan equals a plain threshold on slots >= 1.

    The threshold rounding reproduces the C expression
    (uint32)(float(ol0 * ratio) + .499) exactly: f32 multiply, f64 add,
    truncate (asg.c:90).  Returns (graph, n_removed)."""
    if g.n_arc == 0:
        log("del_short", "removed 0 short overlaps")
        return g, 0
    first_ol = np.zeros(g.n_vtx, dtype=np.int64)
    has = g.idx_cnt > 0
    first_ol[has] = g.ol[g.idx_start[has]]
    part = first_ol.astype(np.float32) * np.float32(drop_ratio)
    thres = (part.astype(np.float64) + 0.499).astype(np.uint32).astype(np.int64)

    slot = np.arange(g.n_arc, dtype=np.int64) - g.idx_start[g.u]
    nv = g.idx_cnt[g.u]
    mask = (nv >= 2) & (slot >= 1) & (g.ol < thres[g.u])
    n = int(mask.sum())
    if n:
        g.adel |= mask
        g = cleanup(g)
        g = symm(g, device)
    log("del_short", "removed %d short overlaps", n)
    return g, n


def del_trans(g: Graph, fuzz: int, device: torch.device = CPU) -> Graph:
    """Myers transitive reduction (asg.c:148-193) with K3 (bit 0 of
    trans_multi).  Like the JAX program, the rows hold every CSR arc,
    tombstoned ones included (g.adel is not read)."""
    from .devclean import trans_multi

    V = g.n_vtx
    if g.n_arc == 0 or V == 0:
        log("del_trans", "transitively reduced 0 arcs")
        return g
    first = np.zeros(V + 1, dtype=np.int64)
    np.cumsum(g.idx_cnt, out=first[1:])
    cols = [first, g.v.astype(np.int32), g.l.astype(np.int32),
            g.sdel[np.arange(V) >> 1].astype(np.uint8)]
    first_t, av, al, sdel_v = [torch.from_numpy(np.ascontiguousarray(x))
                               .to(device) for x in cols]
    D = max(int(g.idx_cnt.max()), 1)
    bits = trans_multi(first_t, av, al, sdel_v, D, int(fuzz), True)
    mask = ((bits & 1) != 0).cpu().numpy()
    n = int(mask.sum())
    log("del_trans", "transitively reduced %d arcs", n)
    if n:
        g.adel |= mask
        g = cleanup(g)
        g = symm(g, device)
    return g
