"""ctypes wrapper for the native graph finalizer (io/native/finalize.cpp).
Port of miniasm_tpu/graph/finalize_native.py.

Runs the order-dependent cleaning passes (tips / bubbles / weak-overlap
rounds / internal / bi-loops, main.c:160-188) and unitig generation in C++,
starting from the transitively reduced graph (MINIASM_TPU_CLEAN=native).
The Python implementations (graph/seqclean.py + unitig/unitig.py) produce
identical output (tested).  A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..utils.timers import log
from .asg import Graph, arc_index
from ..unitig.unitig import Unitig, UnitigGraph


class _MaFinalizeOut(ctypes.Structure):
    _fields_ = [
        ("n_arc", ctypes.c_int64),
        ("ul", ctypes.POINTER(ctypes.c_uint64)),
        ("av", ctypes.POINTER(ctypes.c_uint32)),
        ("aol", ctypes.POINTER(ctypes.c_uint32)),
        ("sdel", ctypes.POINTER(ctypes.c_uint8)),
        ("n_utg", ctypes.c_int64),
        ("utg_len", ctypes.POINTER(ctypes.c_uint32)),
        ("utg_circ", ctypes.POINTER(ctypes.c_uint8)),
        ("utg_start", ctypes.POINTER(ctypes.c_uint32)),
        ("utg_end", ctypes.POINTER(ctypes.c_uint32)),
        ("path_off", ctypes.POINTER(ctypes.c_int64)),
        ("n_path", ctypes.c_int64),
        ("path", ctypes.POINTER(ctypes.c_uint64)),
        ("n_uarc", ctypes.c_int64),
        ("uarc_ul", ctypes.POINTER(ctypes.c_uint64)),
        ("uarc_v", ctypes.POINTER(ctypes.c_uint32)),
        ("uarc_ol", ctypes.POINTER(ctypes.c_uint32)),
        ("uarc_cnt", ctypes.POINTER(ctypes.c_uint32)),
        ("counters", ctypes.c_int64 * 64),
    ]


def _arr(ptr, n, dtype):
    if n == 0:
        return np.zeros(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def finalize_native(g: Graph, opt, stage: int, do_ug: bool):
    """Returns (final Graph, UnitigGraph | None)."""
    from ..io.native.build import get_lib

    lib = get_lib()
    lib.ma_graph_finalize.restype = ctypes.POINTER(_MaFinalizeOut)
    lib.ma_graph_finalize.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_int]
    lib.ma_finalize_free.argtypes = [ctypes.POINTER(_MaFinalizeOut)]

    n_seq = g.n_seq
    slen = np.ascontiguousarray(g.slen, dtype=np.uint32)
    sdel = np.ascontiguousarray(g.sdel, dtype=np.uint8)
    ul = (np.asarray(g.u, dtype=np.uint64) << np.uint64(32)) \
        | np.asarray(g.l, dtype=np.uint64)
    ul = np.ascontiguousarray(ul)
    av = np.ascontiguousarray(g.v, dtype=np.uint32)
    aol = np.ascontiguousarray(g.ol, dtype=np.uint32)

    res = lib.ma_graph_finalize(
        n_seq, slen.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        sdel.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        g.n_arc, ul.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        av.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        aol.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        1 if g.is_symm else 0, stage, opt.max_ext, opt.bub_dist,
        opt.n_rounds, float(opt.min_ovlp_drop_ratio),
        float(opt.max_ovlp_drop_ratio), float(opt.final_ovlp_drop_ratio),
        1 if do_ug else 0)
    r = res.contents
    C = list(r.counters)
    log("finalize", "cut %d tips; popped %d bubbles; removed %d short "
        "overlaps; cut %d internal, %d bi-loops",
        C[0], C[1] & 0xFFFFFFFF, C[2], C[3], C[4])

    na = int(r.n_arc)
    ul2 = _arr(r.ul, na, np.uint64)
    gf = Graph(
        u=(ul2 >> np.uint64(32)).astype(np.int32),
        l=(ul2 & np.uint64(0xFFFFFFFF)).astype(np.int32),
        v=_arr(r.av, na, np.uint32).astype(np.int32),
        ol=_arr(r.aol, na, np.uint32).astype(np.int32),
        adel=np.zeros(na, dtype=bool),
        slen=np.asarray(g.slen, dtype=np.uint32),
        sdel=_arr(r.sdel, n_seq, np.uint8).astype(bool),
        idx_start=np.zeros(2 * n_seq, dtype=np.int64),
        idx_cnt=np.zeros(2 * n_seq, dtype=np.int32),
        is_symm=True, is_srt=True)
    gf.idx_start, gf.idx_cnt = arc_index(gf.u, gf.n_vtx)

    ugg = None
    if do_ug:
        nu = int(r.n_utg)
        lens = _arr(r.utg_len, nu, np.uint32)
        circ = _arr(r.utg_circ, nu, np.uint8)
        starts = _arr(r.utg_start, nu, np.uint32)
        ends = _arr(r.utg_end, nu, np.uint32)
        offs = _arr(r.path_off, nu + 1, np.int64)
        path = _arr(r.path, int(r.n_path), np.uint64)
        units = []
        for i in range(nu):
            seg = path[offs[i]:offs[i + 1]]
            a = [(int(x >> np.uint64(32)), int(x & np.uint64(0xFFFFFFFF)))
                 for x in seg]
            units.append(Unitig(len=int(lens[i]), circ=bool(circ[i]),
                                start=int(starts[i]), end=int(ends[i]), a=a))
        nua = int(r.n_uarc)
        uul = _arr(r.uarc_ul, nua, np.uint64)
        ug_g = Graph(
            u=(uul >> np.uint64(32)).astype(np.int32),
            l=(uul & np.uint64(0xFFFFFFFF)).astype(np.int32),
            v=_arr(r.uarc_v, nua, np.uint32).astype(np.int32),
            ol=_arr(r.uarc_ol, nua, np.uint32).astype(np.int32),
            adel=np.zeros(nua, dtype=bool),
            slen=lens, sdel=np.zeros(nu, dtype=bool),
            idx_start=np.zeros(2 * nu, dtype=np.int64),
            idx_cnt=np.zeros(2 * nu, dtype=np.int32),
            is_symm=False, is_srt=True)
        ug_g.idx_start, ug_g.idx_cnt = arc_index(ug_g.u, ug_g.n_vtx)
        ugg = UnitigGraph(u=units, g=ug_g)

    lib.ma_finalize_free(res)
    return gf, ugg
