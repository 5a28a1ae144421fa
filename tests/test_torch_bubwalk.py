"""The bubble pass's native walk (miniasm_tpu_torch/graph/devbub.py
bubble_walk, io/native/bubwalk.cpp) against its Python spec
(tests/bubwalk_spec.py) on the same K4 verdicts: the braid and random
graphs of tests/test_hybrid_clean.py and tests/test_torch_clean.py, and
graphs built to take each path (stale sources redone by the host BFS,
verdicts failed by a back arc or the distance, visited sets past the
starting K).  The arc and read tombstones, the packed return and the three
counters are compared exactly."""

import copy

import numpy as np
import pytest
import torch

import bubwalk_spec as spec
from miniasm_tpu_torch.graph import devbub
from miniasm_tpu_torch.graph.asg import Graph, cleanup
from miniasm_tpu_torch.utils import timers
from test_torch_clean import _bubble_graph, _graph, port_opt

CPU = torch.device("cpu")
BUB_DIST = port_opt().bub_dist


def _case(kind, seed, tomb=False):
    g = Graph.from_arrays(_graph(kind, seed) if kind == "dense"
                          else _bubble_graph(kind, seed))
    if tomb:
        g.adel[::7] = True  # deleted arcs: the back-arc test still reads them
    return g


def _sources(g):
    live = np.array([g.live_out(v) for v in range(g.n_vtx)])
    return np.flatnonzero(live >= 2).astype(np.int32)


def _walk_both(g, max_dist, K, cands=None):
    """The spec and the native walk on copies of g over one dispatch from
    K; asserts equal results and returns (the walk's tuple, the final K,
    the verdicts' ok row)."""
    cands = _sources(g) if cands is None else cands
    ver = devbub._dispatch(g, cands, max_dist, K, CPU)
    g_spec, g_nat = copy.deepcopy(g), copy.deepcopy(g)
    want = spec.walk(g_spec, cands, ver, max_dist)
    got = devbub.bubble_walk(g_nat, cands, ver, max_dist)
    assert got == want
    assert np.array_equal(g_nat.adel, g_spec.adel)
    assert np.array_equal(g_nat.sdel, g_spec.sdel)
    assert g_nat.adel.dtype == bool and g_nat.sdel.dtype == bool
    return got, ver[-1], ver[0]


@pytest.mark.parametrize("K", [4, 64])
@pytest.mark.parametrize("tomb", [False, True])
@pytest.mark.parametrize("max_dist", [BUB_DIST, 9000])
@pytest.mark.parametrize("kind,seed", [("braid", s) for s in range(6)]
                         + [("random", 0), ("random", 2), ("dense", 1)])
def test_walk_matches_spec(kind, seed, max_dist, tomb, K):
    g = _case(kind, seed, tomb)
    got, _, _ = _walk_both(g, max_dist, K)
    assert got[1] == len(_sources(g))


@pytest.mark.parametrize("kind,seed,tomb,host_ok", [
    ("braid", 0, False, True), ("braid", 2, True, True),
    ("braid", 4, True, False), ("braid", 5, False, True)])
def test_walk_redoes_stale_sources(kind, seed, tomb, host_ok, monkeypatch):
    """Overlapping bubbles: sources behind an earlier commit run the host
    BFS again, which pops (host_ok) or fails."""
    seen = []
    orig = spec._host_pop1

    def spy(g, v0, max_dist):
        out = orig(g, v0, max_dist)
        seen.append(out[0])
        return out

    monkeypatch.setattr(spec, "_host_pop1", spy)
    got, _, _ = _walk_both(_case(kind, seed, tomb), BUB_DIST, 64)
    assert got[3] == len(seen) > 0
    assert host_ok in seen


def test_walk_overflow_from_small_k():
    """Visited sets past K = 4: the verdicts come from reruns at 8, 16 and
    32, and the walk equals the one over verdicts from K = 64."""
    g = _case("braid", 0, tomb=True)
    small, K, _ = _walk_both(g, BUB_DIST, 4)
    assert K == 32
    assert small == _walk_both(g, BUB_DIST, 64)[0]


def _diamond(back_arc):
    """Reads 0 -> {1, 3} -> 2 -> 4, arcs of length 4,000: one bubble from
    vertex 0 to vertex 4 (read 2), 8,000 long.  With back_arc, read 1
    also has an arc back to read 0, deleted with its complement."""
    pairs = [(0, 1), (0, 3), (1, 2), (3, 2), (2, 4)] + (
        [(1, 0)] if back_arc else [])
    us, vs = [], []
    for a, b in pairs:
        us += [a << 1, (b << 1) ^ 1]
        vs += [b << 1, (a << 1) ^ 1]
    n = len(us)
    g = Graph(u=np.asarray(us, np.int32), l=np.full(n, 4000, np.int32),
              v=np.asarray(vs, np.int32), ol=np.full(n, 6000, np.int32),
              adel=np.zeros(n, bool), slen=np.full(5, 10_000, np.uint32),
              sdel=np.zeros(5, bool), idx_start=np.zeros(10, np.int64),
              idx_cnt=np.zeros(10, np.int32))
    g = cleanup(g)
    g.adel[((g.u == 2) & (g.v == 0)) | ((g.u == 1) & (g.v == 3))] = True
    return g


@pytest.mark.parametrize("back_arc,max_dist,pops", [
    (False, BUB_DIST, 1), (True, BUB_DIST, 0), (False, 7999, 0),
    (False, 8000, 1)])
def test_walk_failed_verdicts(back_arc, max_dist, pops):
    """A deleted arc back to the source fails its verdict; so does a path
    past max_dist (8,000 here)."""
    cands = np.array([0], np.int32)
    got, _, ok = _walk_both(_diamond(back_arc), max_dist, 64, cands)
    assert bool(ok[0]) == bool(pops)
    assert got == (pops, 1, pops, 0)


def test_walk_revalidates_every_vertex():
    """Every vertex as a source, in order: those without two live out-arcs
    or with a deleted read are skipped against the live graph."""
    g = _case("braid", 3, tomb=True)
    g.sdel[::5] = True
    cands = np.arange(g.n_vtx, dtype=np.int32)
    got, _, _ = _walk_both(g, BUB_DIST, 64, cands)
    assert got[1] == g.n_vtx


@pytest.mark.parametrize("seed", [0, 4])
def test_pop_bubbles_dev_counts_as_spec(seed):
    """pop_bubbles_dev: the spans dispatch and commit, the counters and
    the graph as the spec's walk leaves them."""
    g = _case("braid", seed, tomb=True)
    g_spec = copy.deepcopy(g)
    cands = _sources(g)
    ver = devbub._dispatch(g_spec, cands, BUB_DIST, 64, CPU)
    packed, n_cand, n_pop, n_redo = spec.walk(g_spec, cands, ver, BUB_DIST)
    mask = np.zeros(g.n_vtx, bool)
    mask[cands] = True
    prev = timers.tracing(True)
    try:
        rec = timers.Trace()
        with rec.recording():
            assert devbub.pop_bubbles_dev(g, mask, BUB_DIST, CPU) == packed
    finally:
        timers.tracing(prev)
    assert [s.path for s in rec.spans] == ["dispatch", "commit"]
    assert rec.counters == {"clean.candidates": n_cand,
                            "clean.commits": n_pop,
                            "clean.bubble_recomputed": n_redo}
    assert n_redo > 0
    assert np.array_equal(g.adel, g_spec.adel)
    assert np.array_equal(g.sdel, g_spec.sdel)


def _bad(g, ver, cands, col, how):
    """g, the verdicts and the sources with one column spoiled."""
    ver = list(ver)
    names = ["ok", "nb", "ntip", "sink", "vis", "par"]
    x = (cands if col == "cands" else ver[names.index(col)] if col in names
         else getattr(g, col))
    if how == "dtype":
        y = (x.astype(np.uint8) if x.dtype == bool
             else x.astype(np.int64 if x.dtype == np.int32 else np.int32))
    elif how == "list":
        y = x.tolist()
    elif how == "readonly":
        y = x.copy()
        y.flags.writeable = False
    elif x.ndim == 2:
        y = np.asfortranarray(x)
    else:  # strided: every other element of an array twice as long
        y = np.repeat(x, 2)[::2]
    if col == "cands":
        cands = y
    elif col in names:
        ver[names.index(col)] = y
    else:
        setattr(g, col, y)
    return ver, cands


@pytest.mark.parametrize("col,how,err", [
    ("l", "dtype", TypeError), ("idx_start", "dtype", TypeError),
    ("adel", "dtype", TypeError), ("sdel", "dtype", TypeError),
    ("vis", "dtype", TypeError), ("ok", "dtype", TypeError),
    ("cands", "list", TypeError), ("v", "strided", ValueError),
    ("idx_cnt", "strided", ValueError), ("sdel", "strided", ValueError),
    ("par", "strided", ValueError), ("adel", "readonly", ValueError)])
def test_walk_refuses_a_column_it_would_copy(col, how, err):
    """A column of another dtype or layout raises before the walk: a copy
    would drop its in-place tombstones."""
    g = _case("braid", 2)
    cands = _sources(g)
    ver = devbub._dispatch(g, cands, BUB_DIST, 64, CPU)
    ver, cands = _bad(g, ver, cands, col, how)
    adel, sdel = g.adel.copy(), g.sdel.copy()
    with pytest.raises(err, match="bubble_walk: %s " % col):
        devbub.bubble_walk(g, cands, ver, BUB_DIST)
    assert np.array_equal(np.asarray(g.adel, bool), adel)
    assert np.array_equal(np.asarray(g.sdel, bool), sdel)
