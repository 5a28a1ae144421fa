"""The port's graph cleaning (miniasm_tpu_torch/graph: devclean.detect with
the trans_multi twin, the bubble_bfs twin and pop_bubbles_dev, and the
hybrid clean_graph) against the JAX package on the same graphs, built
with numpy from a seed.  Masks, counters and graph states are compared
exactly."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from miniasm_tpu.config import Opt as JOpt
from miniasm_tpu.graph import devbub as jbub
from miniasm_tpu.graph import devclean as jclean
from miniasm_tpu.graph import hybrid as jhyb
from miniasm_tpu.graph.clean import symm
from miniasm_tpu_torch.config import Opt
from miniasm_tpu_torch.graph import devbub as tbub
from miniasm_tpu_torch.graph import devclean as tclean
from miniasm_tpu_torch.graph import hybrid as thyb
from miniasm_tpu_torch.graph.asg import Graph
from test_hybrid_clean import _state, braid_graph, random_graph


def port_opt():
    """The port's options, built field by field from the JAX package's."""
    return Opt.from_dict(dataclasses.asdict(JOpt()))

CPU = torch.device("cpu")
DET_KEYS = ("trans", "multi", "asymm", "tip", "internal", "biloop", "bubble")


def _graph(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "braid":
        return braid_graph(rng, n_back=20 + 2 * (seed % 5), n_alt=8 + seed % 7)
    if kind == "dense":
        # high-degree rows: the trans slot loop runs long
        return random_graph(rng, n_seq=12, n_pairs=160, asym_frac=0.1)
    return random_graph(rng, n_seq=30 + 5 * (seed % 4),
                        n_pairs=60 + 10 * (seed % 4), asym_frac=0.15)


@pytest.mark.parametrize("do_trans,do_symm", [(True, True), (False, True),
                                              (False, False)])
@pytest.mark.parametrize("kind,seed", [("random", 0), ("random", 3),
                                       ("dense", 1), ("braid", 2)])
def test_detect_matches_jax(kind, seed, do_trans, do_symm):
    g = _graph(kind, seed)
    j = jclean.detect(g, JOpt(), do_trans=do_trans, do_symm=do_symm)
    t = tclean.detect(Graph.from_arrays(g), port_opt(), do_trans=do_trans,
                      do_symm=do_symm, device=CPU)
    for k in DET_KEYS:
        assert np.array_equal(t[k], j[k]), k
    assert t["ratios"] == j["ratios"]
    assert len(t["shorts"]) == len(j["shorts"])
    for a, b in zip(t["shorts"], j["shorts"]):
        assert np.array_equal(a, b)
    assert t["counters"] == j["counters"]
    if kind == "dense" and do_trans:
        assert t["counters"][0] > 0


def _bubble_graph(kind, seed):
    rng = np.random.default_rng(8000 + seed)
    if kind == "braid":
        return braid_graph(rng, n_back=20 + 2 * seed, n_alt=8 + seed)
    return symm(random_graph(rng, n_seq=25 + 4 * seed,
                             n_pairs=60 + 12 * seed, asym_frac=0.0))


@pytest.mark.parametrize("kind,seed", [("braid", 0), ("braid", 5)])
def test_bubble_dispatch_matches_jax(kind, seed):
    """Per-source verdicts of one dispatch: equal ok bits everywhere, and
    equal sink, visit order, parents and tips where the bubble holds (a
    failed source may stop at another arc; see devbub's docstring).  K
    starts at 4, so the overflow doubling runs too."""
    g = _bubble_graph(kind, seed)
    live = np.array([g.live_out(v) for v in range(g.n_vtx)])
    cands = [int(v) for v in np.flatnonzero(live >= 2)]
    assert cands
    j_ok, j_nb, j_nt, j_sk, j_vis, j_par, _ = jbub._dispatch(
        g, cands, JOpt().bub_dist, 4)
    t_ok, t_nb, t_nt, t_sk, t_vis, t_par, _ = tbub._dispatch(
        Graph.from_arrays(g), cands, port_opt().bub_dist, 4, CPU)
    S = len(cands)
    assert np.array_equal(t_ok, j_ok[:S])
    ok = np.flatnonzero(t_ok)
    assert ok.size
    for i in ok:
        nb = int(t_nb[i])
        assert nb == int(j_nb[i])
        assert int(t_sk[i]) == int(j_sk[i]) and int(t_nt[i]) == int(j_nt[i])
        assert np.array_equal(t_vis[i, :nb], j_vis[i, :nb])
        assert np.array_equal(t_par[i, :nb], j_par[i, :nb])


@pytest.mark.parametrize("kind,seed", [("braid", 0), ("braid", 5),
                                       ("random", 3)])
def test_bubble_dispatch_reruns_only_overflow(kind, seed, monkeypatch):
    """_dispatch from K = 4: each re-run takes only the sources that
    overflowed the run before it, at twice its K, and the merged arrays
    equal one plain run of every source at the final K."""
    g = Graph.from_arrays(_bubble_graph(kind, seed))
    live = np.array([g.live_out(v) for v in range(g.n_vtx)])
    cands = [int(v) for v in np.flatnonzero(live >= 2)]
    calls = []
    orig = tbub.bubble_bfs

    def spy(*a, **k):
        out = orig(*a, **k)
        calls.append((a[5].tolist(), a[6], out[0][0].numpy() & 2))
        return out

    monkeypatch.setattr(tbub, "bubble_bfs", spy)
    dist = port_opt().bub_dist
    ok, nb, ntip, sink, vis, par, K = tbub._dispatch(g, cands, dist, 4, CPU)
    assert len(calls) >= 2 and K == 4 << (len(calls) - 1)
    assert calls[0][0] == cands
    for (src, k0, ovf), (src2, k1, _) in zip(calls, calls[1:]):
        assert k1 == 2 * k0
        assert src2 == [s for s, o in zip(src, ovf) if o]
    assert not calls[-1][2].any()
    c = tbub._arc_cols(g, CPU)
    res, v_all, p_all = tbub.bubble_bfs_plain(
        c["first"], c["av"], c["al"], c["adel"], c["live_out"],
        torch.tensor(cands, dtype=torch.int32), K, dist)
    res = res.numpy()
    assert np.array_equal(ok, (res[0] & 1).astype(bool))
    assert not (res[0] & 2).any()
    for got, want in ((nb, res[1]), (ntip, res[2]), (sink, res[3]),
                      (vis, v_all.numpy()), (par, p_all.numpy())):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("kind,seed", [("braid", 1), ("braid", 4),
                                       ("braid", 9), ("random", 0)])
def test_pop_bubbles_matches_jax(kind, seed):
    g = _bubble_graph(kind, seed)
    jc = jhyb._Cleaner(copy.deepcopy(g), JOpt(), do_trans=False)
    jn = jc.pop_bubble(JOpt().bub_dist)
    tc = thyb._Cleaner(Graph.from_arrays(g), port_opt(), do_trans=False,
                       device=CPU)
    tn = tc.pop_bubble(port_opt().bub_dist)
    assert tn == jn
    assert _state(tc.g) == _state(jc.g)


@pytest.mark.parametrize("stage", [6, 7, 100])
@pytest.mark.parametrize("kind,seed", [("random", 2), ("random", 5),
                                       ("braid", 3)])
def test_clean_graph_matches_jax(kind, seed, stage):
    g = _graph(kind, seed)
    gj = jhyb.clean_graph(copy.deepcopy(g), JOpt(), stage)
    gt = thyb.clean_graph(Graph.from_arrays(g), port_opt(), stage, device=CPU)
    assert _state(gt) == _state(gj)
