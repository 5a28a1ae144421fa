"""The port's oracle clean modes (MINIASM_TPU_CLEAN=native|py) against the
JAX package: member_multi (the K7 key_member twin), del_multi_mask (the K8
dup_mark twin), del_asymm_mask, del_trans (K3 reused), symm, del_short,
each seqclean pass and finalize_native on graphs built with numpy from a
seed, and the CLI's stdout in both modes.  Everything is compared
exactly."""

import copy

import numpy as np
import pytest
import torch

from conftest import run_ours
from miniasm_tpu.config import Opt as JOpt
from miniasm_tpu.graph import clean as jclean
from miniasm_tpu.graph import finalize_native as jfin
from miniasm_tpu.graph import seqclean as jseq
from miniasm_tpu.utils.arrays import member_multi as jmember
from miniasm_tpu_torch.graph import clean as tclean
from miniasm_tpu_torch.graph import finalize_native as tfin
from miniasm_tpu_torch.graph import seqclean as tseq
from miniasm_tpu_torch.graph.asg import Graph
from miniasm_tpu_torch.utils.arrays import member_multi as tmember
from test_hybrid_clean import _state, braid_graph, random_graph
from test_torch_clean import port_opt
from test_torch_cli import run_port

CPU = torch.device("cpu")
I32MAX = 2**31 - 1


def _member_case(case, rng):
    """(hay columns, hay_n, needle columns, needle_n) for one case."""
    if case == "tail":  # hay_n and needle_n below the lengths
        h = [rng.integers(-5, 5, 60), rng.integers(0, 4, 60)]
        q = [rng.integers(-5, 5, 80), rng.integers(0, 4, 80)]
        return h, 41, q, 57
    if case == "dups":  # many equal hay and needle tuples
        h = [rng.integers(0, 3, 200), rng.integers(0, 3, 200)]
        q = [rng.integers(0, 4, 150), rng.integers(0, 3, 150)]
        return h, 200, q, 150
    if case == "sentinel":
        # an all-INT32_MAX needle is found through the masked hay tail, a
        # partly-INT32_MAX one is not; needles past needle_n never are
        h = [rng.integers(0, 9, 30), rng.integers(0, 9, 30)]
        q = [np.array([I32MAX, I32MAX, 3, I32MAX, I32MAX]),
             np.array([I32MAX, 5, I32MAX, I32MAX, 2])]
        return h, 20, q, 4
    if case == "sentinel_full":  # no masked hay row: nothing to find
        h = [rng.integers(0, 9, 30), rng.integers(0, 9, 30)]
        q = [np.array([I32MAX, 1]), np.array([I32MAX, 1])]
        return h, 30, q, 2
    if case == "wrap":  # uint32 values above 2**31 cast to negative int32
        h = [rng.integers(0, 2**32, 50, dtype=np.uint64).astype(np.uint32),
             rng.integers(0, 3, 50)]
        q = [np.concatenate([h[0][:20], rng.integers(0, 2**32, 20,
                                                     dtype=np.uint64)
                             .astype(np.uint32)]),
             rng.integers(0, 3, 40)]
        return h, 50, q, 40
    if case == "one_col":
        h = [rng.integers(-20, 20, 70)]
        q = [rng.integers(-25, 25, 90)]
        return h, 60, q, 85
    if case == "three_cols":  # folded by dense rank before packing
        h = [rng.integers(0, 3, 120) for _ in range(3)]
        q = [rng.integers(0, 4, 100) for _ in range(3)]
        return h, 110, q, 95
    assert case == "empty_hay"
    return [np.zeros(0, np.int32)] * 2, 0, [rng.integers(0, 3, 10)] * 2, 10


@pytest.mark.parametrize("case", ["tail", "dups", "sentinel",
                                  "sentinel_full", "wrap", "one_col",
                                  "three_cols", "empty_hay"])
def test_member_multi_matches_jax(case):
    h, hn, q, qn = _member_case(case, np.random.default_rng(11))
    want = np.asarray(jmember(h, hn, q, qn))
    got = tmember(h, hn, q, qn, device=CPU).numpy()
    assert got.dtype == bool and np.array_equal(got, want)
    if case == "sentinel":
        assert got.tolist() == [True, False, False, True, False]


def _arc_cols(seed, n=400, span=30):
    """Unsorted (u, v) columns with repeated pairs and complements."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, span, n).astype(np.int32)
    v = rng.integers(0, span, n).astype(np.int32)
    k = n // 4
    u[-k:], v[-k:] = v[:k] ^ 1, u[:k] ^ 1  # some complements present
    p = rng.permutation(n)
    return u[p], v[p]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_del_multi_and_asymm_masks_match_jax(seed):
    u, v = _arc_cols(seed)
    want_m = jclean.del_multi_mask(u, v)
    got_m = tclean.del_multi_mask(u, v, CPU)
    assert np.array_equal(got_m, want_m) and 0 < got_m.sum() < len(u)
    want_a = jclean.del_asymm_mask(u, v)
    got_a = tclean.del_asymm_mask(u, v, CPU)
    assert np.array_equal(got_a, want_a) and 0 < got_a.sum() < len(u)


def test_dup_mark_keeps_first_in_index_order():
    """K8's twin on keys that repeat far apart: the first index stays."""
    key = torch.tensor([5, 3, 5, 5, 3, 9], dtype=torch.int64)
    skey, perm = torch.sort(key, stable=True)
    got = tclean.dup_mark(skey, perm)
    assert got.tolist() == [False, False, True, True, True, False]


def _graph(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "braid":
        return braid_graph(rng, n_back=20 + 2 * (seed % 5), n_alt=8 + seed % 7)
    if kind == "dense":
        return random_graph(rng, n_seq=12, n_pairs=160, asym_frac=0.1)
    g = random_graph(rng, n_seq=30 + 5 * (seed % 4),
                     n_pairs=60 + 10 * (seed % 4), asym_frac=0.15)
    if kind == "tombstones":
        # del_trans reads tombstoned arcs too (the JAX tables hold every
        # CSR arc); cleanup then drops them with the reduced ones
        g.adel[rng.random(g.n_arc) < 0.2] = True
    if kind == "multi":
        # duplicate arcs for del_multi: every third arc twice (cleanup sorts
        # the copies next to their originals)
        from miniasm_tpu.graph.asg import Graph as JGraph, cleanup

        d = np.arange(0, g.n_arc, 3)
        cat = {k: np.concatenate([getattr(g, k), getattr(g, k)[d]])
               for k in ("u", "l", "v", "ol")}
        g = cleanup(JGraph(adel=np.zeros(len(cat["u"]), bool), slen=g.slen,
                           sdel=g.sdel, idx_start=g.idx_start,
                           idx_cnt=g.idx_cnt, **cat))
    return g


KINDS = [("random", 0), ("random", 3), ("dense", 1), ("braid", 2),
         ("tombstones", 4), ("multi", 5)]


@pytest.mark.parametrize("kind,seed", KINDS)
def test_del_trans_matches_jax(kind, seed):
    g = _graph(kind, seed)
    want = jclean.del_trans(copy.deepcopy(g), 1000)
    got = tclean.del_trans(Graph.from_arrays(g), 1000, device=CPU)
    assert _state(got) == _state(want)
    assert got.is_symm == want.is_symm
    if kind == "dense":
        assert len(_state(got)[0]) < int((~g.adel).sum())


@pytest.mark.parametrize("kind,seed", [("random", 0), ("dense", 1),
                                       ("braid", 2), ("multi", 5)])
def test_symm_and_del_short_match_jax(kind, seed):
    g = _graph(kind, seed)
    want = jclean.symm(copy.deepcopy(g))
    got = tclean.symm(Graph.from_arrays(g), device=CPU)
    assert _state(got) == _state(want) and got.is_symm
    for ratio in (np.float32(0.5), np.float32(0.8)):
        want, nj = jclean.del_short(copy.deepcopy(want), ratio)
        got, nt = tclean.del_short(got, ratio, device=CPU)
        assert nt == nj and _state(got) == _state(want)


PASSES = ["cut_tip", "pop_bubble", "cut_internal", "cut_biloop"]


def _run_pass(mod, name, g, opt, **kw):
    if name == "pop_bubble":
        return mod.pop_bubble(g, opt.bub_dist, **kw)
    if name == "cut_internal":
        return mod.cut_internal(g, 1)
    return getattr(mod, name)(g, opt.max_ext)


@pytest.mark.parametrize("name", PASSES)
@pytest.mark.parametrize("kind,seed", [("random", 2), ("braid", 3),
                                       ("random", 7)])
def test_seqclean_pass_matches_jax(name, kind, seed):
    """Each sequential pass alone on the transitively reduced graph (the
    pop_bubble case on an unsymmetric graph symmetrises first)."""
    g = jclean.del_trans(_graph(kind, seed), 1000)
    gj, nj = _run_pass(jseq, name, copy.deepcopy(g), JOpt())
    gt, nt = _run_pass(tseq, name, Graph.from_arrays(g), port_opt(),
                       **({"device": CPU} if name == "pop_bubble" else {}))
    assert nt == nj and _state(gt) == _state(gj)


@pytest.mark.parametrize("stage", [7, 9, 100])
@pytest.mark.parametrize("kind,seed", [("random", 1), ("braid", 4),
                                       ("dense", 8)])
def test_finalize_native_matches_jax(kind, seed, stage):
    g = jclean.del_trans(_graph(kind, seed), 1000)
    gj, uj = jfin.finalize_native(copy.deepcopy(g), JOpt(), stage, True)
    gt, ut = tfin.finalize_native(Graph.from_arrays(g), port_opt(), stage,
                                  True)
    assert _state(gt) == _state(gj)
    assert [(u.len, u.circ, u.start, u.end, u.a) for u in ut.u] \
        == [(u.len, u.circ, u.start, u.end, u.a) for u in uj.u]
    assert _state(ut.g) == _state(uj.g)


@pytest.mark.parametrize("fmt", ["ug", "sg"])
@pytest.mark.parametrize("mode", ["native", "py"])
@pytest.mark.parametrize("data", ["sim_small", "sim_noisy"])
def test_oracle_modes_stdout_matches_jax(request, monkeypatch, data, mode,
                                         fmt):
    """The oracle modes print the JAX package's bytes, which its own tests
    hold equal to its hybrid cleaner's; so do the port's."""
    args = ["-p", fmt, request.getfixturevalue(data)["paf"]]
    monkeypatch.setenv("MINIASM_TPU_CLEAN", "hybrid")
    hybrid = run_port(args)[1]
    monkeypatch.setenv("MINIASM_TPU_CLEAN", mode)
    want = run_ours(args)
    rc, got, _ = run_port(args)
    assert rc == 0 and got == want == hybrid and got
