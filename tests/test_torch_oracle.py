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
    if case == "marker":
        # (-1, -1) packs to all ones, the bytes of K7's empty slots; present
        # in the hay, and as needles inside and past needle_n
        h = [np.array([-1, 3, -1, 0]), np.array([-1, 3, 0, -1])]
        q = [np.array([-1, 0, -1, -1, 3, -1]), np.array([-1, -1, 0, 5, 3, -1])]
        return h, 4, q, 5
    if case == "marker_absent":  # (-1, -1) needles, no (-1, -1) hay row
        h = [np.array([-1, 0, 7]), np.array([0, -1, 7])]
        q = [np.array([-1, -1, 7]), np.array([-1, -1, 7])]
        return h, 3, q, 3
    if case == "marker_one_col":  # -1 in one column is the same pattern
        h = [np.array([4, -1, 2, 9, 9])]
        q = [np.array([-1, -1, 9, 3, 2, -1])]
        return h, 3, q, 6
    if case == "marker_pads":
        # (-1, -1) and INT32_MAX pads together: hay_n < mh, needle_n < mq
        h = [np.array([-1, 5, I32MAX, -1, 8]), np.array([-1, 5, I32MAX, 2, 8])]
        q = [np.array([-1, I32MAX, 8, -1, I32MAX, -1]),
             np.array([-1, I32MAX, 8, 2, I32MAX, -1])]
        return h, 2, q, 5
    if case == "all_equal":  # one key in every hay and needle row
        h = [np.full(90, 6), np.full(90, -3)]
        q = [np.full(70, 6), np.full(70, -3)]
        return h, 90, q, 60
    if case == "extremes":  # INT32_MIN / INT32_MAX and -1 in both columns
        vals = np.array([-2**31, 2**31 - 1, -1, 0, 1])
        h = [rng.choice(vals, 40), rng.choice(vals, 40)]
        q = [rng.choice(vals, 60), rng.choice(vals, 60)]
        return h, 33, q, 55
    if case == "n0":  # no hay row and no needle
        return [np.zeros(0, np.int32)] * 2, 0, [np.zeros(0, np.int32)] * 2, 0
    if case == "n1":
        return [np.array([3]), np.array([1])], 1, \
            [np.array([3]), np.array([1])], 1
    if case == "n_out_of_range":
        # hay_n and needle_n past the lengths: no pad, every needle live;
        # a negative hay_n pads every hay row
        h = [rng.integers(0, 4, 30), rng.integers(0, 4, 30)]
        q = [np.concatenate([rng.integers(0, 5, 20), [I32MAX]]),
             np.concatenate([rng.integers(0, 4, 20), [I32MAX]])]
        return h, 45, q, 30
    if case == "negative_n":
        h = [rng.integers(0, 4, 30), rng.integers(0, 4, 30)]
        q = [np.array([I32MAX, 1, I32MAX]), np.array([I32MAX, 1, 0])]
        return h, -3, q, 3
    assert case == "empty_hay"
    return [np.zeros(0, np.int32)] * 2, 0, [rng.integers(0, 3, 10)] * 2, 10


MEMBER_EXPECT = {"marker": [True, True, True, False, True, False],
                 "marker_absent": [False, False, True],
                 "marker_one_col": [True, True, False, False, True, True],
                 "marker_pads": [True, True, False, False, True, False],
                 "all_equal": [True] * 60 + [False] * 10,
                 "n1": [True],
                 "negative_n": [True, False, False]}


@pytest.mark.parametrize("case", ["tail", "dups", "sentinel",
                                  "sentinel_full", "wrap", "one_col",
                                  "three_cols", "empty_hay", "marker",
                                  "marker_absent", "marker_one_col",
                                  "marker_pads", "all_equal", "extremes",
                                  "n0", "n1", "n_out_of_range",
                                  "negative_n"])
def test_member_multi_matches_jax(case):
    h, hn, q, qn = _member_case(case, np.random.default_rng(11))
    want = np.asarray(jmember(h, hn, q, qn))
    got = tmember(h, hn, q, qn, device=CPU).numpy()
    assert got.dtype == bool and np.array_equal(got, want)
    if case == "sentinel":
        assert got.tolist() == [True, False, False, True, False]
    if case in MEMBER_EXPECT:
        assert got.tolist() == MEMBER_EXPECT[case]


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


def _symm_case(case):
    """(u, v) arc columns for the symm masks' edge cases."""
    if case == "n0":
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    if case == "n1":
        return np.array([4], np.int32), np.array([6], np.int32)
    if case == "n1_marker":
        return np.array([-1], np.int32), np.array([-1], np.int32)
    if case == "marker":
        # (-1, -1) repeated (all ones, as K8's empty slots) beside its
        # complement (-2, -2) and ordinary arcs
        u = np.array([3, -1, -2, -1, 7, -1, -2, 2], np.int32)
        v = np.array([6, -1, -2, -1, 2, -1, -2, 6], np.int32)
        return u, v
    if case == "all_equal":
        return np.full(500, 9, np.int32), np.full(500, 8, np.int32)
    if case == "far_dups":
        # each pair occurs at the start and again near the end, in
        # another order: the first index stays
        rng = np.random.default_rng(5)
        u = rng.integers(0, 1000, 300).astype(np.int32)
        v = rng.integers(0, 1000, 300).astype(np.int32)
        p = rng.permutation(300)[:100]
        return np.concatenate([u, u[p]]), np.concatenate([v, v[p]])
    assert case == "extremes"
    # INT32_MIN / MAX and values that wrap from uint32; x ^ 1 keeps them
    vals = np.array([-2**31, -2**31 + 1, 2**31 - 1, 2**31 - 2, -1, -2, 0, 1])
    rng = np.random.default_rng(6)
    return (rng.choice(vals, 200).astype(np.int32),
            rng.choice(vals, 200).astype(np.int32))


SYMM_EXPECT = {"n1": ([False], [True]), "n1_marker": ([False], [True]),
               "marker": ([False, False, False, True, False, True, True,
                           False],
                          [False] * 7 + [True])}


@pytest.mark.parametrize("case", ["n0", "n1", "n1_marker", "marker",
                                  "all_equal", "far_dups", "extremes"])
def test_symm_masks_edge_cases_match_jax(case):
    u, v = _symm_case(case)
    got_m = tclean.del_multi_mask(u, v, CPU)
    got_a = tclean.del_asymm_mask(u, v, CPU)
    assert got_m.dtype == bool and got_m.shape == u.shape
    assert np.array_equal(got_m, jclean.del_multi_mask(u, v))
    assert np.array_equal(got_a, jclean.del_asymm_mask(u, v))
    if case in SYMM_EXPECT:
        assert (got_m.tolist(), got_a.tolist()) == SYMM_EXPECT[case]
    if case == "all_equal":
        assert got_m.tolist() == [False] + [True] * 499
    if case == "far_dups":
        assert not got_m[:300].any() and got_m[300:].all()


def test_dup_mark_keeps_first_in_index_order():
    """K8's twin on keys that repeat far apart: the first index stays."""
    u = torch.tensor([5, 3, 5, 5, 3, 9], dtype=torch.int32)
    v = torch.tensor([1, 2, 1, 1, 2, 1], dtype=torch.int32)
    got = tclean.dup_mark(u, v)
    assert got.tolist() == [False, False, True, True, True, False]


@pytest.mark.parametrize("fn", ["key_member", "dup_mark"])
def test_symm_wrappers_refuse_what_the_kernels_do_not_take(fn):
    """K7 and K8 take one or two equally long int32 key columns, as many
    for the needles as for the hay; anything else raises on every device."""
    from miniasm_tpu_torch.utils import arrays as tarrays

    c = torch.zeros(4, dtype=torch.int32)
    if fn == "dup_mark":
        with pytest.raises(ValueError):
            tclean.dup_mark(c, torch.zeros(5, dtype=torch.int32))
        return
    for hay, needles in (([c] * 3, [c] * 3), ([c, c], [c]),
                         ([c, c[:3]], [c, c]), ([], [])):
        with pytest.raises(ValueError):
            tarrays.key_member(hay, 4, needles, 4)


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
