"""The plain twins of the select program's tail (read_marks K12, arc_order
K13: miniasm_tpu_torch/select/fused2.py) and of the clean program's stage B
(clean_stage_b K14: miniasm_tpu_torch/graph/devclean.py)
against the JAX package on the same inputs, made from a seed with numpy.
On the CPU every wrapper runs its twin, so select_build2 and detect below
run the twins end to end.  Everything compared is an integer or a bool:
exact equality."""

import dataclasses

import numpy as np
import pytest
import torch

from miniasm_tpu.config import Opt as JOpt
from miniasm_tpu.graph import devclean as jclean
from miniasm_tpu.io.native.pafload import load_hits_mt as j_load
from miniasm_tpu.select import fused2 as jf
from miniasm_tpu_torch.config import Opt
from miniasm_tpu_torch.core.hit2arc import MA_HT_QCONT
from miniasm_tpu_torch.graph import devclean as tclean
from miniasm_tpu_torch.graph.asg import Graph, cleanup
from miniasm_tpu_torch.io.native.pafload import load_hits_mt as t_load
from miniasm_tpu_torch.select import fused2 as tf

CPU = torch.device("cpu")
DET_KEYS = ("trans", "multi", "asymm", "tip", "internal", "biloop", "bubble")


def port_opt(**kw):
    """The port's options, built field by field from the JAX package's."""
    return Opt.from_dict(dataclasses.asdict(JOpt(**kw)))


# ---------------------------------------------------------------------------
# the clean program's stage B: K14 through detect


def _graph(us, vs, lens, rng, sdel=None):
    """A compacted graph of the arcs us -> vs, overlaps drawn per arc."""
    us = np.asarray(us, np.int64)
    vs = np.asarray(vs, np.int64)
    la = lens[us >> 1].astype(np.int64)
    lb = lens[vs >> 1].astype(np.int64)
    ol = np.array([int(rng.integers(500, min(a, b))) for a, b in zip(la, lb)],
                  np.int64) if us.size else np.zeros(0, np.int64)
    n_seq = lens.shape[0]
    g = Graph(u=us.astype(np.int32), l=(la - ol).astype(np.int32),
              v=vs.astype(np.int32), ol=ol.astype(np.int32),
              adel=np.zeros(us.size, bool), slen=lens,
              sdel=np.zeros(n_seq, bool) if sdel is None else sdel,
              idx_start=np.zeros(2 * n_seq, np.int64),
              idx_cnt=np.zeros(2 * n_seq, np.int32))
    return cleanup(g)


def clean_graph(kind, seed):
    """Graphs for stage B: asymmetric arcs and multi-arcs among symmetric
    pairs, chains (rows of degree 1), a dense one, an empty one."""
    rng = np.random.default_rng(seed)
    if kind == "empty":
        return _graph([], [], rng.integers(3000, 9000, 6).astype(np.uint32),
                      rng)
    if kind == "chain":
        # one unitig path a -> a+1 with both strands (rows of degree 1),
        # and one stray arc that gives the last row a second arc
        n = 12
        lens = rng.integers(6000, 9000, n).astype(np.uint32)
        us = [2 * i for i in range(n - 1)] + [2 * i + 3 for i in range(n - 1)]
        vs = [2 * i + 2 for i in range(n - 1)] + [2 * i + 1
                                                 for i in range(n - 1)]
        return _graph(us + [2 * n - 1], vs + [4], lens, rng)
    n_seq = {"mixed": 30, "dense": 10}[kind]
    n_pairs = {"mixed": 70, "dense": 120}[kind]
    lens = rng.integers(3000, 20000, n_seq).astype(np.uint32)
    us, vs = [], []
    for _ in range(n_pairs):
        a = int(rng.integers(0, 2 * n_seq))
        b = int(rng.integers(0, 2 * n_seq))
        if a >> 1 == b >> 1:
            continue
        r = rng.random()
        us.append(a)
        vs.append(b)
        if r > 0.15:  # else an asymmetric singleton
            us.append(b ^ 1)
            vs.append(a ^ 1)
        if r > 0.85:  # a multi-arc: the pair again
            us += [a, b ^ 1]
            vs += [b, a ^ 1]
    return _graph(us, vs, lens, rng, sdel=rng.random(n_seq) < 0.05)


def _detect_both(g, do_trans, do_symm, **kw):
    j = jclean.detect(g, JOpt(**kw), do_trans=do_trans, do_symm=do_symm)
    t = tclean.detect(Graph.from_arrays(g), port_opt(**kw),
                      do_trans=do_trans, do_symm=do_symm, device=CPU)
    return j, t


def _assert_same(j, t):
    for k in DET_KEYS:
        assert t[k].dtype == np.bool_, k
        assert np.array_equal(t[k], j[k]), k
    assert t["ratios"] == j["ratios"]
    assert len(t["shorts"]) == len(j["shorts"])
    for a, b in zip(t["shorts"], j["shorts"]):
        assert np.array_equal(a, b)
    assert t["counters"] == j["counters"]


@pytest.mark.parametrize("do_trans,do_symm", [(True, True), (True, False),
                                              (False, True), (False, False)])
@pytest.mark.parametrize("n_rounds", [1, 2, 3, 4, 5, 6])
def test_detect_stage_b_matches_jax_each_ratio_count(n_rounds, do_trans,
                                                     do_symm):
    """R = n_rounds + 2 ratios: 3 to 8, so up to 11 bits an arc's word."""
    g = clean_graph("mixed", 40 + n_rounds)
    j, t = _detect_both(g, do_trans, do_symm, n_rounds=n_rounds)
    _assert_same(j, t)
    assert len(t["shorts"]) == n_rounds + 2
    assert t["counters"][2] > 0  # asymmetric arcs
    if not do_trans:
        assert t["counters"][1] > 0  # multi-arcs


@pytest.mark.parametrize("max_ext", [1, 4, 7])
@pytest.mark.parametrize("kind,seed", [("mixed", 1), ("dense", 2),
                                       ("chain", 3), ("empty", 4)])
def test_detect_stage_b_matches_jax_graphs(kind, seed, max_ext):
    g = clean_graph(kind, seed)
    for do_trans, do_symm in ((True, True), (False, False)):
        j, t = _detect_both(g, do_trans, do_symm, max_ext=max_ext)
        _assert_same(j, t)
    if kind == "empty":
        assert g.n_arc == 0 and t["trans"].shape == (0,)
    if kind == "chain":
        assert (g.idx_cnt == 1).sum() == 2 * 11 - 1


def test_clean_arcs_words_carry_every_mask():
    """The twin's words and counters unpack to detect's masks, and a word
    keeps each ratio's bit in place past the eighth bit."""
    g = clean_graph("mixed", 7)
    opt = port_opt(n_rounds=6)
    c = tclean.build_arcs(Graph.from_arrays(g), CPU)
    bits = tclean.trans_multi(c["first"], c["av"], c["al"], c["sdel_v"],
                              c["D"], int(opt.gap_fuzz), True)
    ratios = tclean._ratio_schedule(opt)
    res, rows = tclean.clean_arcs_plain(c["first"], c["av"], c["aol"], bits,
                                        ratios, True)
    R = len(ratios)
    assert res.dtype == torch.int32 and res.shape == (3 + R + g.n_arc,)
    assert rows.dtype == torch.int32 and rows.shape == (2, c["V"])
    det = tclean.detect(Graph.from_arrays(g), opt, do_trans=True,
                        device=CPU)
    words = res[3 + R:].numpy()
    for k, m in enumerate([det["trans"], det["multi"], det["asymm"]]
                          + det["shorts"]):
        assert np.array_equal((words >> k) & 1 != 0, m)
    assert res[:3 + R].tolist() == det["counters"]
    assert int(rows[0].sum()) > 0


def test_clean_arcs_raises_on_too_many_ratios():
    g = clean_graph("mixed", 8)
    c = tclean.build_arcs(Graph.from_arrays(g), CPU)
    bits = torch.zeros(g.n_arc, dtype=torch.uint8)
    with pytest.raises(ValueError, match="drop ratios"):
        tclean.clean_stage_b(c["first"], c["av"], c["aol"], bits,
                             c["sdel_v"], (0.5,) * 30, True, c["D"], 4)


def test_clean_ends_walk_stops_at_max_ext():
    """A path of unique arcs longer than max_ext: the walk runs out while
    mergeable (ext code 0), so no tip; with room it reaches the path's end
    (a tip).  Rows of one live arc each (no symm: every arc not eliminated
    is live), rows 0 and 10 empty."""
    V = 12
    fl_v = [0, 3, 1, 5, 3, 7, 5, 9, 7, 11, 9, 0]
    empty = (0, 10)  # vertex 1's row (1 ^ 1) holds no arc: a tip start;
    # the path 1 -> 3 -> ... -> 11 ends at row 11 ^ 1
    first = torch.tensor(np.concatenate([[0], np.cumsum(
        [0 if r in empty else 1 for r in range(V)])]), dtype=torch.int64)
    av = torch.tensor([fl_v[r] for r in range(V) if r not in empty],
                      dtype=torch.int32)
    aol = torch.full_like(av, 1000)
    bits = torch.zeros(av.shape[0], dtype=torch.uint8)
    sdel = torch.zeros(V, dtype=torch.uint8)
    R, A = 1, av.shape[0]

    def ends(max_ext):
        buf = tclean.clean_stage_b(first, av, aol, bits, sdel, (0.5,),
                                   False, 1, max_ext)
        assert buf.dtype == torch.int32
        return buf[3 + R + A:].view(torch.uint8)[:V]

    far, near = ends(3), ends(7)
    assert int(far[1]) & 1 == 0 and int(near[1]) & 1 == 1


def stage_b_graph(kind, seed):
    """Graphs for the fused kernel's edges: "hub", a vertex of 40 arcs
    (more than one 32-lane round) whose targets' complement rows hold 20
    to 28 arcs (more than one 16-arc chunk of the scan), some of them
    without the arc back (asymmetric); "dead", arcs but none live: every
    arc a self loop short enough that the transitive reduction eliminates
    it; "empty", no arc."""
    rng = np.random.default_rng(seed)
    if kind == "empty":
        return clean_graph("empty", seed)
    if kind == "dead":
        n_seq = 9
        lens = rng.integers(3000, 9000, n_seq).astype(np.uint32)
        us = np.arange(2 * n_seq)
        la = lens[us >> 1].astype(np.int64)
        ol = la - rng.integers(1, 400, us.size)
        g = Graph(u=us.astype(np.int32), l=(la - ol).astype(np.int32),
                  v=us.astype(np.int32), ol=ol.astype(np.int32),
                  adel=np.zeros(us.size, bool), slen=lens,
                  sdel=np.zeros(n_seq, bool),
                  idx_start=np.zeros(2 * n_seq, np.int64),
                  idx_cnt=np.zeros(2 * n_seq, np.int32))
        return cleanup(g)
    n_spoke, n_seq = 40, 80
    lens = rng.integers(12000, 20000, n_seq).astype(np.uint32)
    us, vs = [], []
    for b in range(1, n_spoke + 1):
        us.append(0)  # the hub: read 0 forward
        vs.append(2 * b)
        if rng.random() > 0.2:  # else asymmetric: no arc 2b+1 -> 1
            us.append(2 * b + 1)
            vs.append(1)
        # the complement row 2b+1: 20-28 more arcs, and their complements
        for c in rng.choice(np.arange(n_spoke + 1, n_seq),
                            int(rng.integers(20, 29)), replace=False):
            us += [2 * b + 1, 2 * int(c) + 1]
            vs += [2 * int(c), 2 * b]
    return _graph(us, vs, lens, rng)


def _unpack_stage_b(buf, V, A, R):
    """stage B's buffer as detect's dict: the masks, candidates and
    counters."""
    host = buf.numpy()
    words = host[3 + R:3 + R + A]
    cands = host[3 + R + A:].view(np.uint8)
    assert cands.shape == (4 * ((V + 3) // 4),) and not cands[V:].any()
    m = [((words >> k) & 1).astype(bool) for k in range(3 + R)]
    cb = [((cands[:V] >> k) & 1).astype(bool) for k in range(4)]
    return {"trans": m[0], "multi": m[1], "asymm": m[2], "shorts": m[3:],
            "tip": cb[0], "internal": cb[1], "biloop": cb[2],
            "bubble": cb[3], "counters": [int(x) for x in host[:3 + R]]}


@pytest.mark.parametrize("max_ext", [1, 7])
@pytest.mark.parametrize("do_symm", [False, True])
@pytest.mark.parametrize("kind", ["hub", "dead", "empty"])
def test_stage_b_plain_matches_jax_detect(kind, do_symm, max_ext):
    """clean_stage_b_plain's buffer, unpacked, against the JAX detect on
    the same graph, bit for bit, with and without the transitive
    reduction (K3's plain version gives the twin its bits)."""
    g = stage_b_graph(kind, 50 + max_ext)
    tg = Graph.from_arrays(g)
    opt, jopt = port_opt(max_ext=max_ext), JOpt(max_ext=max_ext)
    c = tclean.build_arcs(tg, CPU)
    ratios = tclean._ratio_schedule(opt)
    V, A, R = c["V"], g.n_arc, len(ratios)
    for do_trans in (False, True):
        j = jclean.detect(g, jopt, do_trans=do_trans, do_symm=do_symm)
        bits = tclean.trans_multi(c["first"], c["av"], c["al"], c["sdel_v"],
                                  c["D"], int(opt.gap_fuzz), do_trans)
        buf = tclean.clean_stage_b_plain(c["first"], c["av"], c["aol"],
                                         bits, c["sdel_v"], ratios, do_symm,
                                         max_ext)
        assert buf.dtype == torch.int32
        t = _unpack_stage_b(buf, V, A, R)
        t["ratios"] = ratios
        _assert_same(j, t)
        d = tclean.detect(tg, opt, do_trans=do_trans, do_symm=do_symm,
                          device=CPU)
        _assert_same(j, d)
    if kind == "hub":
        # a row past 32 lanes, complement rows past one scan chunk, and
        # arcs back found in the second chunk
        assert c["D"] > 32
        first, av = c["first"].numpy(), c["av"].numpy()
        back = [int(np.nonzero(av[first[w]:first[w + 1]] == 1)[0][0])
                for w in range(3, 2 * 41, 2)
                if (av[first[w]:first[w + 1]] == 1).any()]
        assert max(back) >= 16 and len(back) < 40
        assert t["counters"][2] > 0
    if kind == "dead":
        # every arc eliminated: every row empty, every vertex a tip
        assert A > 0 and t["counters"][0] == A
        assert t["tip"].all() and not t["bubble"].any()
    if kind == "empty":
        assert A == 0 and V > 0


# ---------------------------------------------------------------------------
# the select program's tail: K12 and K13 through select_build2


def _read_paf(path):
    with open(path) as f:
        return [ln.rstrip("\n").split("\t") for ln in f]


def _write_paf(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write("\t".join(str(x) for x in r) + "\n")


def _select_both(paf, paf_tables):
    jopt, opt = JOpt(), port_opt()
    jcol, jd, jh = j_load(paf, jopt.min_span, jopt.min_match, bi_dir=True,
                          min_iden=float(jopt.min_iden), upload=False)
    tcol, td, th = t_load(paf, opt.min_span, opt.min_match, bi_dir=True,
                          min_iden=float(opt.min_iden), device=CPU)
    n, cap = tcol.shape[1], jcol.shape[1]
    ja, jmd, jc = jf.select_build2(jcol, jd, jopt, bi_dir=True,
                                   max_len=jh.max_len, paf_tables=paf_tables)
    ta, tmd, tc = tf.select_build2(tcol, td, opt, bi_dir=True,
                                   paf_tables=paf_tables)
    jh.free()
    th.free()
    for k in ("u", "v", "l", "ol"):
        assert ta[k].dtype == np.int32, k
        assert np.array_equal(ta[k], ja[k]), k
    jidx = np.where(ja["idx"] >= cap, ja["idx"] - cap + n, ja["idx"])
    assert ta["idx"].dtype == np.int64
    assert np.array_equal(ta["idx"], jidx)
    for k in ("sub_s", "sub_e", "sub_del", "cont", "used", "pal"):
        assert tmd[k].dtype == jmd[k].dtype, k
        assert np.array_equal(tmd[k], jmd[k]), k
    assert (tmd["tot_dp"], tmd["tot_len"]) == (jmd["tot_dp"], jmd["tot_len"])
    assert tc[:7] == jc[:7] and tc[7] == jc[13]
    if paf_tables:
        for k in ("sub1", "sub2"):
            for a, b in zip(tmd[k], jmd[k]):
                assert np.array_equal(np.asarray(a), np.asarray(b)), k
    return td, tmd, tc


@pytest.fixture(scope="module")
def base_paf(tmp_path_factory):
    from miniasm_tpu.eval.simulate import simulate, write_paf

    d = tmp_path_factory.mktemp("tails")
    paf = str(d / "base.paf")
    write_paf(simulate(genome_len=120_000, coverage=20.0, seed=3), paf)
    return paf


def _palindrome_case(base_paf, out):
    """The base PAF plus one palindromic self-hit row (rev, qs == ts,
    qe == te, an arc to itself) on a read that another row marks
    contained: its mark word is max(5, 3) = 5, not 5 | 3 = 7."""
    td, md, _ = _select_both(base_paf, False)
    rows = _read_paf(base_paf)
    lens = {r[0]: int(r[1]) for r in rows}
    lens.update({r[5]: int(r[6]) for r in rows})
    sub_len = md["sub_e"].astype(np.int64) - md["sub_s"]
    cand = np.nonzero(md["cont"] & ~md["sub_del"] & (sub_len > 7000))[0]
    assert cand.size, "the base set has no contained read to mark"
    r = int(cand[0])
    name = td.names[r]
    s, e = int(md["sub_s"][r]), int(md["sub_e"][r])
    qs, qe = s + (e - s) * 6 // 10, e - 100
    pal = [name, lens[name], qs, qe, "-", name, lens[name], qs, qe,
           qe - qs, qe - qs, 255]
    _write_paf(out, rows + [pal])
    return r


def test_select_tail_amax_read_marks(base_paf, tmp_path):
    """A read with a palindromic self-hit row and a containment row ends
    with its palindrome bit and without its contained bit, in both
    packages (the amax of the two mark words)."""
    paf = str(tmp_path / "pal.paf")
    r = _palindrome_case(base_paf, paf)
    for paf_tables in (False, True):
        td, md, c = _select_both(paf, paf_tables)
        assert md["pal"][r] and md["used"][r] and not md["cont"][r]


def test_read_marks_plain_takes_the_max_not_the_or():
    """Row 0 a palindromic self hit of read 1 (word 5), row 1 a hit whose
    q-side marks read 1 contained (3): read 1 keeps 5."""
    colmat = torch.tensor([[1, 1], [100, 0], [5000, 4000],
                           [1, 2], [100, 10], [5000, 4010],
                           [3, 1]], dtype=torch.int32)
    out = torch.zeros((15, 2), dtype=torch.int32)
    out[0] = torch.tensor([100, 0])
    out[1] = torch.tensor([5000, 4000])
    out[2] = torch.tensor([100, 10])
    out[3] = torch.tensor([5000, 4010])
    out[4] = torch.tensor([1, 1])  # q-side lanes valid
    out[5] = torch.tensor([1200, MA_HT_QCONT])
    tab = tf.read_marks(colmat, out, 4)
    assert tab.tolist() == [0, 5, 1, 0]


@pytest.mark.parametrize("paf_tables", [False, True])
def test_select_tail_duplicate_hit_keys(base_paf, tmp_path, paf_tables):
    """Repeated PAF lines: arcs of equal hit key (dup_hit > 0), whose ties
    keep row order."""
    rows = _read_paf(base_paf)
    rng = np.random.default_rng(5)
    pick = rng.choice(len(rows), 40, replace=False)
    paf = str(tmp_path / "dups.paf")
    _write_paf(paf, rows + [rows[i] for i in pick])
    _, _, c = _select_both(paf, paf_tables)
    assert c[7] > 0 and c[6] > 0


@pytest.mark.parametrize("paf_tables", [False, True])
def test_select_tail_no_arcs(base_paf, tmp_path, paf_tables):
    """Too few lines for any read to reach the coverage depth: every read
    is sub-deleted and no arc survives."""
    paf = str(tmp_path / "few.paf")
    _write_paf(paf, _read_paf(base_paf)[:3])
    _, md, c = _select_both(paf, paf_tables)
    assert c[6] == 0 and c[5] == 0


@pytest.mark.parametrize("paf_tables", [False, True])
def test_select_tail_base_set(base_paf, paf_tables):
    _, md, c = _select_both(base_paf, paf_tables)
    assert c[6] > 0 and md["cont"].any()


def _tail_case(seed=2, n=300, T=40):
    """Random (colmat, final-pass output, mdel) for the tail's twin: lanes,
    codes mostly arcs, starts in [0, 5): many equal hit keys."""
    rng = np.random.default_rng(seed)
    colmat = torch.from_numpy(np.stack([
        rng.integers(0, T - 2, n), rng.integers(0, 5, n),
        rng.integers(0, 9000, n), rng.integers(0, T - 2, n),
        rng.integers(0, 5, n), rng.integers(0, 9000, n),
        rng.integers(0, 8, n)]).astype(np.int32))
    out = torch.from_numpy(rng.integers(-4, 9000, (15, n)).astype(np.int32))
    out[4] = torch.from_numpy(rng.integers(0, 4, n).astype(np.int32))
    mdel = torch.from_numpy(rng.random(T) < 0.1)
    return colmat, out, mdel


def test_arc_order_plain_layout():
    """The twin's result: the head [m_contained, n_arc, dup_hit], the meta
    rows, of which it writes the flags row only, then the five arc columns
    at a stride of n_arc, in (read, start, row) order; nothing after."""
    n, T, meta = 300, 40, 9
    n_seq = T - 2
    colmat, out, mdel = _tail_case()
    res = torch.full((tf.tail_words(n, n_seq, meta),), -7, dtype=torch.int32)
    assert res.shape == (3 + meta * n_seq + 10 * n,)
    assert tf.arc_order(colmat, out, mdel, n_seq, meta=meta, res=res) is res
    m_cont, n_arc, dup = res[:3].tolist()
    assert 0 < n_arc < 2 * n and dup > 0 and m_cont >= n_arc
    a0 = 3 + meta * n_seq
    cols = res[a0:a0 + 5 * n_arc].view(5, n_arc)
    assert (res[a0 + 5 * n_arc:] == -7).all()
    rows = res[3:a0].view(meta, n_seq)
    assert (rows[[0, 1, 3, 4, 5, 6, 7, 8]] == -7).all()
    head, flags, live = tf.arc_live(res, n_seq, meta)
    assert head.tolist() == [m_cont, n_arc, dup]
    assert torch.equal(live, cols) and torch.equal(flags, rows[2])
    tab = tf.read_marks_plain(colmat, out, T)[:n_seq]
    used, cont, pal = tab & 1, (tab >> 1) & 1, (tab >> 2) & 1
    assert torch.equal(flags, mdel[:n_seq].to(torch.int32) | (cont << 1)
                       | (used << 2) | (pal << 3))
    row = cols[4].long()
    read = torch.cat([colmat[0], colmat[3]])[row].long()
    start = torch.cat([colmat[1], colmat[4]])[row].long()
    key = (read << 40) | (start << 32) | row
    assert bool((key[1:] > key[:-1]).all())  # (read, start, row) order
    assert torch.equal(cols[0], torch.cat([out[6], out[11]])[row])


def _one_arc(orig):
    """arc_order with every lane of the final pass but one arc row's q-side
    cleared: the same twin on an input of exactly one arc."""
    def call(colmat, out, mdel, n_seq, **kw):
        live = tf.arc_live(orig(colmat, out, mdel, n_seq,
                                meta=kw.get("meta", 3)), n_seq,
                           kw.get("meta", 3))[2]
        n = colmat.shape[1]
        row = int(live[4][live[4] < n][0])
        one = out.clone()
        one[4] = 0
        one[4][row] = 1
        return orig(colmat, one, mdel, n_seq, **kw)
    return call


@pytest.mark.parametrize("paf_tables", [False, True])
@pytest.mark.parametrize("case", ["no_arcs", "one_arc", "base"])
def test_select_fetch_sized_by_n_arc(base_paf, tmp_path, monkeypatch, case,
                                     paf_tables):
    """select_build2 reads back counts, head and meta rows in one copy and
    the arcs, 5 * n_arc words, in a second (none without an arc): no copy
    is sized by the 2n rows' bound."""
    paf = base_paf
    if case == "no_arcs":
        paf = str(tmp_path / "few.paf")
        _write_paf(paf, _read_paf(base_paf)[:3])
    if case == "one_arc":
        monkeypatch.setattr(tf, "arc_order", _one_arc(tf.arc_order))
    sizes = []

    def to_host(t):
        sizes.append(t.numel())
        return t
    monkeypatch.setattr(tf, "to_host", to_host)
    opt = port_opt()
    col, d, h = t_load(paf, opt.min_span, opt.min_match, bi_dir=True,
                       min_iden=float(opt.min_iden), device=CPU)
    arcs, md, c = tf.select_build2(col, d, opt, bi_dir=True,
                                   paf_tables=paf_tables)
    h.free()
    n_arc, meta = c[6], 9 if paf_tables else 3
    assert n_arc == {"no_arcs": 0, "one_arc": 1}.get(case, n_arc) \
        and (n_arc > 100 or case != "base")
    assert sizes[0] == 14 + 3 + meta * d.n_seq
    assert sizes[1:] == ([5 * n_arc] if n_arc else [])
    assert sum(sizes) == 14 + 3 + meta * d.n_seq + 5 * n_arc
    assert arcs["u"].shape == arcs["idx"].shape == (n_arc,)
    assert md["used"].shape == (d.n_seq,)
