"""The plain versions of the staged and sharded paths' last kernels against
the JAX package, on seeded numpy inputs: K16 `compact` (utils/compact.py)
against the compactions the JAX package runs in numpy (pipeline._apply_cut,
Hits.take, apply_contained), K17 `hit_flt` (select/filter.py) against JAX
hit_flt with its int64 dp sum and flt_coverage, K18 `hit_marks`
(core/hit2arc.py) in its two launches against JAX contained_marks with
the used reads of apply_contained and mark_unused, and graph_from_hits, and K19 `shard_arcs` (parallel/full.py)
inside the port's sharded step against the JAX step's arcmat, in order.
The port's functions run their plain versions here (CPU tensors); every
value compared is an integer or a bool: exact equality."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from miniasm_tpu import pipeline as jpipe
from miniasm_tpu.config import Opt as JOpt
from miniasm_tpu.core import hits as jhits
from miniasm_tpu.graph import asg as jasg
from miniasm_tpu.io.seqdict import SeqDict as JSeqDict
from miniasm_tpu.select import contained as jcont
from miniasm_tpu.select import filter as jflt
from miniasm_tpu_torch.config import Opt
from miniasm_tpu_torch.core import hit2arc as th2a
from miniasm_tpu_torch.core import hits as thits
from miniasm_tpu_torch.graph import asg as tasg
from miniasm_tpu_torch.io.seqdict import SeqDict
from miniasm_tpu_torch.select import contained as tcont
from miniasm_tpu_torch.select import filter as tflt
from miniasm_tpu_torch.utils.compact import compact, compact_plain
from test_torch_cuda import (SHARD_KINDS, _compact_case, _compact_kw,
                             _shard_case)

JCOLS = ("qid", "qs", "qe", "tid", "ts", "te", "ml", "bl", "rev")
KEEP_CASES = ["empty", "none", "all", "random"]


def port_opt():
    return Opt.from_dict(dataclasses.asdict(JOpt()))


def random_hits(rng, n, T, *, coord_hi=9000, wrap=0.0, self_pal=0.0):
    """Seeded JAX Hits: n hits among T reads; a `wrap` share of the starts
    just below 2**32, a `self_pal` share turned into exact reverse self
    palindromes (qid == tid, qs == ts, qe == te, rev)."""
    qid = rng.integers(0, T, n).astype(np.int32)
    tid = rng.integers(0, T, n).astype(np.int32)
    qs = rng.integers(0, coord_hi, n).astype(np.uint32)
    qs[rng.random(n) < wrap] = np.uint32(2**32 - 3000)
    qe = (qs + rng.integers(0, coord_hi, n)).astype(np.uint32)
    ts = rng.integers(0, coord_hi, n).astype(np.uint32)
    te = (ts + rng.integers(0, coord_hi, n)).astype(np.uint32)
    ml = rng.integers(0, 5000, n).astype(np.uint32)
    bl = (ml + rng.integers(0, 5000, n)).astype(np.uint32)
    rev = rng.integers(0, 2, n).astype(np.uint8)
    pal = rng.random(n) < self_pal
    tid[pal], ts[pal], te[pal], rev[pal] = qid[pal], qs[pal], qe[pal], 1
    return jhits.Hits(qid, qs, qe, tid, ts, te, ml, bl, rev)


def to_port(jh) -> thits.Hits:
    return thits.Hits(torch.from_numpy(np.stack([
        np.asarray(getattr(jh, k)).astype(np.uint32).view(np.int32)
        for k in JCOLS])))


def to_port_sub(s, e, dl) -> torch.Tensor:
    return torch.from_numpy(np.stack([
        np.asarray(s, np.uint32).view(np.int32),
        np.asarray(e, np.uint32).view(np.int32),
        np.asarray(dl).astype(np.int32)]))


def assert_hits_equal(th, jh):
    got = th.numpy()
    for k in JCOLS:
        want = np.asarray(getattr(jh, k))
        assert got[k].dtype == want.dtype, k
        assert np.array_equal(got[k], want), k


def keep_of(case, rng, n):
    if case == "none":
        return np.zeros(n, bool)
    if case == "all":
        return np.ones(n, bool)
    return rng.random(n) < 0.4


def trim_tables(rng, T, *, wrap=0.0):
    """Seeded trim tables: s, e uint32 (a `wrap` share of reads with e far
    below s, so e - s wraps), del bool."""
    s = rng.integers(0, 6000, T).astype(np.uint32)
    e = (s + rng.integers(0, 14000, T)).astype(np.uint32)
    w = rng.random(T) < wrap
    s[w] = np.uint32(2**32 - 100)
    return s, e, rng.random(T) < 0.1


# ---------------------------------------------------------------------------
# K16 compact

@pytest.mark.parametrize("case", KEEP_CASES)
def test_compact_matches_jax_apply_cut(case):
    rng = np.random.default_rng(1 + KEEP_CASES.index(case))
    n = 0 if case == "empty" else 3000
    jh = random_hits(rng, n, 200)
    keep = keep_of(case, rng, n)
    coords = [rng.integers(0, 2**32, n).astype(np.uint32) for _ in range(4)]
    want = jpipe._apply_cut(jh, keep, *coords)
    c = to_port(jh).cols
    cs = [torch.from_numpy(x.view(np.int32)) for x in coords]
    got = compact_plain([c[0], cs[0], cs[1], c[3], cs[2], cs[3], c[6], c[7],
                         c[8]], torch.from_numpy(keep).to(torch.uint8))
    assert_hits_equal(thits.Hits(got), want)
    assert want.n == int(keep.sum())


@pytest.mark.parametrize("case", KEEP_CASES)
def test_compact_matches_jax_hits_take(case):
    rng = np.random.default_rng(11 + KEEP_CASES.index(case))
    n = 0 if case == "empty" else 2500
    jh = random_hits(rng, n, 150)
    keep = keep_of(case, rng, n)
    th = to_port(jh)
    # bool and uint8 keeps, through the wrapper and the twin
    assert_hits_equal(th.take(torch.from_numpy(keep)), jh.take(keep))
    assert_hits_equal(thits.Hits(compact(
        th.cols, torch.from_numpy(keep.astype(np.uint8)))), jh.take(keep))


@pytest.mark.parametrize("drop", ["none", "query", "target", "both",
                                  "random"])
def test_compact_remap_matches_jax(drop):
    """The remap of apply_contained (JAX contained.py:65-75): a column
    goes where either id maps below 0; the survivors carry the new ids."""
    rng = np.random.default_rng(21)
    n, T = 2000, 120
    jh = random_hits(rng, n, T)
    mp = np.arange(T, dtype=np.int32)
    gone = {"none": [], "query": [int(jh.qid[0])],
            "target": [int(jh.tid[1])],
            "both": [int(jh.qid[2]), int(jh.tid[3])],
            "random": np.flatnonzero(rng.random(T) < 0.3).tolist()}[drop]
    mp[gone] = -1
    mp[mp >= 0] = np.arange(int((mp >= 0).sum()), dtype=np.int32)
    qn, tn = mp[jh.qid], mp[jh.tid]
    keep = (qn >= 0) & (tn >= 0)
    want = jhits.Hits(qn, jh.qs, jh.qe, tn, *jh.cols()[4:9]).take(keep)
    got = compact(to_port(jh).cols, mp=torch.from_numpy(mp))
    assert_hits_equal(thits.Hits(got), want)
    if drop == "query":
        assert not keep[0]
    if drop == "target":
        assert not keep[1]


def test_compact_trim_table_and_rows_from_several_tensors():
    """apply_contained's trim-table squeeze: three rows of three tensors by
    a keep byte."""
    rng = np.random.default_rng(31)
    T = 500
    s, e, dl = trim_tables(rng, T)
    keep = rng.random(T) < 0.5
    sub = to_port_sub(s, e, dl)
    got = compact([sub[0], sub[1].clone(), sub[2].clone()],
                  torch.from_numpy(keep))
    assert np.array_equal(got[0].numpy().view(np.uint32), s[keep])
    assert np.array_equal(got[1].numpy().view(np.uint32), e[keep])
    assert np.array_equal(got[2].numpy() != 0, dl[keep])


# the card cases' inputs (tests/test_torch_cuda.py) at a few of their
# item counts, through the port on the CPU and the JAX package's
# compactions: Hits.take, _apply_cut, apply_contained's remap.  The
# edges of a block's chunk and of the grid are the card's and stay with
# the card cases: the plain twin has no grid
JAX_MODES = ["keep", "none", "all", "remap", "keep_remap", "composed",
             "drop_all"]
CPU_NS = [0, 1, 257, 1025]
COMPACT_EDGES = [(n, mode) for n in CPU_NS for mode in JAX_MODES]


def _jax_compact(rows, keep, mp, mode):
    """The JAX package's compaction of the nine rows for a mode."""
    cols = [r.numpy() for r in rows]
    kw = _compact_kw(mode, keep, mp)
    ok = np.ones(len(cols[0]), bool) if kw["keep"] is None \
        else kw["keep"].numpy() != 0
    if mode == "composed":
        # apply_cut's: rows 1, 2, 4, 5 from K5's coordinates
        other = np.stack(cols)[::-1]
        return jpipe._apply_cut(jhits.Hits(*cols), ok, other[1], other[2],
                                other[4], other[5]).cols()
    if kw["mp"] is not None:
        # apply_contained's remap (JAX select/contained.py:65-75)
        m = mp.numpy()
        qn, tn = m[cols[0]], m[cols[3]]
        ok &= (qn >= 0) & (tn >= 0)
        cols = [qn, *cols[1:3], tn, *cols[4:]]
    return jhits.Hits(*cols).take(ok).cols()


@pytest.mark.parametrize("n,mode", COMPACT_EDGES)
def test_compact_edges_match_jax(n, mode):
    rows, keep, mp = _compact_case(np.random.default_rng(n % 997), n, mode)
    kw = _compact_kw(mode, keep, mp)
    cols = rows
    if mode == "composed":
        other = rows.flip(0).contiguous()
        cols = [rows[0], other[1], other[2], rows[3], other[4], other[5],
                rows[6], rows[7], rows[8]]
    got = compact(cols, **kw)
    want = _jax_compact(rows, keep, mp, mode)
    assert got.shape == (9, len(want[0]))
    for g, w in zip(got.numpy(), want):
        w = np.asarray(w)
        assert np.array_equal(g, w.view(np.int32) if w.dtype == np.uint32
                              else w)


def _jax_arc_tail(rows, out, marks, mdel):
    """The JAX sharded step's arc tail (miniasm_tpu/parallel/full.py:
    358-378) on one shard, in jnp as that program has it: read_alive, the
    aq/at gathers, m_contained, the arc lanes and their jnp.nonzero into
    [u l v ol gid]; with the arcs' side read and start below (the hit key
    order_arcs sorts by), gathered by the same index."""
    import jax.numpy as jnp

    i32 = jnp.int32
    r, o = jnp.asarray(rows.numpy()), jnp.asarray(out.numpy())
    mk = jnp.asarray(marks.numpy())
    n, T = r.shape[1], mk.shape[1]
    dump = T - 1
    qid, tid, gid = r[0], r[3], r[7]
    vq, vm = (o[4] & 1) != 0, (o[4] & 2) != 0
    read_alive = (mk[0] != 0) & ~jnp.asarray(mdel.numpy()) & ~(mk[1] != 0)
    aq = read_alive[jnp.minimum(qid, dump)]
    at = read_alive[jnp.minimum(tid, dump)]
    m_cont = jnp.sum(vq & aq & at) + jnp.sum(vm & aq & at)
    not_self = qid != tid
    arc_q = vq & (o[5] >= 0) & not_self & aq & at
    arc_m = vm & (o[10] >= 0) & not_self & aq & at
    arc_rows = jnp.concatenate([arc_q, arc_m])
    n_arc = int(jnp.sum(arc_rows))
    arc_cap = 2 * n
    idx = jnp.nonzero(arc_rows, size=arc_cap, fill_value=2 * n - 1)[0]
    ok = jnp.arange(arc_cap, dtype=i32) < n_arc
    arcmat = jnp.stack([
        jnp.where(ok, jnp.concatenate([o[6], o[11]])[idx], 0),
        jnp.where(ok, jnp.concatenate([o[8], o[13]])[idx], 0),
        jnp.where(ok, jnp.concatenate([o[7], o[12]])[idx], 0),
        jnp.where(ok, jnp.concatenate([o[9], o[14]])[idx], 0),
        jnp.where(ok, jnp.concatenate([gid, gid | 1])[idx], -1),
        jnp.concatenate([qid, tid])[idx],
        jnp.concatenate([r[1], r[4]])[idx]])
    return np.asarray(arcmat)[:, :n_arc], int(m_cont), n_arc


SHARD_EDGES = [(n, kind) for n in CPU_NS for kind in SHARD_KINDS]


@pytest.mark.parametrize("n,kind", SHARD_EDGES)
def test_shard_arcs_edges_match_jax(n, kind):
    from miniasm_tpu_torch.parallel.full import shard_arcs

    args = _shard_case(np.random.default_rng(19 + n % 83), n, kind=kind)
    arcmat, cnt = shard_arcs(*args)
    if n == 0:
        assert arcmat.shape == (7, 0) and cnt.tolist() == [0, 0]
        return
    want, m_cont, n_arc = _jax_arc_tail(*args)
    assert cnt.tolist() == [m_cont, n_arc]
    assert np.array_equal(arcmat.numpy(), want)
    if n > 1000:
        assert m_cont > n_arc and (n_arc > 0) == (kind in (
            "mixed", "q_only", "m_only"))


@pytest.mark.parametrize("seed", [41, 42])
def test_apply_contained_matches_jax(seed):
    """apply_contained through K18's used marks and K16's two compactions,
    on seeded hits with unused and contained reads."""
    rng = np.random.default_rng(seed)
    n, T = 3000, 400
    jh = random_hits(rng, n, T - 40)   # the last 40 reads are in no hit
    s, e, dl = trim_tables(rng, T)
    cont = rng.random(T) < 0.15
    names = ["r%d" % i for i in range(T)]
    lens = rng.integers(1000, 20000, T)
    jd, td = JSeqDict.from_arrays(names, lens), SeqDict.from_arrays(names,
                                                                  lens)
    jnew, js, je, jdl = jcont.apply_contained(jd, s, e, dl, cont, jh)
    # the containment pass's marks with the random containment in row 0
    # and K18's used marks in row 1
    marks = tcont.contained_marks(to_port(jh), to_port_sub(s, e, dl), T,
                                  1000, 0.8, 2000)
    marks[0] = torch.from_numpy(cont.astype(np.uint8))
    tnew, tsub = tcont.apply_contained(td, to_port_sub(s, e, dl), marks,
                                       to_port(jh))
    assert_hits_equal(tnew, jnew)
    assert np.array_equal(tsub[0].numpy().view(np.uint32), js)
    assert np.array_equal(tsub[1].numpy().view(np.uint32), je)
    assert np.array_equal(tsub[2].numpy() != 0, jdl)
    assert td.names == jd.names
    assert 0 < jnew.n < n


# ---------------------------------------------------------------------------
# K17 hit_flt

@pytest.mark.parametrize("seed,wrap,max_hang,min_ovlp", [
    (51, 0.0, 1500, 1000), (52, 0.05, 1500, 1000), (53, 0.1, 750, 1000),
    (54, 0.0, 3000, 200)])
def test_hit_flt_kernel_twin_matches_jax(seed, wrap, max_hang, min_ovlp):
    """keep, dp, the int64 dp sum and the coverage of the present reads
    against JAX hit_flt, np.sum(dp, int64) and flt_coverage: deleted
    reads, trim tables whose e - s wraps, starts near 2**32, every hit2arc
    class."""
    rng = np.random.default_rng(seed)
    n, T = 20000, 300
    jh = random_hits(rng, n, T, wrap=wrap / 2)
    s, e, dl = trim_tables(rng, T, wrap=wrap)
    jkeep, jdp = [np.asarray(x) for x in jflt.hit_flt(
        jh.qid, jh.tid, jh.qs, jh.qe, jh.ts, jh.te, jh.rev, s, e, dl,
        max_hang, min_ovlp)]
    keep, dp, dp_sum, present = tflt.hit_flt_sums(
        to_port(jh).cols, to_port_sub(s, e, dl), max_hang, min_ovlp)
    assert keep.dtype == torch.uint8 and dp.dtype == torch.int32
    assert np.array_equal(keep.numpy() != 0, jkeep)
    assert np.array_equal(dp.numpy(), jdp)
    want_sum = int(np.sum(np.asarray(jdp, dtype=np.int64)))
    assert dp_sum.dtype == torch.int64 and int(dp_sum) == want_sum
    kept = jh.take(jkeep)
    assert np.array_equal(np.flatnonzero(present.numpy()),
                          np.unique(kept.qid))
    assert tflt.flt_coverage(present, want_sum, to_port_sub(s, e, dl)) == \
        jflt.flt_coverage(kept.qid, want_sum, s, e, kept.n)
    # the classes hit_flt keeps and drops all occur
    r = th2a.hit2arc_rows_plain(to_port(jh).cols,
                                torch.from_numpy((e - s).view(np.int32)),
                                max_hang, 0.5, min_ovlp)[0]
    assert len(set(r.clamp(min=-5, max=0).tolist())) == 5
    assert jkeep.any() and not jkeep.all()


def test_hit_flt_no_hits():
    s, e, dl = trim_tables(np.random.default_rng(55), 10)
    keep, dp, dp_sum, present = tflt.hit_flt_sums(
        torch.zeros((9, 0), dtype=torch.int32), to_port_sub(s, e, dl),
        1500, 1000)
    assert keep.numel() == dp.numel() == 0 and int(dp_sum) == 0
    assert not present.any()
    assert tflt.flt_coverage(present, 0, to_port_sub(s, e, dl)) == 0.0


# ---------------------------------------------------------------------------
# K18 hit_marks

def jax_used(jh, T):
    """The reads some hit names, as JAX apply_contained computes them
    (miniasm_tpu/select/contained.py:60-62)."""
    used = np.zeros(T, dtype=bool)
    used[np.asarray(jh.qid)] = True
    used[np.asarray(jh.tid)] = True
    return used


@pytest.mark.parametrize("seed,int_frac,layout", [
    (61, 0.8, "random"), (62, 0.5, "random"), (63, 0.95, "random"),
    (64, 0.8, "sorted"), (65, 0.5, "targets_only")])
def test_hit_marks_contained_matches_jax(seed, int_frac, layout):
    """The containment pass's one K18 call: row 0 against JAX
    contained_marks, row 1 against the used reads of JAX apply_contained;
    hits in no order, sorted by query (the staged path's order), and with
    half the reads only ever targets; the last 40 reads in no hit."""
    rng = np.random.default_rng(seed)
    n, T = 20000, 400
    jh = random_hits(rng, n, T - 40)
    if layout == "sorted":
        jh = jh.take(np.argsort(jh.qid, kind="stable"))
    if layout == "targets_only":
        jh.qid[:] = jh.qid % ((T - 40) // 2)
    s, e, dl = trim_tables(rng, T)
    want = np.asarray(jcont.contained_marks(
        jh.qid, jh.tid, jh.qs, jh.qe, jh.ts, jh.te, jh.rev, s, e, T, 1000,
        int_frac, 2000))
    got = tcont.contained_marks(to_port(jh), to_port_sub(s, e, dl), T, 1000,
                                int_frac, 2000)
    assert got.dtype == torch.uint8 and got.shape == (2, T)
    assert np.array_equal(got[0].numpy() != 0, want)
    assert np.array_equal(got[1].numpy() != 0, jax_used(jh, T))
    assert want.any() and not want.all() and not got[1].all()
    if layout == "targets_only":
        q = np.zeros(T, bool)
        q[jh.qid] = True
        assert (got[1].numpy().astype(bool) & ~q).any()


@pytest.mark.parametrize("seed,with_sub", [(71, True), (72, False),
                                           (73, True)])
def test_hit_marks_sg_matches_jax_graph_from_hits(seed, with_sub):
    """graph_from_hits through K18's sg marks and K16's arc compaction:
    sdel (palindromes, query-contained reads) and the arcs, on seeded hits
    with exact reverse self palindromes and self matches."""
    rng = np.random.default_rng(seed)
    n, T = 6000, 300
    jh = random_hits(rng, n, T, self_pal=0.03)
    lens = rng.integers(8000, 20000, T).astype(np.uint32)
    dels = rng.random(T) < 0.05
    o = JOpt()
    if with_sub:
        s, e, dl = trim_tables(rng, T)
        want = jasg.graph_from_hits(o, lens, dels, s, e, dl, jh)
        sub = to_port_sub(s, e, dl)
    else:
        want = jasg.graph_from_hits(o, lens, dels, None, None, None, jh)
        sub = None
    got = tasg.graph_from_hits(port_opt(), lens, dels, sub, to_port(jh))
    for f in dataclasses.fields(tasg.Graph):
        x, y = getattr(got, f.name), getattr(want, f.name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name
    assert want.n_arc > 0


def test_hit_marks_sg_twin_marks_and_arcs():
    """The sg mode's own outputs on palindromes: the query of each exact
    reverse self palindrome and of each QCONT hit is marked; keep is an
    arc and not a self match; the columns are hit2arc's u v l ol."""
    rng = np.random.default_rng(74)
    jh = random_hits(rng, 5000, 200, self_pal=0.05)
    c = to_port(jh).cols
    lens = torch.from_numpy(rng.integers(8000, 20000, 200).astype(np.int32))
    mark, keep, arcs = th2a.hit_marks(c, "sg", 200, lens, 1000, 0.8, 2000)
    arc = th2a.hit2arc_rows_plain(c, lens, 1000, 0.8, 2000)
    r = arc[0].numpy()
    self_ = jh.qid == jh.tid
    pal = (r >= 0) & self_ & (jh.qs == jh.ts) & (jh.qe == jh.te) & \
        (jh.rev != 0)
    want = np.zeros(200, bool)
    want[jh.qid[pal | (r == th2a.MA_HT_QCONT)]] = True
    assert pal.any()
    assert np.array_equal(mark.numpy() != 0, want)
    assert np.array_equal(keep.numpy() != 0, (r >= 0) & ~self_)
    assert torch.equal(arcs, arc[1:])


@pytest.mark.parametrize("unused", [0, 40])
def test_hit_marks_used_matches_jax_mark_unused(unused):
    rng = np.random.default_rng(81 + unused)
    T = 300
    jh = random_hits(rng, 4000, T - unused)
    names = ["r%d" % i for i in range(T)]
    lens = rng.integers(1000, 9000, T)
    jd, td = JSeqDict.from_arrays(names, lens), SeqDict.from_arrays(names,
                                                                  lens)
    s, e, dl = trim_tables(rng, T)
    jhits.mark_unused(jd, jh)
    # the used row of the containment pass's one K18 call
    used = tcont.contained_marks(to_port(jh), to_port_sub(s, e, dl), T,
                                 1000, 0.8, 2000)[1].numpy()
    thits.mark_unused(td, used)
    assert np.array_equal(td.del_array(), jd.del_array())
    assert int(jd.del_array().sum()) >= unused
    assert np.array_equal(used == 0, jd.del_array())


# ---------------------------------------------------------------------------
# K19 shard_arcs

def _jax_step_one(paf):
    """The JAX package's sharded step on a one-device mesh: its arcmat
    [u l v ol gid] holds the step's arcs in its compaction order in the
    first n_arc columns."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from miniasm_tpu.parallel import full as jf
    from miniasm_tpu.parallel.mesh import make_mesh

    opt, mesh = JOpt(), make_mesh(1)
    cols, d, _, _ = jf._load_originals(paf, opt, None)
    n_seq = d.n_seq
    hostmat, per, block, cap = jf._partition(cols, n_seq, 1)
    max_len = int(np.max(d.lens_array()))
    step = jf._make_select_step(
        mesh, n_seq, jf._next_pow2(n_seq), opt, per=per, block=block,
        cap=cap, pack_se=max_len < 65535, arc_cap=2 * per,
        tr_cap=jf._next_pow2(max(1 << 14, 8 * block)),
        pack_ev=max_len < 32767 and n_seq + 2 <= 0xFFFF)
    gmat = jax.device_put(hostmat, NamedSharding(mesh, P(None, "r")))
    arcmat, _, counts = jax.device_get(jax.jit(step)(gmat))
    return np.asarray(arcmat), [int(x) for x in counts]


def _port_step_one(paf, tmp_path):
    from miniasm_tpu_torch.parallel import group
    from miniasm_tpu_torch.parallel.full import select_step, shard_rows
    from miniasm_tpu_torch.utils.timers import StageClock

    g = group.init(0, 1, "file://" + os.path.join(str(tmp_path), "rdv"),
                   device="cpu")
    try:
        rows, n_seq, block, _ = shard_rows(paf, Opt(), None, g,
                                           StageClock({}, g.device))
        arcmat, _, counts = select_step(rows, n_seq, block, Opt(), g)
    finally:
        group.destroy()
    return arcmat.numpy(), counts


@pytest.fixture(scope="module")
def dup_key_paf(tmp_path_factory):
    """A simulated read set with every 20th line also given with query and
    target swapped: the swapped line's q-lane arc and the original's
    m-lane arc share a hit key (read, start), the ties order_arcs keeps
    in the step's order."""
    from miniasm_tpu_torch.eval.simulate import simulate, write_paf

    d = tmp_path_factory.mktemp("dup_key")
    paf = str(d / "reads.paf")
    write_paf(simulate(genome_len=60_000, coverage=15.0, seed=9), paf)
    with open(paf) as f:
        lines = f.read().splitlines()
    swapped = []
    for x in lines[::20]:
        c = x.split("\t")
        swapped.append("\t".join(c[5:9] + [c[4]] + c[0:4] + c[9:]))
    with open(paf, "a") as f:
        f.write("".join(y + "\n" for y in swapped))
    return paf


def test_shard_arcs_matches_jax_step_order(dup_key_paf, tmp_path):
    want, jc = _jax_step_one(dup_key_paf)
    got, pc = _port_step_one(dup_key_paf, tmp_path)
    n_arc = jc[6]
    assert pc[5:7] == jc[5:7] and n_arc > 0
    assert got.shape == (7, n_arc)
    assert np.array_equal(got[:5], want[:, :n_arc])
    # q-lane arcs (even gid) first, in row order, then the m-lane arcs
    side = got[4] & 1
    assert side.any() and not side.all()
    assert np.all(np.diff(side) >= 0)
    # a hit key shared by a q-lane and an m-lane arc
    key = (got[5].astype(np.int64) << 32) | got[6].astype(np.uint32)
    assert np.intersect1d(key[side == 0], key[side == 1]).size > 0


def test_shard_arcs_twin_no_arcs():
    from miniasm_tpu_torch.parallel.full import shard_arcs

    n, T = 50, 12
    rows = torch.zeros((8, n), dtype=torch.int32)
    out = torch.zeros((15, n), dtype=torch.int32)
    marks = torch.zeros((3, T), dtype=torch.int32)
    arcmat, cnt = shard_arcs(rows, out, marks, torch.zeros(T, dtype=bool))
    assert arcmat.shape == (7, 0) and cnt.tolist() == [0, 0]
