"""The port's staged selection path (-1, -2, -S below 5), module by module,
against the JAX package on the same inputs: the loader and hit mirror,
hit_sub (also against hit_sub_flat), hit_cut, hit_flt, contained_marks /
apply_contained and graph_from_hits.  The port's functions run their
plain PyTorch versions here (CPU tensors).  Every value compared is an
integer or a bool: exact equality."""

import dataclasses

import numpy as np
import pytest
import torch

from miniasm_tpu import pipeline as jpipe
from miniasm_tpu.config import Opt as JOpt
from miniasm_tpu.core import hits as jhits
from miniasm_tpu.graph import asg as jasg
from miniasm_tpu.io import paf as jpaf
from miniasm_tpu.select import contained as jcont
from miniasm_tpu.select import cut as jcut
from miniasm_tpu.select import filter as jflt
from miniasm_tpu.select import subregion as jsub
from miniasm_tpu_torch.config import Opt
from miniasm_tpu_torch.core import hits as thits
from miniasm_tpu_torch.graph import asg as tasg
from miniasm_tpu_torch.io import paf as tpaf
from miniasm_tpu_torch.io.seqdict import SeqDict
from miniasm_tpu_torch.select import contained as tcont
from miniasm_tpu_torch.select import cut as tcut
from miniasm_tpu_torch.select import filter as tflt
from miniasm_tpu_torch.select import subregion as tsub

JCOLS = ("qid", "qs", "qe", "tid", "ts", "te", "ml", "bl", "rev")


def port_opt():
    return Opt.from_dict(dataclasses.asdict(JOpt()))


def to_port_hits(jh) -> thits.Hits:
    """JAX package Hits (host columns) -> the port's (9, n) int32 hits."""
    cols = [np.asarray(getattr(jh, k)).astype(np.uint32).view(np.int32)
            for k in JCOLS]
    return thits.Hits(torch.from_numpy(np.stack(cols)))


def to_port_sub(s, e, dl) -> torch.Tensor:
    return torch.from_numpy(np.stack([
        np.asarray(s, np.uint32).view(np.int32),
        np.asarray(e, np.uint32).view(np.int32),
        np.asarray(dl).astype(np.int32)]))


def assert_hits_equal(th: thits.Hits, jh) -> None:
    got = th.numpy()
    for k in JCOLS:
        want = np.asarray(getattr(jh, k))
        assert got[k].dtype == want.dtype, k
        assert np.array_equal(got[k], want), k


def assert_sub_equal(sub: torch.Tensor, s, e, dl) -> None:
    got = sub.numpy()
    assert np.array_equal(got[0].view(np.uint32), np.asarray(s))
    assert np.array_equal(got[1].view(np.uint32), np.asarray(e))
    assert np.array_equal(got[2] != 0, np.asarray(dl))


@pytest.fixture(scope="module", params=[("sim_small", True),
                                        ("sim_noisy", True),
                                        ("sim_small", False)],
                ids=["small", "noisy", "small-b"])
def chain(request):
    """The JAX package's staged Steps 1-3 and graph build on a fixture,
    keeping every pass's inputs and outputs."""
    data, bi_dir = request.param
    paf = request.getfixturevalue(data)["paf"]
    o = JOpt()
    c = {"paf": paf, "bi_dir": bi_dir}
    load = jpaf.load_paf(paf, o.min_span, o.min_match)
    c["n_lines"], c["names"], c["lens"] = load.n_lines, list(load.d.names), \
        list(load.d.lens)
    d = load.d
    h0 = jhits.build_hits(load, bi_dir=bi_dir)
    n_seq = d.n_seq

    def sub(h, end_clip):
        return [np.asarray(x) for x in jsub.hit_sub(
            h.qid, h.tid, h.qs, h.qe, h.ml, h.bl, n_seq, o.min_dp,
            o.min_iden, end_clip)]

    def cut(h, s):
        r = jcut.hit_cut(h.qid, h.tid, h.qs, h.qe, h.ts, h.te, h.rev,
                         *s, o.min_span)
        return [np.asarray(x) for x in r]

    s1 = sub(h0, 0)
    cut1 = cut(h0, s1)
    h1 = jpipe._apply_cut(h0, *cut1)
    keep, dp = [np.asarray(x) for x in jflt.hit_flt(
        h1.qid, h1.tid, h1.qs, h1.qe, h1.ts, h1.te, h1.rev, *s1,
        int(o.max_hang * 1.5), int(o.min_ovlp * 0.5))]
    h2 = h1.take(keep)
    s2 = sub(h2, o.min_span // 2)
    cut2 = cut(h2, s2)
    h3 = jpipe._apply_cut(h2, *cut2)
    merged = (s1[0] + s2[0], s1[0] + s2[1], s1[2] | s2[2])
    cont = np.asarray(jcont.contained_marks(
        h3.qid, h3.tid, h3.qs, h3.qe, h3.ts, h3.te, h3.rev, merged[0],
        merged[1], n_seq, o.max_hang, o.int_frac, o.min_ovlp))
    h4, *sub4 = jcont.apply_contained(d, *merged, cont, h3)
    c.update(h0=h0, s1=s1, cut1=cut1, h1=h1, flt=(keep, dp), h2=h2, s2=s2,
             cut2=cut2, h3=h3, merged=merged, cont=cont, h4=h4, sub4=sub4,
             names4=list(d.names), lens4=d.lens_array(),
             dels4=d.del_array().copy())
    c["g4"] = jasg.graph_from_hits(o, d.lens_array(), d.del_array(), *sub4,
                                   h4)
    c["g0"] = jasg.graph_from_hits(
        o, np.asarray(c["lens"], np.uint32), np.zeros(n_seq, bool), None,
        None, None, h0)
    return c


def test_load_paf_and_build_hits_match_jax(chain):
    load = tpaf.load_paf(chain["paf"], 2000, 100)
    assert load.n_lines == chain["n_lines"]
    assert load.d.names == chain["names"] and load.d.lens == chain["lens"]
    assert_hits_equal(thits.build_hits(load, bi_dir=chain["bi_dir"]),
                      chain["h0"])


@pytest.mark.parametrize("which", ["pass1", "pass2"])
def test_hit_sub_matches_jax(chain, which):
    """hit_sub against the JAX hit_sub and hit_sub_flat: pass 1
    (end_clip 0) on the loaded hits, pass 2 (end_clip min_span/2) on the
    filtered ones."""
    o = JOpt()
    h, want, clip = ((chain["h0"], chain["s1"], 0) if which == "pass1"
                     else (chain["h2"], chain["s2"], o.min_span // 2))
    n_seq = len(chain["names"])
    sub = tsub.hit_sub(to_port_hits(h), n_seq, o.min_dp, o.min_iden, clip)
    assert_sub_equal(sub, *want)
    iden_ok = ~(np.asarray(h.ml, np.float32)
                < np.asarray(h.bl, np.float32) * np.float32(o.min_iden))
    flat = jsub.hit_sub_flat(h.qid, h.tid, h.qs, h.qe, iden_ok,
                             np.ones(h.n, bool), n_seq, o.min_dp, clip)
    assert_sub_equal(sub, *[np.asarray(x) for x in flat])
    assert (sub[0] != sub[1]).any()


@pytest.mark.parametrize("seed,min_dp,end_clip", [(1, 1, 0), (2, 3, 5),
                                                  (3, 2, 40)])
def test_hit_sub_random_matches_jax(seed, min_dp, end_clip):
    """Random hits: several regions per read, ties, self matches,
    identity failures and spans that clipping empties."""
    rng = np.random.default_rng(seed)
    n, T = 3000, 600
    qid = rng.integers(0, T, n).astype(np.int32)
    tid = np.where(rng.random(n) < 0.05, qid,
                   rng.integers(0, T, n)).astype(np.int32)
    qs = rng.integers(0, 400, n).astype(np.uint32)
    qe = (qs + rng.integers(0, 200, n)).astype(np.uint32)
    bl = rng.integers(50, 300, n).astype(np.uint32)
    ml = (bl * rng.random(n) * 0.2).astype(np.uint32)
    want = jsub.hit_sub(qid, tid, qs, qe, ml, bl, T + 3, min_dp, 0.05,
                        end_clip)
    z = np.zeros(n, np.uint32)
    h = thits.Hits(torch.from_numpy(np.stack([
        x.astype(np.uint32).view(np.int32)
        for x in (qid, qs, qe, tid, z, z, ml, bl, z)])))
    sub = tsub.hit_sub(h, T + 3, min_dp, 0.05, end_clip)
    assert_sub_equal(sub, *[np.asarray(x) for x in want])
    got = sub.numpy()
    assert got[2].any() and (got[0] != got[1]).any()


def test_hit_cut_synthetic_matches_jax():
    """Coordinates that straddle both trim ends on both strands, trims
    past the read end, projections that wrap below zero, and deleted
    reads."""
    rng = np.random.default_rng(11)
    n, T = 20000, 300
    qid = rng.integers(0, T, n).astype(np.int32)
    tid = rng.integers(0, T, n).astype(np.int32)
    qs = rng.integers(0, 9000, n).astype(np.uint32)
    qe = (qs + rng.integers(0, 9000, n)).astype(np.uint32)
    ts = rng.integers(0, 9000, n).astype(np.uint32)
    te = (ts + rng.integers(0, 9000, n)).astype(np.uint32)
    rev = rng.integers(0, 2, n).astype(np.uint8)
    # a few starts above 2**31: their projections wrap below zero, where
    # the unsigned s-side clamp differs from a signed one
    qs[rng.random(n) < 0.02] = (1 << 32) - rng.integers(1, 3000)
    s = rng.integers(0, 6000, T).astype(np.uint32)
    e = (s + rng.integers(0, 12000, T)).astype(np.uint32)
    dl = rng.random(T) < 0.1
    keep, *coords = [np.asarray(x) for x in jcut.hit_cut(
        qid, tid, qs, qe, ts, te, rev, s, e, dl, 2000)]
    z = np.zeros(n, np.uint32)
    cols = np.stack([x.astype(np.uint32).view(np.int32)
                     for x in (qid, qs, qe, tid, ts, te, z, z, rev)])
    got, gkeep = tcut.hit_cut(torch.from_numpy(cols), to_port_sub(s, e, dl),
                              2000)
    assert np.array_equal(gkeep.numpy(), keep)
    for k in range(4):
        assert np.array_equal(got[k].numpy().view(np.uint32), coords[k]), k
    assert keep.any() and not keep.all()
    assert (np.stack(coords) > np.uint32(1 << 31)).any()


@pytest.mark.parametrize("which", ["pass1", "pass2"])
def test_hit_cut_matches_jax(chain, which):
    h, s, want, after = ((chain["h0"], chain["s1"], chain["cut1"],
                          chain["h1"]) if which == "pass1" else
                         (chain["h2"], chain["s2"], chain["cut2"],
                          chain["h3"]))
    th, sub = to_port_hits(h), to_port_sub(*s)
    coords, keep = tcut.hit_cut(th.cols, sub, 2000)
    assert np.array_equal(keep.numpy(), want[0])
    for k in range(4):
        assert np.array_equal(coords[k].numpy().view(np.uint32), want[1 + k])
    assert_hits_equal(tcut.apply_cut(th, sub, 2000), after)


def test_hit_flt_matches_jax(chain):
    o = JOpt()
    keep, dp = tflt.hit_flt(to_port_hits(chain["h1"]),
                            to_port_sub(*chain["s1"]),
                            int(o.max_hang * 1.5), int(o.min_ovlp * 0.5))
    jkeep, jdp = chain["flt"]
    assert np.array_equal(keep.numpy(), jkeep)
    assert dp.dtype == torch.int32 and np.array_equal(dp.numpy(), jdp)
    dp_sum = int(dp.to(torch.int64).sum())
    assert dp_sum == int(np.sum(jdp, dtype=np.int64))
    h2, s1 = chain["h2"], chain["s1"]
    _, _, k_sum, present = tflt.hit_flt_sums(
        to_port_hits(chain["h1"]).cols, to_port_sub(*s1),
        int(o.max_hang * 1.5), int(o.min_ovlp * 0.5))
    assert int(k_sum) == dp_sum
    assert tflt.flt_coverage(present, dp_sum, to_port_sub(*s1)) == \
        jflt.flt_coverage(h2.qid, dp_sum, s1[0], s1[1], h2.n)


def test_hit_flt_synthetic_matches_jax():
    """Random hits and trim tables: every hit2arc class, deleted reads,
    lengths shorter than the hit."""
    rng = np.random.default_rng(12)
    n, T = 20000, 300
    qid = rng.integers(0, T, n).astype(np.int32)
    tid = rng.integers(0, T, n).astype(np.int32)
    qs = rng.integers(0, 6000, n).astype(np.uint32)
    qe = (qs + rng.integers(0, 8000, n)).astype(np.uint32)
    ts = rng.integers(0, 6000, n).astype(np.uint32)
    te = (ts + rng.integers(0, 8000, n)).astype(np.uint32)
    rev = rng.integers(0, 2, n).astype(np.uint8)
    s = rng.integers(0, 500, T).astype(np.uint32)
    e = (s + rng.integers(2000, 14000, T)).astype(np.uint32)
    dl = rng.random(T) < 0.1
    jkeep, jdp = [np.asarray(x) for x in jflt.hit_flt(
        qid, tid, qs, qe, ts, te, rev, s, e, dl, 1500, 1000)]
    z = np.zeros(n, np.uint32)
    h = thits.Hits(torch.from_numpy(np.stack([
        x.astype(np.uint32).view(np.int32)
        for x in (qid, qs, qe, tid, ts, te, z, z, rev)])))
    keep, dp = tflt.hit_flt(h, to_port_sub(s, e, dl), 1500, 1000)
    assert np.array_equal(keep.numpy(), jkeep)
    assert np.array_equal(dp.numpy(), jdp)
    assert jkeep.any() and not jkeep.all()


def test_contained_matches_jax(chain):
    """contained_marks, then apply_contained's squeeze and remap."""
    o = JOpt()
    n_seq = len(chain["names"])
    th, sub = to_port_hits(chain["h3"]), to_port_sub(*chain["merged"])
    marks = tcont.contained_marks(th, sub, n_seq, o.max_hang, o.int_frac,
                                  o.min_ovlp)
    assert np.array_equal(marks[0].numpy() != 0, chain["cont"])
    assert chain["cont"].any()
    # the reads some hit names (JAX apply_contained's used)
    used = np.zeros(n_seq, bool)
    used[chain["h3"].qid] = True
    used[chain["h3"].tid] = True
    assert np.array_equal(marks[1].numpy() != 0, used)
    d = SeqDict.from_arrays(chain["names"], chain["lens"])
    h4, sub4 = tcont.apply_contained(d, sub, marks, th)
    assert_hits_equal(h4, chain["h4"])
    assert_sub_equal(sub4, *chain["sub4"])
    assert d.names == chain["names4"]


@pytest.mark.parametrize("with_sub", [True, False])
def test_graph_from_hits_matches_jax(chain, with_sub):
    """With the trim tables of Steps 2-3 (the -1 / default staged
    graph), and without any (-1 -2: raw lengths)."""
    if with_sub:
        want = chain["g4"]
        g = tasg.graph_from_hits(port_opt(), chain["lens4"], chain["dels4"],
                                 to_port_sub(*chain["sub4"]),
                                 to_port_hits(chain["h4"]))
    else:
        want = chain["g0"]
        g = tasg.graph_from_hits(
            port_opt(), np.asarray(chain["lens"], np.uint32),
            np.zeros(len(chain["names"]), bool), None,
            to_port_hits(chain["h0"]))
    for f in dataclasses.fields(tasg.Graph):
        x, y = getattr(g, f.name), getattr(want, f.name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f.name
            assert np.array_equal(x, y), f.name
        else:
            assert x == y, f.name
    assert g.n_arc > 0
