"""The port's select step (miniasm_tpu_torch/select/fused2.py: the plain
twins of the cut_hit2arc and sweep kernels plus the torch ops around
them) against the JAX package's select_build2 on the same PAF, and the
sweep twin, on the unsorted event columns, against the JAX sweep_events.
Everything compared is an integer or a bool: exact equality."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from miniasm_tpu.config import Opt as JOpt
from miniasm_tpu.io.native.pafload import load_hits_mt as j_load
from miniasm_tpu.select import fused2 as jf
from miniasm_tpu_torch.config import Opt
from miniasm_tpu_torch.io.native.pafload import load_hits_mt as t_load
from miniasm_tpu_torch.select import fused2 as tf


def port_opt():
    """The port's options, built field by field from the JAX package's."""
    return Opt.from_dict(dataclasses.asdict(JOpt()))


@pytest.fixture(scope="module")
def sim_long(tmp_path_factory):
    """Reads of ~40 kb: max read length >= 32768 takes the JAX program's
    seg_reduce_argmax branch (fused2.py:238-245) instead of pack15."""
    from miniasm_tpu.eval.simulate import simulate, write_paf

    paf = str(tmp_path_factory.mktemp("sim_long") / "long.paf")
    write_paf(simulate(genome_len=300_000, coverage=12.0, mean_read=40_000,
                       sd_read=8000, seed=5), paf)
    return {"paf": paf}


def _select_both(paf, bi_dir):
    jopt, opt = JOpt(), port_opt()
    jcol, jd, jh = j_load(paf, jopt.min_span, jopt.min_match, bi_dir=bi_dir,
                          min_iden=float(jopt.min_iden), upload=False)
    tcol, td, th = t_load(paf, opt.min_span, opt.min_match, bi_dir=bi_dir,
                          min_iden=float(opt.min_iden),
                          device=torch.device("cpu"))
    n, cap = tcol.shape[1], jcol.shape[1]
    # the JAX loader pads the host colmat with inert zero rows
    assert np.array_equal(tcol.numpy(), jcol[:, :n])
    assert not jcol[:, n:].any()
    assert td.names == jd.names and td.n_seq == jd.n_seq
    ja, jmd, jc = jf.select_build2(jcol, jd, jopt, bi_dir=bi_dir,
                                   max_len=jh.max_len)
    ta, tmd, tc = tf.select_build2(tcol, td, opt, bi_dir=bi_dir)
    jh.free()
    th.free()
    return (ja, jmd, jc), (ta, tmd, tc), n, cap, jh.max_len


@pytest.mark.parametrize("data,bi_dir", [("sim_small", True),
                                         ("sim_noisy", True),
                                         ("sim_long", True),
                                         ("sim_small", False)])
def test_select_build2_matches_jax(request, data, bi_dir):
    paf = request.getfixturevalue(data)["paf"]
    (ja, jmd, jc), (ta, tmd, tc), n, cap, max_len = _select_both(paf, bi_dir)
    if data == "sim_long":
        assert max_len >= 32768  # the non-pack15 branch ran
    for k in ("u", "v", "l", "ol"):
        assert np.array_equal(ta[k], ja[k]), k
    # arc ids: q-side rows j, m-side rows (rows + j); the JAX rows are
    # the padded capacity
    jidx = np.where(ja["idx"] >= cap, ja["idx"] - cap + n, ja["idx"])
    assert np.array_equal(ta["idx"], jidx)
    for k in ("sub_s", "sub_e", "sub_del", "cont", "used", "pal"):
        assert tmd[k].dtype == jmd[k].dtype, k
        assert np.array_equal(tmd[k], jmd[k]), k
    assert (tmd["tot_dp"], tmd["tot_len"]) == (jmd["tot_dp"], jmd["tot_len"])
    assert tc[:7] == jc[:7] and tc[7] == jc[13]
    assert tc[6] > 0


def _events(rng, T, n_ev=800):
    """Random sweep events of test_units' naive-sweep property test:
    multi-region segments, ties, presence-only (skipped) events, then
    padding rows up to n_ev events."""
    seg_l, key_l = [], []
    for _ in range(int(rng.integers(0, 300))):
        s = int(rng.integers(0, T))
        a = int(rng.integers(0, 500))
        b = a + int(rng.integers(1, 120))
        seg_l += [s, s]
        key_l += [a * 2, b * 2 + 1]
    for _ in range(int(rng.integers(0, 10))):
        seg_l.append(int(rng.integers(0, T)))
        key_l.append(int(jf.BIG))
    pad = n_ev - len(seg_l)
    seg_l += [T] * pad
    key_l += [int(jf.BIG)] * pad
    return np.asarray(seg_l, np.int32), np.asarray(key_l, np.int32)


def _jax_sweep(seg, key, T, min_dp, end_clip, pack15):
    sweep = jax.jit(functools.partial(
        jf.sweep_events, has_query=None, T=T, min_dp=min_dp,
        end_clip=end_clip, pack15=pack15))
    return [np.asarray(x) for x in sweep(seg, key)]


def _check_sweep(seg, key, T, min_dp, end_clip, pack15):
    """sweep_events on the unsorted columns (the CPU runs its plain
    version) against the JAX sweep_events on the same columns."""
    s, e, dele, has, n_rem, _ = _jax_sweep(seg, key, T, min_dp, end_clip,
                                           pack15)
    out = tf.sweep_events(torch.from_numpy(seg), torch.from_numpy(key), T,
                          min_dp, end_clip).numpy()
    assert out.shape == (4, T) and out.dtype == np.int32
    assert np.array_equal(out[0], s)
    assert np.array_equal(out[1], e)
    assert np.array_equal(out[2] != 0, dele)
    assert np.array_equal(out[3] != 0, has)
    assert int((out[0] != out[1]).sum()) == int(n_rem)
    return out


@pytest.mark.parametrize("pack15", [True, False])
@pytest.mark.parametrize("end_clip", [0, 3])
def test_sweep_plain_matches_jax_sweep_events(pack15, end_clip):
    rng = np.random.default_rng(7 + end_clip)
    T, min_dp = 64, (3 if end_clip else 1)
    for _ in range(10):
        seg, key = _events(rng, T)
        perm = rng.permutation(seg.shape[0])
        _check_sweep(seg[perm], key[perm], T, min_dp, end_clip, pack15)


def _sides(rng, segs, lo, hi, span):
    """One (start, end) event pair per entry of segs: starts in [lo, hi),
    lengths in [1, span)."""
    a = rng.integers(lo, hi, len(segs))
    b = a + rng.integers(1, span, len(segs))
    return (np.concatenate([segs, segs]).astype(np.int32),
            np.concatenate([a * 2, b * 2 + 1]).astype(np.int32))


def _sweep_case(case, rng):
    """(seg, key, T, min_dp, pack15) of the named edge case, shuffled."""
    big = int(jf.BIG)
    if case == "thousands_in_one_read":
        # read 3 holds 4000 events: a deep pile-up with many regions
        seg, key = _sides(rng, np.full(2000, 3), 0, 30000, 1500)
        s2, k2 = _sides(rng, rng.integers(0, 8, 200), 0, 20000, 900)
        seg, key = np.concatenate([seg, s2]), np.concatenate([key, k2])
        T, min_dp, pack15 = 8, 3, False
    elif case == "skipped_only_read":
        # read 1: skipped events only (has_query 1, del 1); read 2: none
        seg, key = _sides(rng, np.zeros(20, np.int64), 0, 500, 200)
        seg = np.concatenate([seg, [1, 1, 1]]).astype(np.int32)
        key = np.concatenate([key, [big] * 3]).astype(np.int32)
        T, min_dp, pack15 = 3, 2, True
    elif case == "empty_reads":
        # 2000 reads, events in 30 of them
        seg, key = _sides(rng, rng.choice(2000, 30), 0, 4000, 600)
        T, min_dp, pack15 = 2000, 1, True
    elif case == "equal_length_regions":
        # two regions of length 100 in read 0 (the first wins), and in
        # read 1 a later region one longer (it wins)
        seg = np.asarray([0] * 8 + [1] * 8, np.int32)
        pos = [(10, 110), (10, 110), (500, 600), (500, 600),
               (10, 110), (10, 110), (500, 601), (500, 601)]
        key = np.asarray([x for a, b in pos for x in (a * 2, b * 2 + 1)],
                         np.int32)
        T, min_dp, pack15 = 2, 2, True
    elif case == "all_padding":
        seg = np.full(64, 5, np.int32)
        key = np.full(64, big, np.int32)
        T, min_dp, pack15 = 5, 1, True
    else:  # one read
        seg, key = _sides(rng, np.zeros(300, np.int64), 0, 8000, 800)
        seg = np.concatenate([seg, [0, 1, 1]]).astype(np.int32)
        key = np.concatenate([key, [big, big, 40]]).astype(np.int32)
        T, min_dp, pack15 = 1, 3, False
    perm = rng.permutation(seg.shape[0])
    return seg[perm], key[perm], T, min_dp, pack15


@pytest.mark.parametrize("end_clip", [0, 7])
@pytest.mark.parametrize("case", ["thousands_in_one_read",
                                  "skipped_only_read", "empty_reads",
                                  "equal_length_regions", "all_padding",
                                  "one_read"])
def test_sweep_events_edge_cases_match_jax(case, end_clip):
    rng = np.random.default_rng(len(case) + end_clip)
    seg, key, T, min_dp, pack15 = _sweep_case(case, rng)
    out = _check_sweep(seg, key, T, min_dp, end_clip, pack15)
    if case == "skipped_only_read":
        assert out[:, 1].tolist() == [0, 0, 1, 1]
        assert out[:, 2].tolist() == [0, 0, 0, 0]
    elif case == "equal_length_regions":
        assert out[:2, 0].tolist() == [10 - end_clip, 110 + end_clip]
        assert out[:2, 1].tolist() == [500 - end_clip, 601 + end_clip]
    elif case == "all_padding":
        assert not out.any()
    elif case == "thousands_in_one_read":
        assert out[3, 3] == 1 and out[2, 3] == 0
