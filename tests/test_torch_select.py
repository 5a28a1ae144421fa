"""The port's select step (miniasm_tpu_torch/select/fused2.py: the plain
twins of the cut_hit2arc and sweep kernels plus the torch ops around
them) against the JAX package's select_build2 on the same PAF, and the
sweep twin against the JAX sweep_events.  Everything compared is an
integer or a bool: exact equality."""

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


@pytest.mark.parametrize("pack15", [True, False])
@pytest.mark.parametrize("end_clip", [0, 3])
def test_sweep_plain_matches_jax_sweep_events(pack15, end_clip):
    rng = np.random.default_rng(7 + end_clip)
    T, min_dp = 64, (3 if end_clip else 1)
    sweep = jax.jit(functools.partial(
        jf.sweep_events, has_query=None, T=T, min_dp=min_dp,
        end_clip=end_clip, pack15=pack15))
    for _ in range(10):
        seg, key = _events(rng, T)
        s, e, dele, has, n_rem, _ = [np.asarray(x)
                                     for x in sweep(seg, key)]
        keys = (seg.astype(np.int64) << 32) | key.astype(np.int64)
        out = tf.sweep(torch.sort(torch.from_numpy(keys)).values, T, min_dp,
                       end_clip).numpy()
        assert np.array_equal(out[0], s)
        assert np.array_equal(out[1], e)
        assert np.array_equal(out[2] != 0, dele)
        assert np.array_equal(out[3] != 0, has)
        assert int((out[0] != out[1]).sum()) == int(n_rem)
