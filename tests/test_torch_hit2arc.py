"""The port's hit -> arc classification and its cut_hit2arc kernel twin
(miniasm_tpu_torch/core/hit2arc.py, select/fused2.py) against the JAX
package's hit2arc and _cut_pass on the same numpy-seeded rows.  Every
output is an integer, so the tolerance is exact."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniasm_tpu.select import fused2 as jf
from miniasm_tpu_torch.select import fused2 as tf

# the JAX package's core/__init__ re-exports the function under the
# module's name, so import the modules by path
jh = importlib.import_module("miniasm_tpu.core.hit2arc")
th = importlib.import_module("miniasm_tpu_torch.core.hit2arc")

COLS = ("r", "u", "v", "l", "ol")


def _both(cols, max_hang, int_frac, min_ovlp):
    """hit2arc through both packages; cols = qid qs qe tid ts te rev ql tl."""
    j = jh.hit2arc(*[jnp.asarray(c.astype(np.int32)) for c in cols],
                   max_hang, int_frac, min_ovlp)
    t = th.hit2arc(*[torch.from_numpy(c.astype(np.int32)) for c in cols],
                   max_hang, int_frac, min_ovlp)
    return ({k: np.asarray(j[k]) for k in COLS},
            {k: t[k].numpy() for k in COLS})


def _matrix_rows(rng, n):
    """The classification matrix of test_units.test_hit2arc_matrix."""
    ql = rng.integers(3000, 20000, n)
    tl = rng.integers(3000, 20000, n)
    qs = rng.integers(0, 8000, n)
    qe = np.minimum(ql, qs + rng.integers(1000, 15000, n))
    ts = rng.integers(0, 8000, n)
    te = np.minimum(tl, ts + rng.integers(1000, 15000, n))
    rev = rng.integers(0, 2, n)
    return (rng.integers(0, 1000, n), qs, qe, rng.integers(0, 1000, n), ts,
            te, rev, ql, tl)


def _wide_rows(rng, n):
    """Coordinates anywhere in int32: sums wrap like the reference's
    32-bit arithmetic and the float32 test sees large magnitudes."""
    big = lambda: rng.integers(-2**31, 2**31, n)  # noqa: E731
    return (rng.integers(0, 2**29, n), big(), big(), rng.integers(0, 2**29, n),
            big(), big(), rng.integers(0, 2, n), big(), big())


def _frac_edge_rows(n):
    """span/total exactly at int_frac (4k of 5k): f32(5k) * f32(0.8)
    rounds back to 4k, so the internal test sits on its tie."""
    k = np.arange(1, n + 1)
    z = np.zeros(n, np.int64)
    span = 4 * k
    # ext5 = ext3 = k/2 rounded: qs = tl5 = a, ql - qe = tl3 = b
    a = k // 2
    b = k - a
    qs, qe = a, a + span
    # forward strand: tl5 = ts, tl3 = tl - te
    ts = a
    te = ts + span
    tl = te + b
    ql = qe + b
    return (z, qs, qe, z + 1, ts, te, z, ql, tl)


@pytest.mark.parametrize("case", ["matrix", "wide", "frac_edge"])
def test_hit2arc_matches_jax(case):
    rng = np.random.default_rng(0)
    rows = {"matrix": lambda: _matrix_rows(rng, 4000),
            "wide": lambda: _wide_rows(rng, 4000),
            "frac_edge": lambda: _frac_edge_rows(2000)}[case]()
    j, t = _both(rows, 1000, 0.8, 2000)
    for k in COLS:
        assert np.array_equal(j[k], t[k]), k
    if case == "frac_edge":
        assert not np.any(t["r"] == jh.MA_HT_INT)  # a tie is not internal


def test_hit2arc_arc_fields():
    rows = tuple(np.array([x]) for x in (3, 5000, 10000, 7, 0, 5000, 0,
                                         10000, 12000))
    j, t = _both(rows, 1000, 0.8, 2000)
    assert [int(t[k][0]) for k in COLS] == [5000, 6, 14, 5000, 5000]
    assert all(np.array_equal(j[k], t[k]) for k in COLS)


def _cut_case(seed, n=20_000, T=300):
    rng = np.random.default_rng(seed)
    qid = rng.integers(0, T - 2, n)
    tid = rng.integers(0, T - 2, n)
    qs = rng.integers(0, 20000, n)
    qe = qs + rng.integers(0, 20000, n)
    ts = rng.integers(0, 20000, n)
    te = ts + rng.integers(0, 20000, n)
    flags = rng.integers(0, 8, n)
    colmat = np.stack([qid, qs, qe, tid, ts, te, flags]).astype(np.int32)
    s = rng.integers(0, 3000, T)
    e = s + rng.integers(0, 30000, T)
    dele = rng.random(T) < 0.1
    tab = np.stack([s, e, dele]).astype(np.int32)
    lanes = rng.integers(0, 4, n).astype(np.uint8)
    return colmat, tab, lanes


@pytest.mark.parametrize("final_pass", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_cut_hit2arc_plain_matches_jax_cut_pass(seed, final_pass):
    colmat, tab, lanes = _cut_case(seed)
    qid, qs, qe, tid, ts, te, fl = colmat
    rev = (fl >> 1) & 1
    # the reference's e-side clamp compares as uint32: make sure rows
    # with a projected end below zero are present
    rt_s, rt_e = tab[0][tid], tab[1][tid]
    qe1 = np.where(rev != 0, np.where(ts > rt_s, qe, qe - (rt_s - ts)),
                   np.where(te < rt_e, qe, qe - (te - rt_e)))
    assert (qe1 < 0).sum() > 100

    if final_pass:
        mh, fr, mo = 1000, 0.8, 2000
    else:
        mh, fr, mo = 1500, 0.5, 1000
    words = jf._pack_tab(jnp.asarray(tab[0]), jnp.asarray(tab[1]),
                         jnp.asarray(tab[2] != 0), False)
    keep, jqs, jqe, jts, jte, slq, slt = [np.asarray(x) for x in jf._cut_pass(
        *[jnp.asarray(c) for c in (qid, tid, qs, qe, ts, te, rev)], words,
        False, 2000)]
    c = torch.from_numpy(colmat)
    out = tf.cut_hit2arc(c, c[[1, 2, 4, 5]].contiguous(),
                         torch.from_numpy(lanes), torch.from_numpy(tab),
                         min_span=2000, max_hang=mh, int_frac=fr,
                         min_ovlp=mo, final_pass=final_pass).numpy()
    for row, want in zip(out[:4], (jqs, jqe, jts, jte)):
        assert np.array_equal(row, want)
    vq = ((lanes & 1) != 0) & keep
    vm = ((lanes & 2) != 0) & keep
    cq = jh.hit2arc(qid, jqs, jqe, tid, jts, jte, rev, slq, slt, mh, fr, mo)
    cm = jh.hit2arc(tid, jts, jte, qid, jqs, jqe, rev, slt, slq, mh, fr, mo)
    cq = {k: np.asarray(v) for k, v in cq.items()}
    cm = {k: np.asarray(v) for k, v in cm.items()}
    if final_pass:
        assert np.array_equal(out[4], vq | (vm.astype(np.int32) << 1))
        for i, k in enumerate(COLS):
            assert np.array_equal(out[5 + i], cq[k]), k
            assert np.array_equal(out[10 + i], cm[k]), k
        return
    # relaxed pass: the filter masks and dp values of fused2.py:358-376
    def keep_of(r):
        return (r >= 0) | (r == jh.MA_HT_QCONT) | (r == jh.MA_HT_TCONT)

    def dp_of(r, a, b):
        return np.where(r >= 0, r, np.where(r == jh.MA_HT_QCONT, a, b))

    fq = vq & keep_of(cq["r"])
    fm = vm & keep_of(cm["r"])
    bits = vq | (vm << 1) | (fq.astype(np.int32) << 2) | (fm.astype(np.int32) << 3)
    assert np.array_equal(out[4], bits)
    dp = np.where(fq, dp_of(cq["r"], slq, slt), 0) + np.where(
        fm, dp_of(cm["r"], slt, slq), 0)
    assert np.array_equal(out[5], dp)
