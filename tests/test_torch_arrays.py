"""The port's array helpers (miniasm_tpu_torch/utils/arrays.py:
argsort_multi, sort_rows_multi, segment_starts, csr_index, compact)
against the JAX functions of miniasm_tpu/utils/arrays.py on the same
seeded numpy columns, bit for bit: every output value and its dtype."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniasm_tpu.utils import arrays as ja
from miniasm_tpu_torch.utils import arrays as ta

# value ranges of the key columns: many ties, negative keys, the whole
# int32 range (INT32_MAX itself among them)
DISTS = {"ties": (0, 3), "neg": (-1000, 1000),
         "wide": (-2**31, 2**31 - 1)}


def _cols(seed, m, k, dist):
    rng = np.random.default_rng(seed)
    lo, hi = DISTS[dist]
    cols = [rng.integers(lo, hi, m, endpoint=True).astype(np.int32)
            for _ in range(k)]
    if dist == "wide" and m:
        cols[0][rng.integers(0, m)] = 2**31 - 1
    return cols


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    g = got.numpy()
    assert g.dtype == want.dtype, (g.dtype, want.dtype)
    assert g.shape == want.shape
    assert np.array_equal(g, want)


def _n_of(case, m):
    return {"none": None, "zero": 0, "all": m, "part": m // 2,
            "over": m + 3}[case]


# (m rows, key columns, distribution, n) for the sorts
SORT_CASES = [(0, 1, "ties", "none"), (0, 2, "neg", "zero"),
              (1, 1, "neg", "all"), (1, 3, "wide", "zero"),
              (17, 1, "ties", "none"), (17, 2, "ties", "part"),
              (17, 3, "ties", "all"), (64, 1, "neg", "part"),
              (64, 2, "neg", "none"), (64, 3, "neg", "over"),
              (300, 1, "wide", "all"), (300, 2, "wide", "part"),
              (300, 3, "wide", "none"), (300, 3, "ties", "zero"),
              (1000, 2, "ties", "part"), (1000, 3, "neg", "all")]


def _ids(cases):
    return ["-".join(str(x) for x in c) for c in cases]


@pytest.mark.parametrize("m,k,dist,ncase", SORT_CASES, ids=_ids(SORT_CASES))
def test_argsort_multi_matches_jax(m, k, dist, ncase):
    cols = _cols(m * 31 + k, m, k, dist)
    n = _n_of(ncase, m)
    want = ja.argsort_multi([jnp.asarray(c) for c in cols], n=n)
    got = ta.argsort_multi([torch.from_numpy(c) for c in cols], n=n)
    _same(got, want)


@pytest.mark.parametrize("m,k,dist,ncase", SORT_CASES[::2],
                         ids=_ids(SORT_CASES[::2]))
def test_sort_rows_multi_matches_jax(m, k, dist, ncase):
    # k key columns chosen among k + 2 columns, out of order
    cols = _cols(m * 37 + k, m, k + 2, dist)
    keys_idx = list(range(k + 1, 1, -1))
    n = _n_of(ncase, m)
    want_cols, want_perm = ja.sort_rows_multi(
        [jnp.asarray(c) for c in cols], keys_idx, n=n)
    got_cols, got_perm = ta.sort_rows_multi(
        [torch.from_numpy(c) for c in cols], keys_idx, n=n)
    _same(got_perm, want_perm)
    for g, w in zip(got_cols, want_cols):
        _same(g, w)


def _sorted_ids(seed, m, dist):
    return np.sort(_cols(seed, m, 1, dist)[0])


# (m rows, distribution, n) for the id-column helpers
ID_CASES = [(0, "ties", "zero"), (1, "neg", "all"), (1, "neg", "zero"),
            (40, "ties", "all"), (40, "ties", "part"), (40, "neg", "over"),
            (500, "ties", "part"), (500, "neg", "all")]


@pytest.mark.parametrize("m,dist,ncase", ID_CASES, ids=_ids(ID_CASES))
def test_segment_starts_matches_jax(m, dist, ncase):
    ids = _sorted_ids(m + 5, m, dist)
    n = _n_of(ncase, m)
    want = ja.segment_starts(jnp.asarray(ids), n)
    _same(ta.segment_starts(torch.from_numpy(ids), n), want)


@pytest.mark.parametrize("m,dist,ncase", ID_CASES, ids=_ids(ID_CASES))
@pytest.mark.parametrize("num_segments", [1, 4, 1200])
def test_csr_index_matches_jax(m, dist, ncase, num_segments):
    # ids run from the negative range, past num_segments too
    ids = _sorted_ids(m + 9, m, dist)
    n = _n_of(ncase, m)
    want = ja.csr_index(jnp.asarray(ids), n, num_segments)
    got = ta.csr_index(torch.from_numpy(ids), n, num_segments)
    for g, w in zip(got, want):
        _same(g, w)


def test_csr_index_unit_case():
    """tests/test_units.py's case: ids 0 0 2 2 2 5 over 7 segments."""
    ids = np.array([0, 0, 2, 2, 2, 5], dtype=np.int32)
    start, cnt = ta.csr_index(torch.from_numpy(ids), 6, 7)
    assert cnt.tolist() == [2, 0, 3, 0, 0, 1, 0]
    assert start[0] == 0 and start[2] == 2 and start[5] == 5
    want = ja.csr_index(jnp.asarray(ids), 6, 7)
    _same(start, want[0])
    _same(cnt, want[1])


# (m rows, share of rows kept, n)
COMPACT_CASES = [(0, 0.5, "none"), (1, 1.0, "all"), (1, 0.0, "none"),
                 (33, 0.5, "none"), (33, 0.5, "part"), (33, 1.0, "zero"),
                 (33, 0.0, "all"), (400, 0.1, "part"), (400, 0.9, "over"),
                 (400, 0.5, "all")]


@pytest.mark.parametrize("m,frac,ncase", COMPACT_CASES,
                         ids=_ids(COMPACT_CASES))
def test_compact_matches_jax(m, frac, ncase):
    rng = np.random.default_rng(m + int(frac * 10))
    mask = rng.random(m) < frac
    cols = _cols(m + 3, m, 2, "neg")
    n = _n_of(ncase, m)
    want_cols, want_n = ja.compact(jnp.asarray(mask),
                                   [jnp.asarray(c) for c in cols], n=n)
    got_cols, got_n = ta.compact(torch.from_numpy(mask),
                                 [torch.from_numpy(c) for c in cols], n=n)
    _same(got_n, want_n)
    for g, w in zip(got_cols, want_cols):
        _same(g, w)
