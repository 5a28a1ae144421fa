"""K11 `route` (miniasm_tpu_torch/parallel/route.py): its plain version
against a numpy transcription of the JAX package's bucketing, the
mirror-event exchange of parallel/full.py:209-231 and the repartition of
parallel/multihost.py:340-353 (the same recipe with capR).  Integers
only: exact equality.  The CUDA kernel is held against the plain version
in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from miniasm_tpu_torch.parallel import route as rt


def jax_send(dest, payload, n_sh, cap):
    """full.py:209-231 in numpy: a stable sort by destination, slot =
    iota - first[dest], the scatter into (R, n_sh, cap); rows with
    dest == n_sh land in the sliced-off tail slot."""
    L = dest.shape[0]
    R = payload.shape[0]
    iota = np.arange(L, dtype=np.int32)
    order = np.argsort(dest, kind="stable")
    sdest = dest[order]
    first = np.searchsorted(sdest, np.arange(n_sh + 1, dtype=np.int32),
                            side="left").astype(np.int32)
    slot = iota - first[np.minimum(sdest, n_sh)]
    flat = np.where(sdest < n_sh, sdest * cap + slot, n_sh * cap)
    send = np.zeros((R, n_sh * cap + 1), np.int32)
    send[:, flat] = payload[:, order]
    return send[:, :n_sh * cap].reshape(R, n_sh, cap)


def _case(kind, n_sh, rng, L=3000, R=4):
    """(dest, payload): random destinations with dropped rows; 'sparse'
    leaves every other bucket empty and drops most rows; 'ties' sends
    every kept row to one bucket; 'dropped' drops every row; 'one_bucket'
    sends every row to one bucket; 'L1', 'L4095' and 'L4097' are random
    destinations on that many rows (the kernels tile by 1024 rows)."""
    if kind.startswith("L"):
        kind, L = "random", int(kind[1:])
    if kind == "random":
        dest = rng.integers(0, n_sh + 1, L)
    elif kind == "sparse":
        dest = np.where(rng.random(L) < 0.7, n_sh,
                        2 * rng.integers(0, (n_sh + 1) // 2, L))
    elif kind == "dropped":
        dest = np.full(L, n_sh)
    elif kind == "one_bucket":
        dest = np.full(L, n_sh // 2)
    else:
        dest = np.where(rng.random(L) < 0.2, n_sh, n_sh - 1)
    payload = rng.integers(-2**31, 2**31 - 1, (R, L))
    return dest.astype(np.int32), payload.astype(np.int32)


def _exact(want, hist):
    """The JAX buffer (R, n_sh, cap) cut to each bucket's real rows, the
    buckets back to back: the port's exact-size send buffer, transposed."""
    return np.concatenate([want[:, k, :hist[k]] for k in range(len(hist))],
                          axis=1)


@pytest.mark.parametrize("kind", ["random", "sparse", "ties", "dropped",
                                  "one_bucket", "L1", "L4095", "L4097"])
@pytest.mark.parametrize("n_sh", [1, 2, 3, 8, 1024])
def test_route_plain_matches_jax_bucketing(n_sh, kind):
    rng = np.random.default_rng(100 * n_sh + len(kind))
    dest, payload = _case(kind, n_sh, rng)
    hist = np.bincount(dest, minlength=n_sh + 1)[:n_sh]
    want = jax_send(dest, payload, n_sh, max(int(hist.max()), 1))
    layout = rt.Layout(torch.from_numpy(dest), n_sh)
    assert layout.sizes == hist.tolist() and layout.total == hist.sum()
    assert layout.off.tolist() == [0] + np.cumsum(hist).tolist()
    got = rt.route(layout, torch.from_numpy(payload))
    assert np.array_equal(got.numpy().T, _exact(want, hist))
    if kind == "sparse" and n_sh > 1:
        assert 0 in layout.sizes
    if kind == "dropped":
        assert layout.total == 0 and got.shape == (0, payload.shape[0])
    if kind == "one_bucket":
        assert layout.sizes[n_sh // 2] == dest.shape[0]


def test_route_repart_rows_match_jax():
    """The repartition's layout: all 8 rows of a (qid qs qe tid ts te
    flags gid) matrix to their query's owner, invalid rows dropped."""
    rng = np.random.default_rng(5)
    n_seq, n_sh, L = 500, 3, 4000
    cm = rng.integers(0, 10000, (8, L)).astype(np.int32)
    cm[0] = rng.integers(0, n_seq, L)
    cm[6] = rng.integers(0, 8, L)
    block = -(-n_seq // n_sh)
    dest = np.where((cm[6] & 1) != 0, cm[0] // block, n_sh).astype(np.int32)
    hist = np.bincount(dest, minlength=n_sh + 1)[:n_sh]
    want = jax_send(dest, cm, n_sh, int(hist.max()))
    got = rt.route(rt.Layout(torch.from_numpy(dest), n_sh),
                   torch.from_numpy(cm))
    assert np.array_equal(got.numpy().T, _exact(want, hist))


def test_route_layout_serves_both_sweep_passes():
    """One layout, two payloads (the select step's two sweep passes): each
    send buffer is the JAX bucketing of its own payload."""
    rng = np.random.default_rng(9)
    dest, p1 = _case("random", 3, rng)
    p2 = rng.integers(-9, 9, p1.shape).astype(np.int32)
    hist = np.bincount(dest, minlength=4)[:3]
    layout = rt.Layout(torch.from_numpy(dest), 3)
    for p in (p1, p2):
        want = jax_send(dest, p, 3, int(hist.max()))
        got = rt.route(layout, torch.from_numpy(p))
        assert np.array_equal(got.numpy().T, _exact(want, hist))


def test_route_overflow_and_bad_destinations_raise():
    dest = torch.tensor([0, 1, 1, 1, 2, 0], dtype=torch.int32)
    payload = torch.arange(12, dtype=torch.int32).view(2, 6)
    layout = rt.Layout(dest, 2)
    assert layout.sizes == [2, 3]
    assert rt.route(layout, payload).shape == (5, 2)
    # a payload with more rows than the layout counted would overflow its
    # buckets: an error, never a drop
    with pytest.raises(ValueError, match="payload"):
        rt.route(layout, torch.arange(14, dtype=torch.int32).view(2, 7))
    with pytest.raises(ValueError, match="payload"):
        rt.route(layout, payload.to(torch.int64))
    with pytest.raises(ValueError, match="beyond"):
        rt.Layout(dest + 1, 2)
    with pytest.raises(ValueError, match="negative"):
        rt.Layout(dest - 1, 2)
    with pytest.raises(ValueError, match="int32"):
        rt.Layout(dest.to(torch.int64), 2)
