"""The main path's streamed loader of the port (miniasm_tpu_torch/io/
native/pafload.py) against the JAX package's: the plain versions of the
K9 decode3 and K10 unpack4 kernels against _decode3_body and
_unpack4_jit on seeded pieces (K10's one call over a load's pieces piece
by piece), and the port's load_hits_mt colmat on the
CPU against the JAX load_hits_mt colmat in every case of the format
ladder (FMT3, 4-row, 7-row and the switches between them), with the
rank permutation that arc_ranks reads.  Integers only: exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from miniasm_tpu.io.native import pafload as J
from miniasm_tpu_torch.io.native import pafload as T

CPU = torch.device("cpu")


def fmt3_piece(rng, n, runs, *, pad_runs=True):
    """A flat FMT3 piece of n records (n a multiple of 16) with `runs`
    query runs: random coordinate words and nibbles, run starts ascending
    from 0, the sideband's unused tail -1 (or, without pad_runs, every
    slot a run start)."""
    m = n // 8
    coords = rng.integers(-2**31, 2**31, 3 * n, dtype=np.int64)
    nib = rng.integers(0, 16, n, dtype=np.uint64)
    words = np.zeros(m, np.uint64)
    for k in range(8):
        words |= nib[k::8] << np.uint64(4 * k)
    bp = np.full(m, -1, np.int64)
    bq = np.zeros(m, np.int64)
    k = runs if pad_runs else m
    starts = np.sort(rng.choice(np.arange(1, n), k - 1, replace=False))
    bp[:k] = np.concatenate([[0], starts])
    bq[:k] = rng.integers(0, 2**28, k)
    flat = np.concatenate([coords, words.astype(np.int64), bp, bq])
    return (flat & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def with_starts(rng, n, starts):
    """fmt3_piece of n records whose run table is `starts` (ascending,
    repeats allowed) with random qids, the rest of the table -1."""
    flat = fmt3_piece(rng, n, 2).astype(np.int64)
    m = n // 8
    bp = np.full(m, -1, np.int64)
    bp[:len(starts)] = starts
    flat[3 * n + m:3 * n + 2 * m] = bp
    flat[3 * n + 2 * m:] = np.where(bp >= 0, rng.integers(0, 2**28, m), 0)
    return (flat & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


PIECES = {
    "grouped": lambda rng: fmt3_piece(rng, 4096, 512, pad_runs=False),
    "padded_runs": lambda rng: fmt3_piece(rng, 4096, 37),
    "all_zero": lambda rng: np.zeros(3 * 4096 + 3 * 512, np.int32),
    "sixteen": lambda rng: fmt3_piece(rng, 16, 2),
    # the first run starts after record 0: the records before it get qid 0
    "late_first_run": lambda rng: with_starts(
        rng, 4096, np.sort(rng.choice(np.arange(700, 4096), 40, False))),
    "one_run": lambda rng: with_starts(rng, 4096, [0]),
    # every run starts in the last 16 records, most of them more than once
    "runs_in_last_16": lambda rng: with_starts(
        rng, 4096, np.sort(rng.integers(4080, 4096, 512))),
    # equal run starts resolve to the last of them
    "duplicate_starts": lambda rng: with_starts(
        rng, 4096, np.sort(rng.integers(0, 4096, 300))),
    # a whole piece of the main path's loader, grouped as it writes it
    "full_piece": lambda rng: fmt3_piece(rng, 131_072, 4000),
}


@pytest.mark.parametrize("case", sorted(PIECES))
def test_decode3_plain_matches_jax(case):
    flat = PIECES[case](np.random.default_rng(3))
    n = flat.shape[0] * 8 // 27
    want = np.asarray(J._decode3_body(jnp.asarray(flat), n))
    got = T.decode3(torch.from_numpy(flat)).numpy()
    assert got.dtype == np.int32 and got.shape == (4, n)
    assert np.array_equal(got, want)
    if case == "all_zero":
        assert not got.any()


def _packed(rng, rows, m):
    return rng.integers(0, 2**32, (rows, m), dtype=np.uint64) \
        .astype(np.uint32).view(np.int32)


# (rows, width, real records) of each piece of a load: 4-row pieces
# unpacked, 7-row pieces copied; odd counts, so that every piece after
# the first starts at a column offset that is not a multiple of 4
U4_LOADS = {
    "one_piece": [(4, 5000, 5000)],
    "packed_pieces": [(4, 4096, 4096), (4, 4096, 4093), (4, 4096, 17)],
    "mixed_rows": [(4, 4096, 4096), (4, 4096, 1201), (7, 1999, 1999),
                   (7, 4096, 3)],
    "seven_first": [(7, 33, 33), (4, 512, 1), (7, 512, 511)],
}


@pytest.mark.parametrize("case", sorted(U4_LOADS))
def test_unpack4_plain_matches_jax(case):
    """K10's one call over a load's pieces: each 4-row piece's columns
    against JAX _unpack4_jit of the piece, each 7-row piece's its own,
    at their column offsets, in a colmat wider than the pieces whose
    other columns stay untouched."""
    rng = np.random.default_rng(4)
    spec = U4_LOADS[case]
    pieces = [_packed(rng, rows, m) for rows, m, _n in spec]
    total = sum(n for _r, _m, n in spec)
    got = T.unpack4([(torch.from_numpy(p), n)
                     for p, (_r, _m, n) in zip(pieces, spec)]).numpy()
    assert got.dtype == np.int32 and got.shape == (7, total)
    out = torch.full((7, total + 300), -7, dtype=torch.int32)
    T.unpack4([(torch.from_numpy(p), n)
               for p, (_r, _m, n) in zip(pieces, spec)], out)
    o = out.numpy()
    col = 0
    for p, (rows, _m, n) in zip(pieces, spec):
        want = (np.asarray(J._unpack4_jit(jnp.asarray(p)))
                if rows == 4 else p)
        assert np.array_equal(got[:, col:col + n], want[:, :n])
        assert np.array_equal(o[:, col:col + n], want[:, :n])
        col += n
    assert (o[:, total:] == -7).all()


def _unpack_jax(a):
    """The JAX colmat as 7 rows (it stays 4-row when no piece needed 7)."""
    a = np.asarray(a)
    if a.shape[0] == 7:
        return a
    return np.asarray(J._unpack4_jit(jnp.asarray(a)))


def _write(path, lines):
    path.write_text("".join(line + "\n" for line in lines))
    return str(path)


def _grouped_lines(n_q, per_q):
    return ["q%05d\t9000\t%d\t%d\t+\tt%04d\t9000\t100\t8100\t6000\t8000"
            % (q, 10 + t, 8000 + t, (q + t + 1) % 997)
            for q in range(n_q) for t in range(per_q)]


def _big_record():
    return "big\t100000\t70000\t96000\t+\tother\t100000\t200\t26200\t" \
        "20000\t26000"


def ladder_input(case, tmp_path, sim_small):
    """(PAF path, piece size override or None) of a ladder case."""
    if case in ("fmt3", "fmt4"):
        return sim_small["paf"], None
    if case == "multi_piece":
        return _write(tmp_path / "multi.paf", _grouped_lines(21, 20)), 512
    if case == "rle_overflow":
        # alternating qids: one run per record overflows the sideband
        # (piece/8 runs) inside the first piece
        n = (T._CHUNK >> 2) // 8 + 2000
        return _write(tmp_path / "alt.paf", [
            "q%d\t9000\t10\t8000\t+\tt%d\t9000\t100\t8100\t6000\t8000"
            % (i % 997, 997 + (i % 991)) for i in range(n)]), None
    if case == "wrapped":
        return _write(tmp_path / "wrap.paf", [
            "a\t9000\t0\t5000\t+\tb\t9000\t100\t5100\t4000\t5000",
            "c\t9000\t70000\t100\t+\td\t9000\t100\t5100\t4000\t5000",
            "e\t9000\t0\t5000\t+\tf\t9000\t100\t5100\t4000\t5000"]), None
    if case == "late_pack":
        # two full FMT3 pieces of 128 records, then a record with 17-bit
        # coordinates inside the third: the stream ends 7-row
        lines = _grouped_lines(15, 20)
        return _write(tmp_path / "late.paf",
                      lines[:290] + [_big_record()] + lines[290:]), 512
    raise KeyError(case)


# (case, decode3 calls, unpack4 calls) of the port's ladder: K9 once a
# FMT3 piece, K10 once a load (4-row pieces unpacked, 7-row ones copied)
LADDER = [("fmt3", 1, 1), ("fmt4", 0, 1), ("multi_piece", 4, 1),
          ("rle_overflow", 0, 1), ("wrapped", 0, 1), ("late_pack", 2, 1)]


@pytest.mark.parametrize("case,n_dec,n_unp", LADDER,
                         ids=[c[0] for c in LADDER])
def test_load_hits_mt_matches_jax(case, n_dec, n_unp, tmp_path, sim_small,
                                  monkeypatch):
    paf, chunk = ladder_input(case, tmp_path, sim_small)
    if chunk:
        monkeypatch.setattr(J, "_MT_CHUNK", chunk)
        monkeypatch.setattr(T, "_CHUNK", chunk)
    if case == "fmt4":
        monkeypatch.setenv("MINIASM_TPU_FMT3", "0")
    calls = {"decode3": 0, "unpack4": 0}

    def counted(name):
        f = getattr(T, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return f(*a, **k)
        return wrapped

    for name in calls:
        monkeypatch.setattr(T, name, counted(name))
    jcol, jd, jh = J.load_hits_mt(paf, 2000, 100)
    tcol, td, th = T.load_hits_mt(paf, 2000, 100, device=CPU)
    n = th.n_orig
    assert n == jh.n_orig and th.n_mirror == jh.n_mirror and n > 0
    assert tcol.shape == (7, n) and th.cap == n
    ja = _unpack_jax(jcol)
    assert np.array_equal(tcol.numpy(), ja[:, :n])
    assert not ja[6, n:].any()  # the JAX padding is inert
    assert td.names == jd.names and td.lens == jd.lens
    assert (calls["decode3"], calls["unpack4"]) == (n_dec, n_unp)
    if case == "wrapped":
        assert tcol[1, 1] == 70000  # the wrapped start survived
    jidx = np.concatenate([np.arange(n), jh.cap + np.arange(n)])
    tidx = np.concatenate([np.arange(n), th.cap + np.arange(n)])
    assert np.array_equal(th.arc_ranks(tidx), jh.arc_ranks(jidx))
    jh.free()
    th.free()


def test_non_cpu_tensor_never_reaches_a_plain_version():
    """A wrapper takes its plain version only for a CPU tensor; any other
    tensor goes to the kernel, whose pointer check refuses all but a CUDA
    tensor."""
    meta = torch.zeros(3 * 16 + 6, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        T.decode3(meta)
    with pytest.raises(ValueError, match="CUDA"):
        T.unpack4([(torch.zeros((4, 16), dtype=torch.int32, device="meta"),
                    16)])
