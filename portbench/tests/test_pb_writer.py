"""The benchmark's frozen simulator writes the bytes of the program's
simulator (miniasm_tpu_torch/eval/simulate.write_paf) at the same seed,
and the generator's traffic is drawn from the seed."""

import gzip
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from portbench.gen import inputs, simulate as S  # noqa: E402


@pytest.mark.parametrize("seed,circular,genome", [
    (3, False, 150_000), (4, True, 150_000), (2**31 + 77, True, 90_000),
    (5, False, 30_000)])
def test_writer_bytes_equal_the_programs(tmp_path, seed, circular, genome):
    from miniasm_tpu_torch.eval import simulate as P

    kw = dict(genome_len=genome, coverage=30.0, seed=seed, circular=circular)
    mine, theirs = tmp_path / "mine.paf", tmp_path / "theirs.paf"
    n = S.write_paf(S.simulate(**kw), str(mine), chunk=1000)
    m = P.write_paf(P.simulate(**kw), str(theirs))
    assert n == m > 0
    assert mine.read_bytes() == theirs.read_bytes()


def test_digits_of_every_width():
    v = np.array([0, 9, 10, 99, 100, 123456789, 4294967295], dtype=np.int64)
    dig, keep = S._digits(v)
    got = [bytes(r[m]).decode() for r, m in zip(dig, keep)]
    assert got == [str(x) for x in v.tolist()]


def _cfg(**kw):
    return dict({"genome_len": 60_000, "coverage": 20.0, "circular": False,
                 "layout_seed": 17}, **kw)


def test_traffic_is_drawn_from_the_seed(tmp_path):
    half = {"recall": 0.5, "argv": ["-p", "ug"]}
    a, b, c = (tmp_path / x for x in "abc")
    for d in (a, b, c):
        d.mkdir()
    pa, na = inputs.make_paf(_cfg(), half, 11, str(a))
    pb, nb = inputs.make_paf(_cfg(), half, 11, str(b))
    pc, nc = inputs.make_paf(_cfg(), {"recall": 1.0, "argv": []}, 11, str(c))
    assert open(pa, "rb").read() == open(pb, "rb").read()
    assert 0.4 * nc < na < 0.6 * nc
    full = set(open(pc, "rb").read().split(b"\n"))
    assert set(open(pa, "rb").read().split(b"\n")) <= full


def test_every_seed_gets_the_same_work(tmp_path):
    """The layout comes from the configuration; the run's seed orders and
    names the reads: the same overlaps, the same sizes."""
    half = {"recall": 0.5, "argv": []}
    rows = []
    for seed in (1, 2):
        d = tmp_path / str(seed)
        d.mkdir()
        path, n = inputs.make_paf(_cfg(), half, seed, str(d))
        lines = open(path, "rb").read().split(b"\n")[:-1]
        rows.append((n, sorted(tuple(x.split(b"\t")[1:4] + x.split(b"\t")[6:])
                               for x in lines), lines))
    assert rows[0][0] == rows[1][0]
    assert rows[0][2] != rows[1][2]


def test_shuffled_and_gzip_mixes(tmp_path):
    grouped, _ = inputs.make_paf(_cfg(), {"recall": 1.0, "argv": []}, 5,
                                 str(tmp_path))
    lines = open(grouped, "rb").read().split(b"\n")
    d = tmp_path / "s"
    d.mkdir()
    path, n = inputs.make_paf(_cfg(), {"recall": 1.0, "order": "shuffled",
                                       "gzip": 1, "argv": []}, 5, str(d))
    assert path.endswith(".gz")
    shuf = gzip.open(path).read().split(b"\n")
    assert sorted(shuf) == sorted(lines) and shuf != lines


def test_unknown_traffic_keys_are_refused(tmp_path):
    with pytest.raises(ValueError):
        inputs.make_paf(_cfg(), {"recall": 1.0, "argv": [], "burst": 3}, 1,
                        str(tmp_path))
