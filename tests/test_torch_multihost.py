"""The port's multi-process worker (miniasm_tpu_torch/parallel/multihost.py)
against the JAX package's: the byte-range helpers on seeded files, the
loader's bl-carry seed on a range that starts with 10-field lines, and
the worker at 2 and 3 processes over gloo on the CPU (and on a .gz input
at 2), whose GFA must be byte-identical to the JAX single-process
pipeline on test_multihost.py's simulation (150 kb, 18x, seed 23)."""

import gzip
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from miniasm_tpu.parallel import multihost as jmh
from miniasm_tpu_torch.device import ENV
from miniasm_tpu_torch.parallel import multihost as tmh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _paf_lines(rng, n):
    """PAF lines of 10, 11 and 12 fields (a 10-field line reuses the bl
    of the line before it, paf.c:56-60), with small matches against
    large block lengths so that the carried bl decides the identity
    filter."""
    out = []
    for i in range(n):
        ql, tl = int(rng.integers(5000, 9000)), int(rng.integers(5000, 9000))
        qs, ts = int(rng.integers(0, 500)), int(rng.integers(0, 500))
        qe, te = qs + 4000, ts + 4000
        f = ["q%d" % (i % 37), str(ql), str(qs), str(qe), "+-"[i % 2],
             "t%d" % (i % 41), str(tl), str(ts), str(te),
             str(int(rng.integers(150, 400)))]
        k = int(rng.integers(0, 3))
        if k >= 1:
            f.append(str(int(rng.integers(3000, 6000))))
        if k == 2:
            f.append("255")
        out.append(("\t".join(f) + "\n").encode())
    return out


@pytest.fixture(scope="module")
def seeded_paf(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("ranges") / "r.paf")
    with open(p, "wb") as f:
        f.writelines(_paf_lines(np.random.default_rng(11), 3000))
    return p


@pytest.mark.parametrize("n", [2, 3, 7])
def test_ranges_and_carry_seeds_match_jax(seeded_paf, tmp_path, n):
    rngs = tmh.split_ranges(seeded_paf, n)
    assert rngs == jmh.split_ranges(seeded_paf, n)
    stitched = b""
    for k, (off, end) in enumerate(rngs):
        a, b = str(tmp_path / ("t%d" % k)), str(tmp_path / ("j%d" % k))
        assert tmh.extract_range(seeded_paf, off, end, a) == \
            jmh.extract_range(seeded_paf, off, end, b)
        assert tmh._carry_seed(seeded_paf, off) == \
            jmh._carry_seed(seeded_paf, off)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            data = fa.read()
            assert data == fb.read()
        stitched += data
    with open(seeded_paf, "rb") as f:
        assert stitched == f.read()


def test_loader_carry_seed_matches_jax(tmp_path):
    """A range that starts with 10-field lines: their bl is the carry
    seed's, and the colmat equals the JAX loader's."""
    import torch

    from miniasm_tpu.io.native.pafload import load_hits_mt as j_load
    from miniasm_tpu_torch.io.native.pafload import load_hits_mt as t_load

    def ten_fields(ln):
        return b"\t".join(ln.rstrip(b"\n").split(b"\t")[:10])

    rng = np.random.default_rng(3)
    head = _paf_lines(rng, 200)
    head[-1] = ten_fields(head[-1]) + b"\t6000\t255\n"  # bl = 6000
    ten = [ten_fields(ln) + b"\n" for ln in _paf_lines(rng, 50)]
    paf = str(tmp_path / "c.paf")
    with open(paf, "wb") as f:
        f.writelines(head + ten + _paf_lines(rng, 200))
    off = sum(len(x) for x in head)
    part = str(tmp_path / "part.paf")
    seed = tmh.extract_range(paf, off, os.path.getsize(paf), part)
    assert seed == 6000
    cols = {}
    for s in (seed, None):
        jc, _, jh = j_load(part, 2000, 100, min_iden=0.05, upload=False,
                           carry_seed=s)
        # the host's 7-row pieces (the worker's load) and the format
        # ladder with the plain decode (the main path on the CPU)
        for upload in (False, True):
            tc, _, th = t_load(part, 2000, 100, min_iden=0.05,
                               device=torch.device("cpu"), carry_seed=s,
                               upload=upload)
            n = tc.shape[1]
            assert n == jh.n_orig and np.array_equal(tc.numpy(), jc[:, :n])
            th.free()
        jh.free()
        cols[s] = tc.numpy()
    # the seed decides the identity bit of the leading 10-field lines
    assert not np.array_equal(cols[seed][6], cols[None][6])


@pytest.mark.parametrize("data", ["sim_small", "sim_noisy"])
def test_host_load_parses_seven_rows(request, data, monkeypatch):
    """load_hits_mt(upload=False), the sharded paths' host load: the JAX
    host loader's colmat, from 7-row pieces with nothing to decode or
    unpack (K10's one call per load only copies them, on the host)."""
    import torch

    from miniasm_tpu.io.native.pafload import load_hits_mt as j_load
    from miniasm_tpu_torch.io.native import pafload

    def no_decode(*a):
        raise AssertionError("the host load decoded an FMT3 piece")

    unpack4 = pafload.unpack4

    def copy_only(pieces, *a, **k):
        if any(d.shape[0] != 7 or d.device.type != "cpu"
               for d, _n in pieces):
            raise AssertionError("the host load unpacked a 4-row piece")
        return unpack4(pieces, *a, **k)

    monkeypatch.setattr(pafload, "decode3", no_decode)
    monkeypatch.setattr(pafload, "unpack4", copy_only)
    paf = request.getfixturevalue(data)["paf"]
    tc, td, th = pafload.load_hits_mt(paf, 2000, 100, min_iden=0.05,
                                      device=torch.device("cuda"),
                                      upload=False)
    jc, jd, jh = j_load(paf, 2000, 100, min_iden=0.05, upload=False)
    n = tc.shape[1]
    assert tc.device.type == "cpu" and n == jh.n_orig > 0
    assert np.array_equal(tc.numpy(), jc[:, :n])
    assert list(td.names) == list(jd.names)
    th.free()
    jh.free()


@pytest.fixture(scope="module")
def mh_paf(tmp_path_factory):
    """test_multihost.py's simulation, its .gz copy, and the JAX
    single-process GFA."""
    import io

    from miniasm_tpu import pipeline
    from miniasm_tpu.config import Opt
    from miniasm_tpu.eval.simulate import simulate, write_paf

    d = tmp_path_factory.mktemp("mh")
    paf = str(d / "mh.paf")
    write_paf(simulate(genome_len=150_000, coverage=18.0, seed=23), paf)
    gz = paf + ".gz"
    with open(paf, "rb") as fi, gzip.open(gz, "wb") as fo:
        shutil.copyfileobj(fi, fo)
    out = io.StringIO()
    pipeline.run(paf, Opt(), outfmt="ug", out=out)
    return {"paf": paf, "gz": gz, "golden": out.getvalue()}


def _run_workers(paf, tmp_path, n):
    """n worker processes on the CPU, met at a file:// rendezvous (no TCP
    port to collide on); returns rank 0's GFA."""
    env = dict(os.environ, **{ENV: "cpu"})
    env["PYTHONPATH"] = REPO
    rdv = "file://" + str(tmp_path / "rdv")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "miniasm_tpu_torch.parallel.multihost",
         "--coordinator", rdv, "--num-procs", str(n), "--proc-id", str(k),
         "--out", str(tmp_path / ("p%d.gfa" % k)), paf],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for k in range(n)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            errs.append(err.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, e in zip(procs, errs):
        assert p.returncode == 0, "worker failed:\n%s" % e[-3000:]
    assert "multi-host, %d processes" % n in errs[0]
    with open(tmp_path / "p0.gfa") as f:
        return f.read()


@pytest.mark.parametrize("inp,n", [("paf", 2), ("paf", 3), ("gz", 2)])
def test_worker_matches_jax_pipeline(mh_paf, tmp_path, inp, n):
    got = _run_workers(mh_paf[inp], tmp_path, n)
    assert got == mh_paf["golden"] and got.startswith("S\t")
