"""The port's v2 loader (MINIASM_TPU_LOADER=v2: pafread.cpp
ma_paf_load_hits3, miniasm_tpu_torch/io/native/pafload.py load_hits_v2)
against the JAX package's: the colmat bit-equal to JAX load_hits_v2's
unpadded columns and to the port's load_hits_mt colmat, and the exact
ranks equal on every arc index after the index is mapped across the two
widths (JAX numbers the mirrors from its padded cap, the port from
n_orig).  Then the CLI under v2 against the JAX CLI under v2, -p
ug|sg|bed|paf with and without -b, and on an input whose graph keys and
hit keys collide, so that the exact-rank fallback orders the arcs.
Tolerance 0: arrays bit-equal, stdout byte-equal."""

import random

import numpy as np
import pytest
import torch

from conftest import run_ours
from miniasm_tpu.io.native import pafload as J
from miniasm_tpu_torch import pipeline
from miniasm_tpu_torch.io.native import pafload as T
from miniasm_tpu_torch.io.seqdict import SeqDict
from miniasm_tpu_torch.utils import timers
from test_torch_cli import run_port
from test_torch_loader import _write, ladder_input

CPU = torch.device("cpu")
EDGE = ["a\t9000\t0\t5000\t+\tb\t9000\t4000\t9000\t5000\t5000\tcm:i:5",
        "bad\tline",
        "c\t9000\t0\t4000\t-\td\t9000\t0\t4000\t4000",
        "e\t9000\t0\t100\t+\tf\t9000\t0\t100\t100\t100"]


def v2_input(case, tmp_path, sim_small, sim_noisy):
    """(PAF path, exclusion names) of a case: the fixtures, and the edge
    PAFs of tests/test_native_io.py:123-304 (bl carry, exclusion, a
    17-bit record mid-stream, a wrapped qs > qe record, an ungrouped
    stream)."""
    if case == "sim_small":
        return sim_small["paf"], ()
    if case == "sim_noisy":
        return sim_noisy["paf"], ()
    if case == "edge":
        return _write(tmp_path / "edge.paf", EDGE), ()
    if case == "edge_excl":
        return _write(tmp_path / "edge.paf", EDGE), ("a",)
    if case == "empty":
        return _write(tmp_path / "empty.paf", []), ()
    return ladder_input(case, tmp_path, sim_small)[0], ()


CASES = ["sim_small", "sim_noisy", "edge", "edge_excl", "empty",
         "rle_overflow", "wrapped", "late_pack", "multi_piece"]


@pytest.mark.parametrize("case", CASES)
def test_load_hits_v2_matches_jax(case, tmp_path, sim_small, sim_noisy):
    paf, names = v2_input(case, tmp_path, sim_small, sim_noisy)
    excl = jexcl = None
    if names:
        from miniasm_tpu.io.seqdict import SeqDict as JSeqDict

        excl, jexcl = SeqDict(), JSeqDict()
        for nm in names:
            excl.put(nm, 1)
            jexcl.put(nm, 1)
    jcol, jd, jh = J.load_hits_v2(paf, 2000, 100, excl=jexcl, upload=False)
    tcol, td, th = T.load_hits_v2(paf, 2000, 100, excl=excl, device=CPU)
    mcol, md, mh = T.load_hits_mt(paf, 2000, 100, excl=excl, device=CPU)
    n = th.n_orig
    assert (n, th.n_mirror, th.n_lines, th.max_len) == \
        (jh.n_orig, jh.n_mirror, jh.n_lines, jh.max_len)
    assert (n, th.n_mirror, th.n_lines) == \
        (mh.n_orig, mh.n_mirror, mh.n_lines)
    assert tcol.shape == (7, n) and tcol.dtype == torch.int32
    assert np.array_equal(tcol.numpy(), np.asarray(jcol)[:, :n])
    assert np.array_equal(tcol.numpy(), mcol.numpy())
    assert td.names == jd.names == md.names
    assert td.lens == jd.lens == md.lens
    if case == "edge":
        assert n == 2 and (tcol[6, 1] & 4)  # the carried bl: iden_ok
    # the host view is the uploaded colmat, before free
    hcol, _, hh = T.load_hits_v2(paf, 2000, 100, excl=excl, upload=False)
    assert np.array_equal(hcol, tcol.numpy())
    hh.free()
    tidx = np.concatenate([np.arange(n), n + np.arange(n)])
    jidx = np.concatenate([np.arange(n), jh.cap + np.arange(n)])
    midx = np.concatenate([np.arange(n), mh.cap + np.arange(n)])
    ranks = th.arc_ranks(tidx)
    assert np.array_equal(ranks, jh.arc_ranks(jidx))
    assert np.array_equal(ranks, mh.arc_ranks(midx))
    for h in (jh, th, mh):
        h.free()


FMTS = ["ug", "sg", "bed", "paf"]


@pytest.mark.parametrize("bidir", [False, True], ids=["", "b"])
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("data", ["sim_small", "sim_noisy"])
def test_v2_cli_matches_jax(request, monkeypatch, data, fmt, bidir):
    """-p paf goes down the staged path under v2, as in the JAX package.
    With -b the simulator's one-direction PAF can assemble to nothing."""
    args = (["-b"] if bidir else []) + ["-p", fmt,
                                        request.getfixturevalue(data)["paf"]]
    monkeypatch.setenv("MINIASM_TPU_LOADER", "v2")
    want = run_ours(args)
    rc, got, _ = run_port(args)
    assert rc == 0 and got == want and (got or bidir)
    assert ("select" in pipeline.LAST_TIMING) == (fmt == "paf")


@pytest.fixture(scope="module")
def dup_key_paf(tmp_path_factory):
    """tests/test_parity.py:169-190's input: 800 kb at 30x, seed 13, 30%
    of the lines dropped by random.Random(13); two surviving arcs share a
    graph key and two a hit key, so the main path takes the exact-rank
    fallback."""
    from miniasm_tpu_torch.eval.simulate import simulate, write_paf

    paf = str(tmp_path_factory.mktemp("dup") / "dup.paf")
    write_paf(simulate(genome_len=800_000, coverage=30.0, seed=13), paf)
    rng = random.Random(13)
    kept = [ln for ln in open(paf) if rng.random() > 0.3]
    with open(paf, "w") as f:
        f.writelines(kept)
    return paf


@pytest.mark.parametrize("loader", ["v2", "mt"])
def test_rank_fallback_matches_jax(monkeypatch, dup_key_paf, loader):
    if loader == "v2":
        monkeypatch.setenv("MINIASM_TPU_LOADER", "v2")
    args = ["-p", "sg", dup_key_paf]
    want = run_ours(args)
    rc, got, _ = run_port(args)
    assert rc == 0 and got == want and got
    assert timers.EXTRA.get("rank.fallback") == 1
