"""The port's graft entry points (miniasm_tpu_torch/eval/dryrun.py)
against the JAX package's (__graft_entry__.py): the same example columns,
the forward step's eight arrays bit-equal to jax.jit(fwd) on every one of
the 4,096 columns (tolerance 0), the dry run's input and its printed
line."""

import io
from contextlib import redirect_stderr

import numpy as np
import pytest
from test_torch_cuda import entry_tail_inputs

OUTPUTS = ["good", "u", "v", "l", "ol", "sub_s", "sub_e", "sub_del"]


@pytest.fixture(scope="module")
def fwd_outputs():
    """(JAX outputs, port outputs) of the forward step, as numpy arrays."""
    import jax

    import __graft_entry__ as ge
    from miniasm_tpu_torch.eval import dryrun

    fn, (colmat,) = ge.entry()
    want = [np.asarray(x) for x in jax.jit(fn)(colmat)]
    with redirect_stderr(io.StringIO()):
        fwd, (cm,) = dryrun.entry(device="cpu")
    assert np.array_equal(cm.numpy(), colmat)
    return want, [x.numpy() for x in fwd(cm)]


def test_example_cols_match_jax():
    import __graft_entry__ as ge
    from miniasm_tpu_torch.eval import dryrun

    want, n_want = ge._example_cols()
    with redirect_stderr(io.StringIO()):
        got, n_got = dryrun._example_cols()
    assert got.dtype == np.int32 and got.shape == (10, 4096)
    assert np.array_equal(got, want) and n_got == n_want == 74
    # padded columns follow the valid ones
    assert 0 < int(got[9].sum()) < 4096


@pytest.mark.parametrize("i", range(len(OUTPUTS)), ids=OUTPUTS)
def test_entry_output_matches_jax(fwd_outputs, i):
    want, got = fwd_outputs
    w, g = want[i], got[i]
    if w.dtype == np.uint32:
        # the port holds uint32 as its int32 bit pattern
        assert g.dtype == np.int32
        g = g.view(np.uint32)
    assert g.dtype == w.dtype and g.shape == w.shape
    assert np.array_equal(g, w)
    assert w.shape == ((4096,) if i < 5 else (74,))


def jax_tail(cm, coords, keep, s, e, dl, max_hang, int_frac, min_ovlp):
    """The JAX step's tail as __graft_entry__.py:60-65 writes it, jitted:
    (good, r, u, v, l, ol, sub_del) as numpy."""
    import jax
    import jax.numpy as jnp

    from miniasm_tpu.core.hit2arc import hit2arc

    def tail(colmat, cqs, cqe, cts, cte, keep, sub_s, sub_e, sub_del):
        qid, tid, rev, valid = colmat[0], colmat[3], colmat[8], colmat[9]
        mvalid = valid.astype(bool)
        slen = sub_e.astype(jnp.int32) - sub_s.astype(jnp.int32)
        arcs = hit2arc(qid, cqs, cqe, tid, cts, cte, rev, slen[qid],
                       slen[tid], max_hang, int_frac, min_ovlp)
        good = keep & mvalid & (arcs["r"] >= 0)
        return (good, arcs["r"], arcs["u"], arcs["v"], arcs["l"],
                arcs["ol"], sub_del)

    return [np.asarray(x) for x in jax.jit(tail)(
        cm, *coords, keep, s, e, dl != 0)]


# (seed, n, T, int_frac): the entry's shape at both int_frac values, more
# reads than columns, no column, a wide one
TAIL_CASES = {"entry_shape": (11, 4096, 74, 0.8),
              "relaxed": (12, 4096, 74, 0.5),
              "reads_over_columns": (13, 300, 9000, 0.8),
              "no_column": (14, 0, 40, 0.8),
              "wide": (15, 30000, 20000, 0.8)}


@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_hit2arc_tail_plain_matches_jax(case):
    """K6's plain version, hit2arc_tail on CPU tensors, against the JAX
    step's tail on the same seeded inputs, bit for bit (tolerance 0)."""
    import torch

    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.core import hit2arc as h2a

    seed, n, T, int_frac = TAIL_CASES[case]
    cm, coords, keep, s, e, dl = entry_tail_inputs(
        np.random.default_rng(seed), n, T)
    opt = Opt()
    par = (opt.max_hang, int_frac, opt.min_ovlp)
    want = jax_tail(cm, coords, keep, s, e, dl, *par)
    sub = torch.from_numpy(np.stack([s.view(np.int32), e.view(np.int32),
                                     dl]))
    arcs, good, sub_del = h2a.hit2arc_tail(
        torch.from_numpy(cm), torch.from_numpy(coords.view(np.int32)),
        torch.from_numpy(keep), sub, *par)
    got = [good.numpy(), *arcs.numpy(), sub_del.numpy()]
    assert [x.dtype for x in got] == [x.dtype for x in want]
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)
    assert got[0].shape == (n,) and got[-1].shape == (T,)
    if n:
        # every class of hit2arc and both values of good occur
        assert set(np.clip(want[1], -5, 0)) == {-4, -3, -2, -1, 0}
        assert 0 < want[0].sum() < n


def test_hit2arc_tail_reads_the_columns_by_row_stride():
    """hit2arc_tail takes the entry's columns as a view with a row stride
    wider than n, as it takes the whole matrix."""
    import torch

    from miniasm_tpu_torch.core import hit2arc as h2a

    cm, coords, keep, s, e, dl = entry_tail_inputs(
        np.random.default_rng(16), 500, 60)
    sub = torch.from_numpy(np.stack([s.view(np.int32), e.view(np.int32),
                                     dl]))
    args = (torch.from_numpy(coords.view(np.int32)), torch.from_numpy(keep),
            sub, 1000, 0.8, 2000)
    wide = torch.zeros((10, 700), dtype=torch.int32)
    wide[:, 100:600] = torch.from_numpy(cm)
    view = wide[:, 100:600]
    assert view.stride(0) == 700
    for g, w in zip(h2a.hit2arc_tail(view, *args),
                    h2a.hit2arc_tail(torch.from_numpy(cm), *args)):
        assert torch.equal(g, w)


def test_entry_asks_for_the_card(monkeypatch):
    import torch

    from miniasm_tpu_torch.eval import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with redirect_stderr(io.StringIO()):
            dryrun.entry()


def test_dryrun_paf_matches_jax_input(tmp_path):
    """dryrun_paf writes the input JAX's dryrun_multichip assembles
    (__graft_entry__.py:91-100)."""
    import random

    from miniasm_tpu.eval.simulate import simulate, write_paf
    from miniasm_tpu_torch.eval.dryrun import dryrun_paf

    want = str(tmp_path / "jax.paf")
    sim = simulate(genome_len=5_000_000, coverage=12.0, seed=5)
    write_paf(sim, want)
    rng = random.Random(3)
    with open(want) as f:
        kept = [ln for ln in f if rng.random() > 0.5]
    got = str(tmp_path / "port.paf")
    dryrun_paf(got)
    with open(got) as f:
        assert f.read() == "".join(kept) and kept


def test_dryrun_multichip_line_matches_jax(capfd):
    """dryrun_multichip(2) on two gloo ranks on the CPU prints JAX's line
    (n_devices=2 unitigs=47 gfa_bytes=22448) and returns the GFA it
    counted."""
    import __graft_entry__ as ge
    from miniasm_tpu_torch.eval.dryrun import dryrun_multichip

    def line():
        out = capfd.readouterr().out
        return [ln for ln in out.splitlines()
                if ln.startswith("dryrun_multichip:")]

    ge.dryrun_multichip(2)
    want = line()
    gfa = dryrun_multichip(2, device="cpu")
    got = line()
    assert got == want and len(want) == 1
    assert "unitigs=%d gfa_bytes=%d " % (
        sum(1 for ln in gfa.splitlines() if ln.startswith("S\t")),
        len(gfa)) in got[0]
