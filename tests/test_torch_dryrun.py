"""The port's graft entry points (miniasm_tpu_torch/eval/dryrun.py)
against the JAX package's (__graft_entry__.py): the same example columns,
the forward step's eight arrays bit-equal to jax.jit(fwd) on every one of
the 4,096 columns (tolerance 0), the dry run's input and its printed
line."""

import io
from contextlib import redirect_stderr

import numpy as np
import pytest

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
