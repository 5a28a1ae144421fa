"""The port's stage-boundary snapshot (miniasm_tpu_torch/io/snapshot.py,
MINIASM_TPU_SNAPSHOT) as tests/test_snapshot.py holds the JAX package's:
a restored run prints the live run's bytes at every stage, and a changed
input or option misses.  The format is shared: a snapshot written by
either package restores in the other to the same bytes."""

import contextlib
import dataclasses
import io

import pytest

from conftest import run_ours
from test_torch_cli import run_port
from miniasm_tpu.config import Opt as JOpt
from miniasm_tpu.io import snapshot as jsnap
from miniasm_tpu_torch.config import Opt
from miniasm_tpu_torch.io import snapshot as tsnap
from miniasm_tpu_torch.pipeline import run

RESTORED = "Steps 1-3 restored from snapshot"


def _gfa(paf, snapshot_dir=None, stage=100, outfmt="ug", opt=None):
    buf = io.StringIO()
    run(paf, opt or Opt(), outfmt=outfmt, out=buf, stage=stage,
        snapshot_dir=snapshot_dir, device="cpu")
    return buf.getvalue()


def test_opt_fields_equal_across_packages():
    """The option record a snapshot is keyed by is the same dict in both
    packages, for the defaults and for options the CLI sets."""
    assert tsnap._opt_fields(Opt()) == jsnap._opt_fields(JOpt())
    kw = dict(min_span=1500, min_iden=0.1, int_frac=0.7, n_rounds=4,
              max_ovlp_drop_ratio=0.6)
    assert (tsnap._opt_fields(Opt(**kw))
            == jsnap._opt_fields(dataclasses.replace(JOpt(), **kw)))


def test_snapshot_roundtrip_byte_identical(sim_small, tmp_path):
    snap = str(tmp_path / "snap")
    golden = _gfa(sim_small["paf"])
    assert _gfa(sim_small["paf"], snapshot_dir=snap) == golden
    assert tsnap.load_graph_state(snap, sim_small["paf"], Opt()) is not None
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        second = _gfa(sim_small["paf"], snapshot_dir=snap)
    assert RESTORED in err.getvalue() and second == golden


@pytest.mark.parametrize("stage", [6, 7, 9, 100])
def test_snapshot_restores_for_stage_gating(sim_noisy, tmp_path, stage):
    snap = str(tmp_path / "snap")
    _gfa(sim_noisy["paf"], snapshot_dir=snap)
    for fmt in ("ug", "sg"):
        want = _gfa(sim_noisy["paf"], stage=stage, outfmt=fmt)
        got = _gfa(sim_noisy["paf"], snapshot_dir=snap, stage=stage,
                   outfmt=fmt)
        assert got == want, "stage %d -p %s diverged" % (stage, fmt)


def test_snapshot_invalidated_by_changed_input_or_opts(sim_small,
                                                       tmp_path):
    paf = str(tmp_path / "s.paf")
    with open(sim_small["paf"]) as f, open(paf, "w") as g:
        g.write(f.read())
    snap = str(tmp_path / "snap")
    _gfa(paf, snapshot_dir=snap)
    assert tsnap.load_graph_state(snap, paf, Opt()) is not None
    assert tsnap.load_graph_state(snap, paf, Opt(min_span=1999)) is None
    assert tsnap.load_graph_state(snap, paf, Opt(), bi_dir=False) is None
    with open(paf, "a") as f:
        f.write("x\t10\t0\t9\t+\ty\t10\t0\t9\t5\t9\n")
    assert tsnap.load_graph_state(snap, paf, Opt()) is None


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_restores_across_packages(sim_noisy, tmp_path,
                                           monkeypatch, writer):
    """A snapshot written by one package restores in the other (its
    stderr says so) to the bytes of a run without a snapshot, for -p ug,
    sg and bed; -R neither restores nor saves."""
    paf = sim_noisy["paf"]
    snap = str(tmp_path / "snap")
    monkeypatch.setenv("MINIASM_TPU_SNAPSHOT", snap)
    (run_ours if writer == "jax" else run_port)(["-p", "ug", paf])
    for fmt in ("ug", "sg", "bed"):
        args = ["-p", fmt, paf]
        if writer == "jax":
            rc, got, err = run_port(args)
            assert rc == 0 and RESTORED in err
        else:
            got = run_ours(args)
        monkeypatch.delenv("MINIASM_TPU_SNAPSHOT")
        assert got == run_ours(args), fmt
        monkeypatch.setenv("MINIASM_TPU_SNAPSHOT", snap)
    rc, got, err = run_port(["-R", "-p", "ug", paf])
    assert rc == 0 and RESTORED not in err
