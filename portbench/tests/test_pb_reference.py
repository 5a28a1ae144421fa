"""The plain reference against the program's CPU run: the same bytes on
small inputs of both mixes' recalls (minimap's 0.93, MHAP's 0.78) and of
every overlap and half of them, on circular and linear genomes, for
-p ug (the cells' output) and -p paf; and its radix order against the
program's exact sort."""

import contextlib
import io
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from portbench.gen import inputs  # noqa: E402
from portbench.ref.miniasm_ref import assemble  # noqa: E402
from portbench.ref.radix import radix_argsort  # noqa: E402


def program(paf, argv, monkeypatch):
    from miniasm_tpu_torch import cli

    monkeypatch.setenv("MINIASM_TPU_TORCH_DEVICE", "cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(list(argv) + [paf]) == 0
    return out.getvalue().encode("latin-1")


CASES = [(21, False, 0.93), (22, True, 0.93), (23, False, 0.78),
         (24, True, 0.78), (2**31 + 25, True, 0.78), (26, True, 1.0),
         (27, False, 0.5)]


@pytest.mark.parametrize("seed,circular,recall", CASES)
def test_reference_is_the_programs_ug(tmp_path, monkeypatch, seed, circular,
                                      recall):
    cfg = {"genome_len": 250_000, "coverage": 30.0, "circular": circular,
           "layout_seed": seed}
    paf, _ = inputs.make_paf(cfg, {"recall": recall, "argv": []}, seed,
                             str(tmp_path))
    want = program(paf, ["-p", "ug"], monkeypatch)
    assert want.count(b"\nS\t") + want.startswith(b"S\t") >= 1
    assert assemble(paf, ["-p", "ug"]) == want


@pytest.mark.parametrize("seed", [31, 32])
def test_reference_is_the_programs_paf(tmp_path, monkeypatch, seed):
    """-p paf prints the hits in miniasm's radix order of the hit key:
    its ties reach the output."""
    cfg = {"genome_len": 150_000, "coverage": 30.0, "circular": True,
           "layout_seed": seed}
    paf, _ = inputs.make_paf(cfg, {"recall": 0.78, "argv": []}, seed,
                             str(tmp_path))
    assert assemble(paf, ["-p", "paf"]) == program(paf, ["-p", "paf"],
                                                   monkeypatch)


def test_mhap_mix_fires_the_cleaning_passes(tmp_path):
    """MHAP's recall leaves tips, bubbles and weak arcs: after the
    transitive reduction the reference cuts tips and pops bubbles, and
    the whole clean drops more arcs than the reduction does."""
    from portbench.ref import miniasm_ref as M

    cfg = {"genome_len": 400_000, "coverage": 30.0, "circular": False,
           "layout_seed": 23}
    paf, _ = inputs.make_paf(cfg, {"recall": 0.78, "argv": []}, 23,
                             str(tmp_path))
    opt, _, _ = M.parse_argv([paf])
    rec = M.read_paf(paf, opt.min_span, opt.min_match)
    h, sub = M.select(rec, opt, len(rec["names"]))
    h, sub, names = M.hit_contained(h, sub, opt, rec["names"])
    g = M.sg_gen(h, sub, opt)
    M.del_trans(g, opt.gap_fuzz)
    n_arc = len(g.u)
    assert M.cut_tip(g, opt.max_ext) > 0
    assert M.pop_bubble(g, opt.bub_dist) > 0
    g = M.sg_gen(h, sub, opt)
    M.clean(g, opt)
    assert len(g.u) < n_arc


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_radix_order_is_miniasms(seed):
    from miniasm_tpu_torch.utils.exact_sort import radix_argsort as native

    rng = np.random.default_rng(seed)
    for _ in range(10):
        n = int(rng.integers(1, 6000))
        k = (rng.integers(0, int(rng.integers(1, 1 << 20)), n).astype(
            np.uint64) << np.uint64(int(rng.integers(0, 40)))) | \
            rng.integers(0, 4, n).astype(np.uint64)
        assert (radix_argsort(k) == native(k)).all()
