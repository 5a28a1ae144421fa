"""The port's eval tools against the JAX package's: paf_srtcmp, order_eval,
ovsen, testsen, ref2ovlp (byte-equal output on the fixtures of
tests/test_interop.py and tests/test_panel.py and on the seeded sim_small
set), the panel's helpers and run_one on tests/test_panel.py's QUICK
members (the port on the CPU against the JAX pipeline), and the scaling
harness's measure over gloo on the CPU."""

import importlib
import io
from contextlib import redirect_stderr, redirect_stdout

import pytest

TRUTH = ("q1\t100\t0\t100\t+\tt1\t500\t10\t110\t90\t100\t60\n"
         "q2\t100\t0\t100\t+\tt2\t500\t10\t110\t90\t100\t60\n"
         "q3\t100\t0\t50\t+\tt1\t500\t10\t60\t40\t50\t60\n"
         "q3\t100\t50\t100\t+\tt1\t500\t60\t110\t40\t50\t60\n"
         "q4\t100\t0\t100\t-\tt3\t500\t10\t110\t90\t100\t60\n"
         "q5\t100\t0\t100\t+\tt1\t500\t10\t110\t90\t100\t60\n")
TEST = ("q1\t100\t0\t100\t+\tt1\t500\t15\t115\t90\t100\t60\n"
        "q2\t100\t0\t100\t+\tt9\t500\t10\t110\t90\t100\t60\n"
        "q4\t100\t0\t100\t-\tt3\t500\t400\t490\t80\t90\t60\n")
REF_PAF = ("r1\t9000\t0\t9000\t+\tchr\t100000\t0\t9000\t8000\t9000\t60\n"
           "r2\t9000\t0\t9000\t+\tchr\t100000\t5000\t14000\t8000\t9000\t60\n"
           "r3\t9000\t0\t9000\t+\tchr\t100000\t50000\t59000\t8000\t9000\t60\n"
           "r4\t9000\t0\t9000\t+\tchr\t100000\t52000\t61000\t8000\t9000\t5\n")
OVLP_PAF = "r1\t9000\t5000\t9000\t+\tr2\t9000\t0\t4000\t3900\t4000\n"
PAIRS = "r1\tr2\nr1\tr3\nr2\tr4\n"


def _mods(name):
    return (importlib.import_module("miniasm_tpu.eval." + name),
            importlib.import_module("miniasm_tpu_torch.eval." + name))


def _both(name, call):
    """call(module) for the JAX and the port module; both results equal."""
    outs = [call(m) for m in _mods(name)]
    assert outs[0] == outs[1]
    return outs[0]


def _run(fn, *args, **kw):
    buf = io.StringIO()
    ret = fn(*args, buf, **kw)
    return ret, buf.getvalue()


@pytest.fixture(scope="module")
def sim_files(sim_small, tmp_path_factory):
    """Inputs of the eval tools made from sim_small: the truth mapping
    (name-sorted and target-sorted), the overlap PAF, a panel GFA's
    a-lines as BED, and the true pairs of ref2ovlp."""
    from miniasm_tpu_torch.eval.panel import alines_to_bed, truth_paf
    from miniasm_tpu_torch.eval.ref2ovlp import run as ref2ovlp
    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.pipeline import run

    d = tmp_path_factory.mktemp("eval")
    sim = sim_small["sim"]
    truth = truth_paf(sim)
    rows = truth.splitlines(True)
    by_pos = sorted(rows, key=lambda r: int(r.split("\t")[7]))
    gfa = io.StringIO()
    with redirect_stderr(io.StringIO()):
        run(sim_small["paf"], Opt(), out=gfa, device="cpu")
    pairs = io.StringIO()
    ref2ovlp(io.StringIO("".join(by_pos)), pairs)
    files = {"truth": "".join(sorted(rows)), "truth_pos": "".join(by_pos),
             "bed": alines_to_bed(gfa.getvalue()), "pairs": pairs.getvalue(),
             # name-sorted overlaps, 12 numeric columns (mapq 60 in place
             # of the cm:i: tag), as paf_srtcmp reads a mapper's PAF
             "test": "".join(sorted(
                 "\t".join(ln.split("\t")[:11] + ["60"]) + "\n"
                 for ln in open(sim_small["paf"]).read().splitlines()))}
    out = {}
    for k, v in files.items():
        out[k] = str(d / k)
        with open(out[k], "w") as f:
            f.write(v)
    out["paf"] = sim_small["paf"]
    return out


@pytest.mark.parametrize("data", ["fixture", "sim_small"])
def test_paf_srtcmp_matches_jax(data, sim_files, tmp_path):
    if data == "fixture":
        a, b = tmp_path / "truth.paf", tmp_path / "test.paf"
        a.write_text(TRUTH)
        b.write_text(TEST)
        a, b = str(a), str(b)
    else:
        a, b = sim_files["truth"], sim_files["test"]
    (tot, matched), out = _both("paf_srtcmp", lambda m: _run(m.srtcmp, a, b))
    assert tot > 0 and out


@pytest.mark.parametrize("kw", [{}, {"ws": 3, "min_span": 5000}],
                         ids=["default", "options"])
def test_order_eval_matches_jax(kw, sim_files):
    cnt, out = _both("order_eval", lambda m: _run(
        m.run, sim_files["bed"], sim_files["truth"], **kw))
    assert out.endswith("C %d\n" % cnt)


@pytest.mark.parametrize("data", ["fixture", "sim_small"])
def test_ovsen_matches_jax(data, sim_files, tmp_path):
    if data == "fixture":
        a, b = tmp_path / "ref.paf", tmp_path / "ov.paf"
        a.write_text(REF_PAF)
        b.write_text(OVLP_PAF)
        a, b = str(a), str(b)
    else:
        a, b = sim_files["truth_pos"], sim_files["paf"]
    (n_ovlp, _), out = _both("ovsen", lambda m: _run(m.run, a, b))
    assert n_ovlp > 0


@pytest.mark.parametrize("data", ["fixture", "sim_small"])
def test_testsen_matches_jax(data, sim_files, tmp_path):
    if data == "fixture":
        pairs = tmp_path / "pairs.txt"
        pairs.write_text(PAIRS)
        pairs, paf = str(pairs), OVLP_PAF
    else:
        pairs = sim_files["pairs"]
        paf = open(sim_files["paf"]).read()
    cnt, out = _both("testsen", lambda m: _run(
        m.run, pairs, io.StringIO(paf)))
    assert sum(cnt) > 0


@pytest.mark.parametrize("data", ["fixture", "sim_small"])
def test_ref2ovlp_matches_jax(data, sim_files):
    text = REF_PAF if data == "fixture" else open(
        sim_files["truth_pos"]).read()
    _, out = _both("ref2ovlp", lambda m: _run(m.run, io.StringIO(text)))
    assert out


MAINS = {
    "paf_srtcmp": lambda f: ["paf_srtcmp", f["truth"], f["test"]],
    "order_eval": lambda f: ["-w", "4", f["bed"], f["truth"]],
    "ovsen": lambda f: ["-l", "1000", "-q", "5", f["truth_pos"], f["paf"]],
    "testsen": lambda f: [f["pairs"], f["paf"]],
    "ref2ovlp": lambda f: [f["truth_pos"]],
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_eval_main_matches_jax(name, sim_files):
    argv = MAINS[name](sim_files)

    def call(m):
        out, err = io.StringIO(), io.StringIO()
        with redirect_stdout(out), redirect_stderr(err):
            rc = m.main(argv)
        return rc, out.getvalue(), err.getvalue()

    rc, out, _ = _both(name, call)
    assert rc == 0 and out


@pytest.mark.parametrize("name", ["paf_srtcmp", "order_eval", "ovsen",
                                  "testsen"])
def test_eval_main_usage_matches_jax(name):
    argv = ["paf_srtcmp"] if name == "paf_srtcmp" else []

    def call(m):
        out, err = io.StringIO(), io.StringIO()
        with redirect_stdout(out), redirect_stderr(err):
            rc = m.main(argv)
        return rc, out.getvalue(), err.getvalue().replace(
            "miniasm_tpu_torch.", "miniasm_tpu.")

    rc, out, err = _both(name, call)
    assert rc == 1 and out == "" and err.startswith("Usage")


# -- the panel -----------------------------------------------------------------

def test_panel_table_and_helpers_match_jax(sim_files):
    jx, pt = _mods("panel")
    assert pt.PANEL == jx.PANEL and len(pt.PANEL) == 11
    gfa = ("S\tutg000001l\t*\tLN:i:100\nS\tutg000002l\tACGT\n"
           "a\tutg000001l\t0\tread000001:1-50\t+\t25\n"
           "a\tutg000001l\t25\tread000002:5-60\t-\t30\n")
    assert pt.alines_to_bed(gfa) == jx.alines_to_bed(gfa)
    assert pt._utg_stats(gfa) == jx._utg_stats(gfa) == (2, 100)
    assert pt._utg_stats("") == jx._utg_stats("")


def test_panel_truth_paf_matches_jax(sim_small):
    jx, pt = _mods("panel")
    assert pt.truth_paf(sim_small["sim"]) == jx.truth_paf(sim_small["sim"])


QUICK = [0, 3, 7]  # tests/test_panel.py:15


@pytest.mark.parametrize("i", QUICK, ids=lambda i: "panel%d" % i)
def test_panel_run_one_matches_jax(i):
    """The port's run_one on the CPU against the JAX run_one: the same
    dict, and tests/test_panel.py's assertions."""
    jx, pt = _mods("panel")
    cfg = pt.PANEL[i]
    with redirect_stderr(io.StringIO()):
        want = jx.run_one(*cfg)
        got = pt.run_one(*cfg, device="cpu")
    assert got == want
    assert got["unitigs"] == 1 and got["layout_errors"] == 0
    assert got["reads_in_layout"] > 20


def test_panel_ref_binary_needs_sources(monkeypatch):
    from miniasm_tpu_torch.eval.panel import _ref_binary

    monkeypatch.delenv("MINIASM_REF_SRC", raising=False)
    assert _ref_binary() is None


# -- scaling -------------------------------------------------------------------

def test_scaling_measure_matches_jax_keys(sim_small):
    """measure at 1 and 2 ranks over gloo on the CPU: JAX's keys and
    statistics, the same overlap count as the JAX harness, and every run's
    GFA the single run's bytes (measure asserts it)."""
    import numpy as np

    from miniasm_tpu.config import Opt as JOpt
    from miniasm_tpu.io.paf import load_paf as jload
    from miniasm_tpu_torch.eval.scaling import measure

    r = measure(sim_small["paf"], [1, 2], repeats=1, device="cpu")
    keys = {"overlaps", "sharded_self_efficiency",
            "sharded_structure_cost_vs_fused_single", "overlaps_per_s",
            "efficiency_timesliced", "projected_efficiency",
            "paired_projected_efficiency", "note"}
    assert set(r) == keys
    o = JOpt()
    ld = jload(sim_small["paf"], o.min_span, o.min_match)
    assert r["overlaps"] == len(ld.qid) + int(np.sum(ld.qid != ld.tid)) > 0
    assert set(r["overlaps_per_s"]) == {"1", "2"}
    assert set(r["sharded_self_efficiency"]) == {"2"}
    assert set(r["paired_projected_efficiency"]) == {"1", "2"}
    assert r["sharded_structure_cost_vs_fused_single"] > 0
    assert "gloo" in r["note"] and "protocol" in r["note"]
