"""The port's host tools against the JAX package's: open_text and
read_fastx, minidot (dotter.py) and the interop converters.  The same
inputs go through both modules; outputs must be byte-equal (tolerance 0).
The inputs are the hand-built fixtures of tests/test_interop.py and the
seeded sim_small set of tests/conftest.py."""

import gzip
import io
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from test_interop import MHAP_LINES

DA_DB = "R 1\nH x m54321\nL 7 100 5100\nR 2\nH x m54321\nL 8 0 6000\n"
DA_LA = ("P 1 2 n\nC 100 4000 0 3900\nD 250\n"
         "P 2 1 c\nC 0 3900 100 4000\nD 250\n")
SAM = ("@SQ\tSN:chr1\tLN:10000\n"
       "r1\t0\tchr1\t101\t60\t50S100M2I50M3D100M\t*\t0\t0\t*\t*\tNM:i:8\n"
       "r2\t16\tchr1\t201\t60\t10H200M\t*\t0\t0\t*\t*\tNM:i:4\n"
       "r3\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*\n"
       "r4\t256\tchr1\t301\t60\t20=1X29=\t*\t0\t0\t*\t*\tnn:i:2\n"
       "r5\t0\tchr1\t9990\t60\t100M\t*\t0\t0\t*\t*\n")
WT = ("r1\t+\t5000\t100\t4900\tr2\t+\t6000\t0\t4800\tx\tx\t4700\t50\t30\t20\n"
      "r2\t-\t6000\t-\t5800\tr3\t-\t4000\t10\t-\tx\tx\t3000\t10\t5\t5\n"
      "short\tline\n")
PAFTOP = ("q1\t10000\t0\t4000\t+\tt1\t20000\t0\t4000\t3800\t4000\t60\n"
          "q1\t10000\t4500\t9000\t+\tt1\t20000\t4600\t9100\t4300\t4500\t60\n"
          "q1\t10000\t100\t3900\t+\tt2\t20000\t0\t3800\t1000\t3800\t60\n"
          "q2\t8000\t0\t5000\t-\tt1\t20000\t9000\t14000\t4000\t5000\t60\n"
          "q2\t8000\t5200\t8000\t-\tt1\t20000\t6000\t8800\t2500\t2800\t60\n")


def _jax_and_port(name):
    import importlib

    return (importlib.import_module("miniasm_tpu." + name),
            importlib.import_module("miniasm_tpu_torch." + name))


def _stdin(monkeypatch, data: bytes):
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(
        io.BufferedReader(io.BytesIO(data))))


# -- open_text, read_fastx ---------------------------------------------------

@pytest.mark.parametrize("kind", ["plain", "gz", "stdin", "stdin_gz"])
def test_open_text_matches_jax(kind, sim_small, tmp_path, monkeypatch):
    with open(sim_small["paf"], "rb") as f:
        data = f.read()
    fn = str(tmp_path / "r.paf")
    if kind.endswith("gz"):
        with gzip.open(fn, "wb") as g:
            g.write(data)
    else:
        with open(fn, "wb") as g:
            g.write(data)
    outs = []
    for mod in _jax_and_port("io.paf"):
        if kind.startswith("stdin"):
            with open(fn, "rb") as f:
                _stdin(monkeypatch, f.read())
            src = "-"
        else:
            src = fn
        with mod.open_text(src) as f:
            outs.append(f.read())
    assert outs[0] == outs[1] == data.decode()


FASTX = {
    "fasta": ">r1 desc\nACGT\nGG\n>r2\n>r3\tx\nTTTT\n",
    "fastq": "@q1 x\nACGTAC\n+\nIIIIII\n@q2\nAC\nGT\n+q2\nII\nII\n",
    "gz": ">g1\nAAAA\nCC\n@g2\nTT\n+\n!!\n",
    "blank": "\n>b1\n\nACG\n\n>b2\nTT\n\n\n",
}


@pytest.mark.parametrize("kind", sorted(FASTX))
def test_read_fastx_matches_jax(kind, tmp_path):
    fn = str(tmp_path / ("r.fa.gz" if kind == "gz" else "r.fa"))
    data = FASTX[kind].encode()
    if kind == "gz":
        with gzip.open(fn, "wb") as g:
            g.write(data)
    else:
        with open(fn, "wb") as g:
            g.write(data)
    jx, pt = _jax_and_port("io.fastx")
    want = list(jx.read_fastx(fn))
    assert list(pt.read_fastx(fn)) == want and want


def test_read_fastx_sim_fasta_matches_jax(sim_small):
    jx, pt = _jax_and_port("io.fastx")
    want = list(jx.read_fastx(sim_small["fasta"]))
    assert list(pt.read_fastx(sim_small["fasta"])) == want
    assert len(want) == len(sim_small["sim"]["names"])


# -- minidot -------------------------------------------------------------------

MINIDOT_ARGS = [[], ["-d"], ["-L"], ["-w", "800", "-s", "500"]]


@pytest.mark.parametrize("args", MINIDOT_ARGS, ids=lambda a: " ".join(a)
                         or "default")
def test_minidot_render_matches_jax(sim_small, args):
    """The four flag sets of tests/test_minidot.py, port render against JAX
    render (the kwargs as that test builds them)."""
    kw = {}
    it = iter(args)
    for a in it:
        if a == "-d":
            kw["diagonal"] = False
        elif a == "-L":
            kw["no_label"] = True
        elif a == "-w":
            kw["width"] = int(next(it))
        elif a == "-s":
            kw["min_span"] = int(next(it))
    outs = []
    for mod in _jax_and_port("dotter"):
        buf = io.StringIO()
        assert mod.render(sim_small["paf"], buf, **kw) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0].startswith("%!PS-Adobe")


def _main(mod, argv, stdin=None, monkeypatch=None):
    if stdin is not None:
        _stdin(monkeypatch, stdin.encode())
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = mod.main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [["-m", "200", "-i", "0.5", "-f", "9",
                                   "-t", "1.5"], ["-d", "-L", "-w", "300"]],
                         ids=["numbers", "flags"])
def test_minidot_main_matches_jax(sim_small, argv):
    outs = [_main(m, argv + [sim_small["paf"]])
            for m in _jax_and_port("dotter")]
    assert outs[0] == outs[1] and outs[0][0] == 0 and outs[0][1]


@pytest.mark.parametrize("case", ["no_args", "missing_file", "bad_flag",
                                  "no_hits"])
def test_minidot_main_refusals_match_jax(case, tmp_path):
    empty = tmp_path / "empty.paf"
    empty.write_text("")
    argv = {"no_args": [], "missing_file": [str(tmp_path / "none.paf")],
            "bad_flag": ["-x", str(empty)], "no_hits": [str(empty)]}[case]
    outs = [_main(m, argv) for m in _jax_and_port("dotter")]
    assert outs[0] == outs[1] and outs[0][0] == 1 and outs[0][2]


def test_mixed_numcompare_matches_jax():
    jx, pt = _jax_and_port("dotter")
    names = ["chr1", "chr10", "chr2", "chr02", "read007", "read7", "a", "",
             "b1c20", "b1c3", "x00", "x0", "10", "9", "read000123",
             "read000124"]
    for a in names:
        for b in names:
            assert pt.mixed_numcompare(a, b) == jx.mixed_numcompare(a, b)


# -- interop -------------------------------------------------------------------

def _convert(name, call):
    """call(module) -> output text, for the JAX and the port module."""
    outs = [call(m) for m in _jax_and_port("interop." + name)]
    assert outs[0] == outs[1]
    return outs[0]


def _buf(fn):
    buf = io.StringIO()
    fn(buf)
    return buf.getvalue()


def _head(paf, n=300):
    with open(paf) as f:
        return "".join(f.readlines()[:n])


@pytest.mark.parametrize("kw", [{}, {"double": True}, {"min_blen": 3000}],
                         ids=["plain", "double", "min_blen"])
def test_mhap2paf_matches_jax(kw):
    out = _convert("mhap2paf", lambda m: _buf(
        lambda b: m.convert(io.StringIO(MHAP_LINES), b, **kw)))
    assert out


def test_mhap2paf_names_roundtrip_matches_jax(sim_small, tmp_path):
    """paf2mhap of the simulated PAF, back through mhap2paf -f with the
    read-name list."""
    mhap = _convert("paf2mhap", lambda m: _buf(
        lambda b: m.convert(sim_small["fasta"],
                            io.StringIO(_head(sim_small["paf"])), b)))
    names = tmp_path / "names.txt"
    names.write_text("".join(n + "\n" for n in sim_small["sim"]["names"]))
    out = _convert("mhap2paf", lambda m: _buf(
        lambda b: m.convert(io.StringIO(mhap), b, name_list=str(names))))
    assert out.count("\n") == mhap.count("\n") > 0


@pytest.mark.parametrize("pct", [False, True])
def test_paf2mhap_matches_jax(sim_small, pct):
    out = _convert("paf2mhap", lambda m: _buf(
        lambda b: m.convert(sim_small["fasta"], io.StringIO(
            _head(sim_small["paf"])), b, pct=pct)))
    assert out


@pytest.mark.parametrize("kw", [{}, {"double": True, "with_name": True}],
                         ids=["plain", "double_names"])
def test_da2paf_matches_jax(kw):
    out = _convert("da2paf", lambda m: _buf(
        lambda b: m.convert(io.StringIO(DA_DB), io.StringIO(DA_LA), b,
                            **kw)))
    assert out


@pytest.mark.parametrize("pri_only", [False, True])
def test_sam2paf_matches_jax(pri_only):
    outs = []
    for m in _jax_and_port("interop.sam2paf"):
        err = io.StringIO()
        with redirect_stderr(err):
            outs.append((_buf(lambda b: m.convert(io.StringIO(SAM), b,
                                                  pri_only=pri_only)),
                         err.getvalue()))
    assert outs[0] == outs[1] and outs[0][0] and outs[0][1]


def test_wt2paf_matches_jax():
    assert _convert("wt2paf", lambda m: _buf(
        lambda b: m.convert(io.StringIO(WT), b)))


@pytest.mark.parametrize("data", ["fixture", "sim_small"])
@pytest.mark.parametrize("kw", [{}, {"mask_level": 0.2, "max_gap": 5000}],
                         ids=["default", "options"])
def test_paftop_matches_jax(data, kw, sim_small):
    # paftop reads column 12 as the mapping quality: the simulated lines
    # carry 60 there in place of their cm:i: tag
    text = PAFTOP if data == "fixture" else "".join(
        "\t".join(ln.split("\t")[:11] + ["60"]) + "\n"
        for ln in _head(sim_small["paf"], 2000).splitlines())
    assert _convert("paftop", lambda m: _buf(
        lambda b: m.run(io.StringIO(text), b, **kw)))


MAINS = {
    "mhap2paf": (["-2", "-l", "100", "{mhap}"], None),
    "paf2mhap": (["-p", "{fasta}", "{paf}"], None),
    "da2paf": (["-2n", "{db}", "{la}"], None),
    "sam2paf": (["-p", "{sam}"], None),
    "wt2paf": (["{wt}"], None),
    "paftop": (["-m", "0.3", "-g", "2000"], "{paf_text}"),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_interop_main_matches_jax(name, sim_small, tmp_path, monkeypatch):
    files = {"mhap": MHAP_LINES, "db": DA_DB, "la": DA_LA, "sam": SAM,
             "wt": WT}
    paths = {k: str(tmp_path / k) for k in files}
    for k, v in files.items():
        with open(paths[k], "w") as f:
            f.write(v)
    short = tmp_path / "short.paf"
    short.write_text(_head(sim_small["paf"]))
    subst = dict(paths, fasta=sim_small["fasta"], paf=str(short),
                 paf_text=PAFTOP)
    argv, stdin = MAINS[name]
    argv = [a.format(**subst) for a in argv]
    outs = [_main(m, argv, stdin and stdin.format(**subst), monkeypatch)
            for m in _jax_and_port("interop." + name)]
    assert outs[0] == outs[1] and outs[0][0] == 0 and outs[0][1]
