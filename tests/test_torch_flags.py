"""The port's -f (unitig sequences, io/native/fastx.cpp ma_ug_seq_native)
and -R (contained-read prefilter, ma_no_cont) against the JAX package on
the main path and on the staged path: stdout byte-identical.  Also: the
port's simulator writes the JAX package's PAF and FASTA bytes, and a
missing reads file fails the run."""

import numpy as np
import pytest

from conftest import run_ours
from test_torch_cli import run_port

MAIN = [["-f", "FA"], ["-R"], ["-R", "-f", "FA"], ["-R", "-p", "sg"],
        ["-R", "-p", "bed"]]
STAGED = [["-1", "-f", "FA"], ["-1", "-R", "-f", "FA"],
          ["-1", "-2", "-f", "FA"], ["-2", "-R", "-p", "sg"],
          ["-1", "-R", "-p", "paf"], ["-S", "4", "-R", "-p", "bed"]]


def _args(flags, fixture):
    return [fixture["fasta"] if a == "FA" else a for a in flags] \
        + [fixture["paf"]]


@pytest.mark.parametrize("flags", MAIN + STAGED,
                         ids=lambda f: "".join(f).replace("FA", ""))
@pytest.mark.parametrize("data", ["sim_small", "sim_noisy"])
def test_flags_stdout_matches_jax(request, data, flags):
    args = _args(flags, request.getfixturevalue(data))
    want = run_ours(args)
    rc, got, _ = run_port(args)
    assert rc == 0 and got == want and got
    if "-f" in flags:
        s = [x.split("\t") for x in got.splitlines() if x.startswith("S\t")]
        assert s and all(len(x[2]) == int(x[3][5:]) and x[2] != "*"
                         for x in s)


def test_missing_reads_file_fails(sim_small, tmp_path):
    rc, out, err = run_port(["-f", str(tmp_path / "absent.fa"),
                             sim_small["paf"]])
    assert rc == 1 and out == "" and "absent.fa" in err


def test_simulator_matches_jax(tmp_path):
    """The genome is drawn after every other draw: the PAF is the one the
    port wrote before it had a genome, and both files equal the JAX
    package's."""
    from miniasm_tpu.eval import simulate as jsim
    from miniasm_tpu_torch.eval import simulate as tsim

    kw = dict(genome_len=60_000, coverage=10.0, seed=3)
    js, ts = jsim.simulate(**kw), tsim.simulate(**kw)
    assert ts["genome"] == js["genome"]
    for k in ("gs", "ge", "ori", "lens", "order"):
        assert np.array_equal(ts[k], js[k])
    files = {}
    for tag, mod, sim in (("jax", jsim, js), ("port", tsim, ts)):
        paf, fa = tmp_path / (tag + ".paf"), tmp_path / (tag + ".fa")
        mod.write_paf(sim, str(paf))
        mod.write_fasta(sim, str(fa))
        files[tag] = (paf.read_bytes(), fa.read_bytes())
    assert files["port"] == files["jax"]
    del ts["genome"]  # the PAF side never reads the genome
    tsim.write_paf(ts, str(tmp_path / "nogenome.paf"))
    assert (tmp_path / "nogenome.paf").read_bytes() == files["jax"][0]
