"""The port's staged selection path (-1, -2, -S below 5) through its
command line, against the JAX package's CLI on the same PAF: stdout must
be byte-identical for every flag set, on both fixtures."""

import pytest

from conftest import run_ours
from test_torch_cli import run_port

FLAGS = [
    ["-1"], ["-2"], ["-1", "-2"], ["-S", "1"], ["-S", "2"], ["-S", "3"],
    ["-S", "4"], ["-1", "-p", "sg"], ["-2", "-p", "bed"],
    ["-S", "3", "-p", "bed"], ["-1", "-p", "paf"], ["-2", "-p", "paf"],
    ["-1", "-2", "-p", "bed"], ["-b", "-1"], ["-b", "-1", "-p", "paf"],
]


@pytest.mark.parametrize("args", FLAGS, ids=lambda a: "".join(a))
@pytest.mark.parametrize("data", ["sim_small", "sim_noisy"])
def test_staged_cli_matches_jax(request, data, args):
    paf = request.getfixturevalue(data)["paf"]
    if "-p" not in args:
        args = args + ["-p", "ug"]
    want = run_ours(args + [paf])
    rc, got, err = run_port(args + [paf])
    assert rc == 0
    assert got == want
    if args[:3] == ["-1", "-2", "-p"] and args[3] in ("bed", "paf"):
        # no selection pass ran: a warning and nothing on stdout
        assert got == "" and "no selection pass ran" in err
    elif args[0] != "-b":
        assert got
