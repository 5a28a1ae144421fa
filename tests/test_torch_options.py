"""Every numeric option, the -p combinations, the -S / -1 -2 -b sets and
the refusals of the port's CLI against the JAX CLI, on the conftest data
(the flag sets a scratch run found equal before any test held them):
stdout byte-equal and the same exit code."""

import io
from contextlib import redirect_stderr, redirect_stdout

import pytest

from test_torch_cli import run_port

FLAG_SETS = [
    ["-m", "200"], ["-i", "0.2"], ["-s", "3000"], ["-c", "3"], ["-c", "0"],
    ["-o", "2000"], ["-h", "500"], ["-I", "0.5"], ["-g", "500"],
    ["-d", "20000"], ["-e", "2"], ["-n", "2"], ["-r", "0.5,0.8"],
    ["-r", "0.9"], ["-F", "0.95"],
    ["-m", "200", "-p", "paf"], ["-h", "200", "-p", "bed"],
    ["-o", "500", "-p", "sg"],
    ["-S", "0"], ["-S", "3", "-p", "sg"], ["-S", "2", "-p", "paf"],
    ["-b", "-p", "sg"], ["-1", "-2", "-b", "-p", "paf"],
    # refusals: an unknown format, an unknown flag, a missing PAF
    ["-p", "xyz"], ["-x", "1"], ["MISSING"], ["EMPTY"],
]


def jax_cli(args):
    """The JAX package's CLI in this process: (exit code, stdout)."""
    from miniasm_tpu import cli as jcli

    buf = io.StringIO()
    with redirect_stdout(buf), redirect_stderr(io.StringIO()):
        rc = jcli.main(list(args))
    return rc, buf.getvalue()


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: "".join(f))
@pytest.mark.parametrize("data", ["sim_small", "sim_noisy"])
def test_options_match_jax(request, tmp_path, data, flags):
    paf = request.getfixturevalue(data)["paf"]
    if flags == ["MISSING"]:
        args = [str(tmp_path / "absent.paf")]
    elif flags == ["EMPTY"]:
        empty = tmp_path / "empty.paf"
        empty.write_text("")
        args = [str(empty)]
    else:
        args = flags + [paf]
    want_rc, want = jax_cli(args)
    rc, got, _ = run_port(args)
    assert (rc, got) == (want_rc, want)
    assert (rc != 0) == (flags in (["-p", "xyz"], ["-x", "1"],
                                   ["MISSING"]))
