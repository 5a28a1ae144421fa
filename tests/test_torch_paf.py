"""-p paf on the port's main path (select_build2 with paf_tables, then the
C++ replay HitsMt.print_paf) against the JAX package's: CLI stdout
byte-identical on both fixtures, alone and with -R and -b.  Also the
three ways the replay reaches the caller's output (a file descriptor, a
temporary file copied to a text stream's byte buffer, or decoded into a
stream without one), and a failed write raising instead of reporting a
truncated output as success."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import run_ours
from test_torch_cli import REPO, run_port
from miniasm_tpu_torch.config import Opt
from miniasm_tpu_torch.device import ENV
from miniasm_tpu_torch.pipeline import run

FLAGS = [[], ["-R"], ["-b"]]


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "".join(f) or "none")
@pytest.mark.parametrize("data", ["sim_small", "sim_noisy"])
def test_main_path_paf_matches_jax(request, data, flags):
    args = flags + ["-p", "paf", request.getfixturevalue(data)["paf"]]
    want = run_ours(args)
    rc, got, _ = run_port(args)
    assert rc == 0 and got == want and got


def test_paf_output_routes(sim_noisy, tmp_path):
    """stdout as a file (the replay writes to its descriptor), a text
    stream over a byte buffer and a StringIO print the same bytes."""
    want = run_ours(["-p", "paf", sim_noisy["paf"]])
    dst = tmp_path / "out.paf"
    with open(dst, "w") as f:
        r = subprocess.run([sys.executable, "-m", "miniasm_tpu_torch.cli",
                            "-p", "paf", sim_noisy["paf"]], stdout=f,
                           stderr=subprocess.PIPE, text=True, cwd=REPO,
                           env=dict(os.environ, **{ENV: "cpu"}),
                           timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert dst.read_text() == want
    raw = io.BytesIO()
    text = io.TextIOWrapper(raw, encoding="latin-1")
    run(sim_noisy["paf"], Opt(), outfmt="paf", out=text, device="cpu")
    text.flush()
    assert raw.getvalue().decode("latin-1") == want
    sio = io.StringIO()
    run(sim_noisy["paf"], Opt(), outfmt="paf", out=sio, device="cpu")
    assert sio.getvalue() == want


@pytest.mark.skipif(not os.path.exists("/dev/full"),
                    reason="needs /dev/full")
def test_paf_write_failure_raises(sim_small):
    """ENOSPC (emulated by /dev/full) surfaces as an error, both from the
    replay itself and through the pipeline."""
    from miniasm_tpu_torch.io.native.pafload import load_hits_mt

    _, d, h = load_hits_mt(sim_small["paf"], 2000, 100, retain_full=True)
    ns = d.n_seq
    tab = (np.zeros(ns, np.int32), np.asarray(d.lens, np.int32),
           np.zeros(ns, np.uint8))
    with open("/dev/full", "wb") as out:
        printed = h.print_paf(tab, tab, np.ones(ns, np.uint8), 2000, 1500,
                              1000, out.fileno())
    h.free()
    assert printed < 0
    with open("/dev/full", "w") as out:
        with pytest.raises(OSError, match="write failed"):
            run(sim_small["paf"], Opt(), outfmt="paf", out=out,
                device="cpu")
