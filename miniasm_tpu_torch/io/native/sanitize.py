"""Sanitizer jobs for the port's host C++ (every .cpp of io/native/): the
counterpart of the JAX package's scripts/asan.sh and tsan.sh and the
Python script they run.

    python -m miniasm_tpu_torch.io.native.sanitize asan|tsan|none

builds every .cpp of this directory into one library in a new temporary
directory, with the mode's flags (asan: AddressSanitizer and UBSan, no
recovery, as asan.sh:18-20; tsan: ThreadSanitizer, as tsan.sh:16-18;
none: the same -O1 -g build without a sanitizer), one g++ per source,
all started together.  It then runs this module again as the exerciser,
with MINIASM_TPU_NATIVE_SO naming that library and, under a sanitizer,
its runtime in LD_PRELOAD: the sanitized code lives in a library that an
unsanitized python loads.  Leak checks are off (CPython keeps interned
objects at exit); every memory-error, UB and race check stays on and
stops the run at its first report.

The exerciser calls every native entry point of the port on the CPU, the
card never: load_paf_native (plain, gzip, with an exclusion set, the
10-field bl carry), load_hits_mt in its three formats (FMT3, the 4-row
layout under MINIASM_TPU_FMT3=0, the 7-row host load of upload=False),
over many pieces, with the format switches of a mid-stream 17-bit record
and of an ungrouped stream, with carry_seed, retain_full and print_paf,
build_rank and arc_ranks, and a free while the parser threads run;
load_hits_v2; the exact radix on both of its paths; finalize_native,
ma_no_cont and ma_ug_seq_native through the CLI (MINIASM_TPU_CLEAN=
native, -R -f), beside the main path, -p paf, the staged path and the v2
loader.  It prints "<mode>: clean" and exits 0 when every check held.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_DIR)))
_COMMON = ["-O1", "-g", "-fno-omit-frame-pointer", "-fPIC", "-std=c++17",
           "-pthread"]
FLAGS = {"asan": ["-fsanitize=address,undefined",
                  "-fno-sanitize-recover=all"],
         "tsan": ["-fsanitize=thread"],
         "none": []}
RUNTIME = {"asan": ("libasan.so", "ASAN_OPTIONS",
                    "detect_leaks=0:abort_on_error=1"),
           "tsan": ("libtsan.so", "TSAN_OPTIONS",
                    "halt_on_error=1:report_bugs=1")}


def build(mode: str, out_dir: str) -> str:
    """Compile every .cpp of io/native/ with the flags of `mode` into
    out_dir/libminiasm_torch_native.so (one g++ a source, started
    together, then one link); returns its path or raises."""
    flags = _COMMON + FLAGS[mode]
    srcs = sorted(f for f in os.listdir(_DIR) if f.endswith(".cpp"))
    objs = [os.path.join(out_dir, f[:-4] + ".o") for f in srcs]
    procs = [subprocess.Popen(["g++"] + flags + ["-c", "-o", o,
                                                 os.path.join(_DIR, s)],
                              stderr=subprocess.PIPE, text=True)
             for s, o in zip(srcs, objs)]
    errs = [(s, p.communicate()[1], p.returncode)
            for s, p in zip(srcs, procs)]
    bad = [(s, e) for s, e, rc in errs if rc != 0]
    if bad:
        raise RuntimeError("%s build of %s failed: %s"
                           % (mode, bad[0][0], bad[0][1][-2000:]))
    so = os.path.join(out_dir, "libminiasm_torch_native.so")
    r = subprocess.run(["g++"] + flags + ["-shared", "-o", so] + objs
                       + ["-lz"], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError("%s link failed: %s" % (mode, r.stderr[-2000:]))
    return so


def child_env(mode: str, so: str) -> dict:
    """The exerciser's environment: the library, the runtime preloaded and
    its options, one torch thread (the exerciser's torch ops stay out of
    the race checker's view), and the port on the CPU."""
    env = dict(os.environ, MINIASM_TPU_NATIVE_SO=so,
               MINIASM_TPU_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=_ROOT)
    for var in ("MINIASM_TPU_LOADER", "MINIASM_TPU_FMT3",
                "MINIASM_TPU_CLEAN", "MINIASM_TPU_PROFILE",
                "MINIASM_TPU_SNAPSHOT"):
        env.pop(var, None)
    if mode in RUNTIME:
        lib, var, opts = RUNTIME[mode]
        rt = subprocess.run(["g++", "-print-file-name=" + lib],
                            capture_output=True, text=True,
                            check=True).stdout.strip()
        env["LD_PRELOAD"] = rt
        env[var] = opts
    return env


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) == 2 and argv[0] == "--exercise":
        _exercise(argv[1])
        return 0
    if len(argv) != 1 or argv[0] not in FLAGS:
        sys.stderr.write("usage: python -m miniasm_tpu_torch.io.native."
                         "sanitize asan|tsan|none\n")
        return 2
    mode = argv[0]
    with tempfile.TemporaryDirectory(prefix="miniasm_%s_" % mode) as out:
        t0 = time.time()
        so = build(mode, out)
        t_build = time.time() - t0
        r = subprocess.run([sys.executable, "-m", __spec__.name, "--exercise",
                            mode], cwd=_ROOT, env=child_env(mode, so))
    if r.returncode != 0:
        sys.stderr.write("%s: the exerciser exited %d\n"
                         % (mode, r.returncode))
        return 1
    print("%s: clean (build %.1f s, exerciser %.1f s)"
          % (mode, t_build, time.time() - t0 - t_build), flush=True)
    return 0


# ---------------------------------------------------------------------------
# the exerciser, run under the sanitizer


def _unpack(a):
    """A loader colmat (4 or 7 rows, torch or numpy) as (7, n) numpy."""
    import numpy as np
    import torch

    from .pafload import unpack4_plain

    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    if a.shape[0] == 4:
        a = unpack4_plain(a)
    return a.numpy()


def _edge_pafs(tmp):
    """The loaders' edge inputs (tests/test_native_io.py): short and
    10-field lines, a 17-bit record mid-stream (the 7-row switch), a
    wrapped qs > qe record, and an ungrouped stream (the 4-row switch)."""
    edge = os.path.join(tmp, "edge.paf")
    with open(edge, "w") as f:
        f.write("a\t9000\t0\t5000\t+\tb\t9000\t4000\t9000\t5000\t5000\tx\n"
                "bad\tline\n"
                "c\t9000\t0\t4000\t-\td\t9000\t0\t4000\t4000\n"
                "e\t9000\t0\t100\t+\tf\t9000\t0\t100\t100\t100\n"
                "g\t9000\t70000\t100\t+\th\t9000\t100\t5100\t4000\t5000\n")
    mix = os.path.join(tmp, "mix.paf")
    with open(mix, "w") as f:
        for i in range(3000):
            if i == 1500:
                f.write("big\t100000\t70000\t96000\t+\tother\t100000\t200\t"
                        "26200\t20000\t26000\n")
            f.write("s%d\t30000\t10\t25000\t+\tt%d\t30000\t100\t25100\t"
                    "20000\t25000\n" % (i, (i + 1) % 3000))
    alt = os.path.join(tmp, "alt.paf")
    with open(alt, "w") as f:
        for i in range(6000):
            f.write("q%d\t9000\t10\t8000\t+\tt%d\t9000\t100\t8100\t6000\t"
                    "8000\n" % (i % 997, 997 + (i % 991)))
    return edge, mix, alt


def _exercise(mode: str) -> None:
    import ctypes
    import gzip
    import io
    import random
    import shutil
    from contextlib import redirect_stderr, redirect_stdout

    import numpy as np
    import torch

    from ... import cli
    from ...config import Opt
    from ...eval.simulate import simulate, write_fasta, write_paf
    from ...utils.exact_sort import radix_argsort
    from ..seqdict import SeqDict
    from . import pafload
    from .build import get_lib
    from .pafload import load_hits_mt, load_hits_v2, load_paf_native

    torch.set_num_threads(1)
    assert os.environ.get("MINIASM_TPU_NATIVE_SO"), "no library named"
    lib = get_lib()
    assert lib._name == os.environ["MINIASM_TPU_NATIVE_SO"], lib._name
    tmp = tempfile.mkdtemp(prefix="sanitize_")
    paf = os.path.join(tmp, "r.paf")
    noisy = os.path.join(tmp, "noisy.paf")
    fa = os.path.join(tmp, "r.fa")
    sim = simulate(genome_len=120_000, coverage=14.0, seed=9)
    write_paf(sim, paf)
    write_fasta(sim, fa)
    rng = random.Random(36)
    with open(paf) as f, open(noisy, "w") as g:
        g.writelines(ln for ln in f if rng.random() > 0.5)
    edge, mix, alt = _edge_pafs(tmp)
    i32p = ctypes.POINTER(ctypes.c_int32)

    # --- the staged loader: plain, gzip, an exclusion set, edge lines ---
    load = load_paf_native(paf, 2000, 100)
    gz = os.path.join(tmp, "r.paf.gz")
    with open(paf, "rb") as fi, gzip.open(gz, "wb") as fo:
        shutil.copyfileobj(fi, fo)
    assert np.array_equal(load_paf_native(gz, 2000, 100).qid, load.qid)
    excl = SeqDict()
    excl.put(load.d.names[0], 1)
    assert load_paf_native(paf, 2000, 100, excl=excl).n < load.n
    e = load_paf_native(edge, 2000, 100)
    assert e.n == 3 and int(e.bl[1]) == 5000, (e.n, e.bl)

    # --- the streamed loader in its three formats, many pieces ---
    old = pafload._CHUNK
    pafload._CHUNK = 4096  # small inputs ride pieces of _CHUNK/4
    try:
        for fn in (paf, gz, noisy, mix, alt, edge):
            c3, d3, h3 = load_hits_mt(fn, 2000, 100)
            os.environ["MINIASM_TPU_FMT3"] = "0"
            try:
                c4, d4, h4 = load_hits_mt(fn, 2000, 100)
            finally:
                os.environ.pop("MINIASM_TPU_FMT3")
            c7, d7, h7 = load_hits_mt(fn, 2000, 100, upload=False)
            cv, dv, hv = load_hits_v2(fn, 2000, 100)
            n = hv.n_orig
            for c, d, h in ((c3, d3, h3), (c4, d4, h4), (c7, d7, h7)):
                assert h.n_orig == n and d.names == dv.names, fn
                assert np.array_equal(_unpack(c), cv.numpy()), fn
                idx = np.concatenate([np.arange(n), h.cap + np.arange(n)])
                vidx = np.concatenate([np.arange(n), n + np.arange(n)])
                assert np.array_equal(h.arc_ranks(idx),
                                      hv.arc_ranks(vidx)), fn
                h.free()
            hv.free()
        # the host view of the v2 loader, and a carry seed
        hc, _, hh = load_hits_v2(paf, 2000, 100, upload=False)
        assert hc.shape == (7, hh.n_orig)
        hh.free()
        c, _, h = load_hits_mt(paf, 2000, 100, carry_seed=777)
        h.free()
    finally:
        pafload._CHUNK = old

    # --- the -p paf replay over the retained records ---
    c5, d5, h5 = load_hits_mt(paf, 2000, 100, retain_full=True, carry_seed=0)
    ns5 = d5.n_seq
    s0 = np.zeros(ns5, np.int32)
    e0 = np.asarray(d5.lens, np.int32)
    dz = np.zeros(ns5, np.uint8)
    out_fn = os.path.join(tmp, "replay.paf")
    with open(out_fn, "wb") as outf:
        printed = h5.print_paf((s0, e0, dz), (s0, e0, dz),
                               np.ones(ns5, np.uint8), Opt().min_span,
                               int(Opt().max_hang * 1.5),
                               int(Opt().min_ovlp * 0.5), outf.fileno())
    assert printed > 0 and os.path.getsize(out_fn) > 0
    h5.free()

    # --- a free while the parser threads run: one piece of many pulled ---
    pafload._bind(lib)
    for fmt in (3, 4, 7):
        sz = 1024
        res = lib.ma_mt_begin(paf.encode(), 2000, 100, b"", 0, 1, 0.05, sz,
                              2, 0)
        assert res
        buf = np.empty(7 * sz, dtype=np.int32)
        nxt = {3: lib.ma_mt_next3, 4: lib.ma_mt_next4, 7: lib.ma_mt_next}
        assert nxt[fmt](res, buf.ctypes.data_as(i32p), sz) > 0
        lib.ma_mt_free(res)

    # --- the exact radix: its sequential and its threaded bucket path ---
    keys = np.random.default_rng(0).integers(0, 2**63, 100_000,
                                             dtype=np.uint64)
    assert np.all(np.diff(keys[radix_argsort(keys)]) >= 0)
    qid = np.repeat(np.arange(25_000, dtype=np.uint64), 60)
    qs = np.random.default_rng(1).integers(0, 32768, qid.shape[0],
                                           dtype=np.uint64)
    keys = (qid << np.uint64(32)) | qs
    np.random.default_rng(2).shuffle(keys)
    assert np.all(np.diff(keys[radix_argsort(keys)]) >= 0)

    # --- the CLI: finalize_native, ma_no_cont, ma_ug_seq_native, and the
    #     paths around them ---
    def run(args, **env):
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        buf = io.StringIO()
        try:
            with redirect_stdout(buf), redirect_stderr(io.StringIO()):
                rc = cli.main(list(args))
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        assert rc == 0 and buf.getvalue(), (args, env)
        return buf.getvalue()

    for src in (paf, noisy):
        ug = run(["-p", "ug", src])
        assert run(["-p", "ug", src], MINIASM_TPU_CLEAN="native") == ug
        assert run(["-p", "ug", src], MINIASM_TPU_LOADER="v2") == ug
        run(["-p", "paf", src])
        run(["-1", "-p", "sg", src])
        run(["-R", "-f", fa, "-p", "ug", src])
        run(["-1", "-R", "-f", fa, "-p", "ug", src])
    shutil.rmtree(tmp)
    print("sanitize exerciser (%s): every native entry point exercised" % mode,
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
