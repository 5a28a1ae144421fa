"""The benchmark of miniasm_tpu_torch: one run of one cell.

    python portbench/run.py --workload ecoli_exact --seed 7 --seconds 10 \
        --trace 0

A cell (an entry of BENCHMARK.json's `workloads`) names a configuration
(portbench/configs/<name>.json: a genome and its reads) and a traffic mix
(portbench/traffic/<name>.json: what the overlapper reports and the
assembler's options).  The run makes the cell's PAF from the seed, builds
or loads the program's kernels, times the process's first assembly, warms
up once more, then assembles the same PAF back to back, one caller in a
closed loop, until `--seconds` have passed.  Each assembly is
`miniasm_tpu_torch.cli.main(argv + [paf])` in this process, its stdout to
a file, ending in a synchronize: what a sequencing centre's assembly
worker does, isolate after isolate.

After the window, the plain reference (portbench/ref, which imports
nothing of the program) assembles the same PAF, and every assembly's GFA
is compared with its bytes.  The last line of stdout is the result, a
JSON object; the numbers compared and their limits are also the last
lines of stderr.  With `--trace 1` the run profiles a few assemblies after
the window and reports the per-layer metrics (portbench/metrics/<name>.py,
each a reader found by its name) instead of the end-to-end ones.

The run needs the CUDA card: without one it exits 3 and prints no
result.  It never falls back to the CPU.  Where the reference's C
(portbench/ref/native.c, built by the host's cc on first use) does not
build, the run exits 5 with the compiler's message.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "miniasm_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "miniasm_tpu")
# the program's switches that change its path; the benchmark runs the
# default path
SWITCHES = ("MINIASM_TPU_TORCH_DEVICE", "MINIASM_TPU_CLEAN",
            "MINIASM_TPU_SNAPSHOT", "MINIASM_TPU_LOADER",
            "MINIASM_TPU_TIMING", "MINIASM_TPU_PROFILE",
            "MINIASM_TPU_NATIVE_SO")
# caches of the toolchains, at fixed paths inside the checkout (the
# program's own kernels build into miniasm_tpu_torch/build/ and
# miniasm_tpu_torch/io/native/, which it fixes itself)
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


class Failed(Exception):
    """The run cannot report a result."""

    def __init__(self, code, msg):
        super().__init__(msg)
        self.code = code


# ---------------------------------------------------------------- the cell


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name, root=ROOT):
    """The cell's BENCHMARK.json entry, its configuration and traffic
    files, its end-to-end metrics and its per-layer metric readers."""
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise Failed(2, "no BENCHMARK.json at %s" % root)
    bench = load_json(path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Failed(2, "no workload %r in BENCHMARK.json" % name)
    cell = cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    layer = [m for m in bench["per_layer"] if applies(m)]
    return cell, cfg, traffic, e2e, layer


def load_metric(name):
    """The reader module portbench/metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name,
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is one of FORBIDDEN,
    compared whole (miniasm_tpu_torch is not miniasm_tpu)."""
    modules = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in list(modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def peak_for(kind):
    for c in load_json(os.path.join(HERE, "peaks.json"))["cards"]:
        if c["match"] in kind:
            return c
    return None


def power_limit():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else None
    except (OSError, subprocess.SubprocessError):
        return None


# ---------------------------------------------------------------- the run


class Run:
    """What the readers of the per-layer metrics see."""

    def __init__(self):
        self.walls = []        # the window's assembly walls, s
        self.stages = []       # each window assembly's stage self times
        self.trace = None      # profiled assemblies (trace.Assembly)
        self.busy = []         # trace.busy of each
        self.counts = {}       # sizes the reference works out
        self.peak_bytes_per_s = None
        self.first_s = None    # the process's first assembly, s

    def stage_mean(self, names):
        """The mean over the window's assemblies of the summed self times
        of the named stages; None where no assembly had any of them."""
        vals = [sum(st[n] for n in names if n in st) for st in self.stages
                if any(n in st for n in names)]
        return sum(vals) / len(vals) if vals else None


def self_times(cumulative: dict) -> dict:
    """The stages' own seconds from the program's cumulative ticks
    (pipeline.LAST_TIMING: stage -> seconds since the run's start, in the
    order the stages ended)."""
    out, prev = {}, 0.0
    for k, t in cumulative.items():
        out[k] = t - prev
        prev = t
    return out


class Assembler:
    """The program's CLI in this process, one assembly a call."""

    def __init__(self, argv, paf, workdir, device_check=True):
        from miniasm_tpu_torch import cli, pipeline

        self.cli, self.pipeline = cli, pipeline
        self.argv = list(argv) + [paf]
        self.out = os.path.join(workdir, "out.gfa")
        self.err = os.path.join(workdir, "err.txt")
        self.sync = device_check
        self.digests = {}      # sha256 -> (count, first bytes)
        self.failed = 0

    def __call__(self):
        """One assembly; returns its wall (s) and its stage self times."""
        import torch

        t0 = time.perf_counter()
        rc = 1
        try:
            with open(self.out, "w") as out, open(self.err, "w") as err, \
                    contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = self.cli.main(self.argv)
            if self.sync:
                torch.cuda.synchronize()
        except Exception:  # a failed assembly is counted and reported
            traceback.print_exc()
        wall = time.perf_counter() - t0
        if rc != 0:
            self.failed += 1
            with open(self.err, errors="replace") as f:
                sys.stderr.write(f.read()[-2000:])
            return wall, {}
        with open(self.out, "rb") as f:
            data = f.read()
        d = hashlib.sha256(data).hexdigest()
        n, first = self.digests.get(d, (0, data))
        self.digests[d] = (n + 1, first)
        return wall, self_times(self.pipeline.LAST_TIMING)

    def compare(self, ref: bytes):
        """(assemblies, mismatched, first differing line)."""
        want = hashlib.sha256(ref).hexdigest()
        total = sum(n for n, _ in self.digests.values())
        bad = sum(n for d, (n, _) in self.digests.items() if d != want)
        where = None
        for d, (_, data) in self.digests.items():
            if d != want:
                a, b = data.split(b"\n"), ref.split(b"\n")
                i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                         min(len(a), len(b)))
                where = "line %d of %d/%d: %r != %r" % (
                    i + 1, len(a), len(b), a[i][:120] if i < len(a) else b"",
                    b[i][:120] if i < len(b) else b"")
                break
        return total, bad, where


def setup_env():
    cache = os.path.join(ROOT, ".portbench_cache")
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(cache, sub)
        os.makedirs(os.environ[var], exist_ok=True)
    for var in SWITCHES:
        os.environ.pop(var, None)


def check_card(chips):
    import torch

    if not torch.cuda.is_available():
        raise Failed(3, "no CUDA device: the benchmark runs on the card "
                        "only")
    if torch.cuda.device_count() < chips:
        raise Failed(3, "the cell needs %d CUDA devices, %d present"
                     % (chips, torch.cuda.device_count()))


def build_program():
    """The program's CUDA kernels and host library, built or loaded from
    their fixed directories; nothing here touches the card."""
    from miniasm_tpu_torch import cuda
    from miniasm_tpu_torch.io.native.build import get_lib

    cuda.build()
    get_lib()


def run(args, device_check=True, assembler_hook=None, sizes=None):
    """One run; returns (result dict, check lines).  `device_check=False`
    runs on whatever device the program picks (the tests' CPU runs),
    `assembler_hook` wraps the Assembler (the tests' faults) and `sizes`
    replaces keys of the configuration (the tests' small genomes)."""
    from portbench import devtrace as tr
    from portbench.gen.inputs import make_paf
    from portbench.ref.miniasm_ref import assemble

    cell, cfg, traffic, e2e, layer = load_cell(args.workload)
    cfg = dict(cfg, **(sizes or {}))
    if not os.path.isdir(os.path.join(ROOT, PROGRAM)):
        raise Failed(2, "the program %s is not in this checkout" % PROGRAM)
    if device_check:
        setup_env()
        check_card(int(cell["chips"]))
    t_card = time.perf_counter() - T_START
    readers = {m["name"]: load_metric(m["name"]) for m in layer} \
        if args.trace else {}
    work = tempfile.mkdtemp(prefix="portbench-")
    try:
        return _run(args, cfg, traffic, e2e, layer, readers, work,
                    device_check, assembler_hook, make_paf, assemble, tr,
                    t_card)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(args, cfg, traffic, e2e, layer, readers, work, device_check,
         assembler_hook, make_paf, assemble, tr, t_card):
    import torch

    t = time.perf_counter()
    paf, lines = make_paf(cfg, traffic, args.seed, work)
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    if device_check:
        build_program()
    build_s = time.perf_counter() - t
    asm = Assembler(traffic["argv"], paf, work, device_check)
    if assembler_hook:
        asm = assembler_hook(asm)
    first_s, first_st = asm()
    warm_s, _ = asm()  # the warm-up: every kernel and module of the path
    setup_s = time.perf_counter() - T_START
    sys.stderr.write("[portbench] set-up %.3f s: imports and the card "
                     "%.3f s, PAF %d lines in %.3f s, build %.3f s, first "
                     "assembly %.3f s, warm-up %.3f s\n"
                     % (setup_s, t_card, lines, gen_s, build_s, first_s,
                        warm_s))
    sys.stderr.write("[portbench] first assembly's stages: %s\n" % " ".join(
        "%s %.3f" % kv for kv in first_st.items()))

    r = Run()
    r.first_s = first_s
    t0 = time.perf_counter()
    t_end = t0
    while t_end - t0 < args.seconds:
        wall, st = asm()
        t_end = time.perf_counter()
        r.walls.append(wall)
        r.stages.append(st)
    window_s = t_end - t0
    n_window = len(r.walls)

    dev = {"platform": "gpu" if device_check else "cpu",
           "kind": torch.cuda.get_device_name() if device_check else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
           if device_check else 0}
    breakdown = None
    if args.trace:
        r.trace, dev_trace, breakdown = _profile(
            asm, int(cfg.get("trace_assemblies", 2)), work, device_check, tr)
        r.busy = [tr.busy(a) for a in r.trace]
        dev["busy_s"] = sum(b["busy_s"] for b in r.busy)
        dev["window_s"] = sum(b["window_s"] for b in r.busy)
        dev.update(dev_trace)

    # the program's state freed before the reference runs
    gc.collect()
    if device_check:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    counts = {}
    from portbench.ref.native import BuildError
    try:
        ref = assemble(paf, traffic["argv"], stats=counts)
    except BuildError as e:
        raise Failed(5, str(e)) from e
    ref_s = time.perf_counter() - t
    total, bad, where = asm.compare(ref)
    failed = asm.failed
    found = forbidden_modules()
    if found:
        raise Failed(4, "the run loaded %s" % ", ".join(found))
    q = sorted(r.walls)
    sys.stderr.write("[portbench] window %.3f s, %d assemblies (walls min "
                     "%.4f, median %.4f, max %.4f s); reference %.3f s, %d "
                     "bytes\n" % (window_s, n_window, q[0], q[len(q) // 2],
                                  q[-1], ref_s, len(ref)))
    sys.stderr.write("[portbench] reference sizes: %s\n" % json.dumps(counts))
    if where:
        sys.stderr.write("[portbench] first difference: %s\n" % where)

    if args.trace:
        r.counts = counts
        pk = peak_for(dev["kind"])
        r.peak_bytes_per_s = pk["hbm_bytes_per_s"] if pk else None
        metrics = {}
        for m in layer:
            v = readers[m["name"]].read(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"paf_lines_per_s": lines * n_window / window_s,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in e2e}
    check = {"mismatched": {"value": bad, "limit": 0},
             "failed": {"value": failed, "limit": 0}}
    result = {"correct": bad == 0 and failed == 0 and total > 0,
              "attempted": total + failed, "failed": bad + failed,
              "metrics": metrics, "device": dev}
    if breakdown:
        result["breakdown"] = breakdown
    result["check"] = check
    lines_out = ["check: %s %d (limit %d)" % (k, v["value"], v["limit"])
                 for k, v in check.items()]
    return result, lines_out


def _profile(asm, n, work, device_check, tr):
    """`n` assemblies under torch.profiler, each inside a
    `portbench:assembly` range (portbench/devtrace.py reads them).  Returns the trace's assemblies, the
    card's power limit, and the breakdown: the device operations that
    took the most time, and the longest idle gaps by stage."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device_check:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(n):
            with record_function("portbench:assembly"):
                asm()
    path = os.path.join(work, "trace.json")
    prof.export_chrome_trace(path)
    asms = tr.load(path)
    os.remove(path)
    ops, gaps = {}, []
    for a in asms:
        for t0, t1, cat, name in a.device:
            ops[name] = ops.get(name, 0.0) + (t1 - t0) / 1e6
        gaps += tr.busy(a)["gaps"]
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(gaps, reverse=True)[:10]
    breakdown = {"device_ops": [[k[:120], v] for k, v in top],
                 "idle_gaps": [[s, g] for g, s in gaps]}
    extra = {}
    if device_check:
        extra["power"] = power_limit()
        sys.stderr.write("[portbench] card: %s\n" % extra["power"])
    return asms, extra, breakdown


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # the checkout's root, not this directory, heads the path
    sys.path[:] = [ROOT] + [d for d in sys.path if os.path.abspath(d or ".") != HERE]
    try:
        result, check = run(args)
    except Failed as e:
        sys.stderr.write("[portbench] %s\n" % e)
        return e.code
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    sys.stderr.write("\n".join(check) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
