"""miniasm-compatible command-line interface (reference main.c:32-106).

The getopt surface of miniasm_tpu/cli.py: the same flags and coupling
rules (-o defaults to -s, main.c:74; -r parses "max[,min]", main.c:68-72;
-n stores rounds-1, main.c:60).  Runs on the GPU; set
MINIASM_TPU_TORCH_DEVICE=cpu to run on the CPU.  -1, -2 and -S below 5
take the staged selection path.  MINIASM_TPU_CLEAN=native|py swaps the
hybrid cleaner for an oracle, MINIASM_TPU_SNAPSHOT=DIR saves and
restores the Step 3/4 boundary state, and MINIASM_TPU_PROFILE=DIR writes
a torch.profiler trace of the run to DIR/trace.json, as in the JAX
package (its other switches are read where they act: pipeline.py).

    python -m miniasm_tpu_torch.cli in.paf > out.gfa
"""

from __future__ import annotations

import getopt
import os
import sys

from .config import Opt
from .device import ENV, get_device
from .utils.timers import cputime, liftrlimit, realtime

VERSION = "0.1.0 (miniasm 0.3-r179 capability parity, PyTorch/CUDA)"

USAGE = """Usage: miniasm-tpu-torch [options] <in.paf>
Options:
  Pre-selection:
    -R          prefilter clearly contained reads (2-pass required)
    -m INT      min match length [100]
    -i FLOAT    min identity [0.05]
    -s INT      min span [2000]
    -c INT      min coverage [3]
  Overlap:
    -o INT      min overlap [same as -s]
    -h INT      max over hang length [1000]
    -I FLOAT    min end-to-end match ratio [0.8]
  Layout:
    -g INT      max gap differences between reads for trans-reduction [1000]
    -d INT      max distance for bubble popping [50000]
    -e INT      small unitig threshold [4]
    -f FILE     read sequences []
    -n INT      rounds of short overlap removal [3]
    -r FLOAT[,FLOAT]
                max and min overlap drop ratio [0.7,0.5]
    -F FLOAT    aggressive overlap drop ratio in the end [0.8]
  Miscellaneous:
    -p STR      output information: bed, paf, sg or ug [ug]
    -b          both directions of an arc are present in input
    -1          skip 1-pass read selection
    -2          skip 2-pass read selection
    -V          print version number
Environment:
    %s=cpu   run on the CPU (default: the GPU)
    MINIASM_TPU_CLEAN=STR          graph cleaner: hybrid, native (C++
                                   sequential oracle) or py (Python
                                   sequential oracle) [hybrid]
    MINIASM_TPU_SNAPSHOT=DIR       save the state after Step 3 in DIR, and
                                   restore it on a later run with the same
                                   input and options (not with -R)
    MINIASM_TPU_LOADER=v2          load with the single-pass v2 loader
    MINIASM_TPU_TIMING=1           write [T::stage] +seconds to stderr
    MINIASM_TPU_PROFILE=DIR        write a profiler trace to DIR/trace.json
    MINIASM_TPU_NATIVE_SO=FILE     load this host library, do not build
""" % ENV


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opt = Opt()
    stage = 100
    no_first = no_second = no_cont = False
    bi_dir = True
    o_set = False
    fn_reads = None
    outfmt = "ug"
    try:
        opts, args = getopt.getopt(argv, "n:m:s:c:S:i:d:g:o:h:I:r:f:e:p:12VBRbF:")
    except getopt.GetoptError as e:
        sys.stderr.write("ERROR: %s\n" % e)
        return 1
    for c, a in opts:
        if c == "-m":
            opt.min_match = int(a)
        elif c == "-i":
            opt.min_iden = float(a)
        elif c == "-s":
            opt.min_span = int(a)
        elif c == "-c":
            opt.min_dp = int(a)
        elif c == "-o":
            opt.min_ovlp = int(a)
            o_set = True
        elif c == "-S":
            stage = int(a)
        elif c == "-d":
            opt.bub_dist = int(a)
        elif c == "-g":
            opt.gap_fuzz = int(a)
        elif c == "-h":
            opt.max_hang = int(a)
        elif c == "-I":
            opt.int_frac = float(a)
        elif c == "-e":
            opt.max_ext = int(a)
        elif c == "-f":
            fn_reads = a
        elif c == "-p":
            outfmt = a
        elif c == "-1":
            no_first = True
        elif c == "-2":
            no_second = True
        elif c == "-n":
            opt.n_rounds = int(a) - 1
        elif c == "-B":
            bi_dir = True
        elif c == "-b":
            bi_dir = False
        elif c == "-R":
            no_cont = True
        elif c == "-F":
            opt.final_ovlp_drop_ratio = float(a)
        elif c == "-V":
            print(VERSION)
            return 0
        elif c == "-r":
            parts = a.split(",")
            opt.max_ovlp_drop_ratio = float(parts[0])
            if len(parts) > 1:
                opt.min_ovlp_drop_ratio = float(parts[1])
    if not o_set:
        opt.min_ovlp = opt.min_span
    if not args:
        sys.stderr.write(USAGE)
        return 1
    if outfmt not in ("bed", "paf", "sg", "ug"):
        sys.stderr.write("ERROR: unknown output format '%s' (-p bed|paf|sg|ug)\n" % outfmt)
        return 1
    try:
        device = get_device(os.environ.get(ENV) or None)
    except (RuntimeError, ValueError) as e:
        sys.stderr.write("ERROR: %s\n" % e)
        return 1
    liftrlimit()
    from .pipeline import run

    # environment variables, as in the JAX package: the getopt string is
    # the reference's
    snapshot_dir = os.environ.get("MINIASM_TPU_SNAPSHOT")
    prof_dir = os.environ.get("MINIASM_TPU_PROFILE")
    prof = _profiler(device) if prof_dir else None
    try:
        run(args[0], opt, outfmt=outfmt, fn_reads=fn_reads, stage=stage,
            no_first=no_first, no_second=no_second, bi_dir=bi_dir,
            no_cont=no_cont, device=device, snapshot_dir=snapshot_dir)
    except FileNotFoundError as e:
        sys.stderr.write("[E::main] could not open file %s\n" % e.filename)
        return 1
    finally:
        if prof is not None:
            prof.stop()
            os.makedirs(prof_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(prof_dir, "trace.json"))
            sys.stderr.write("[M::main] profiler trace written to %s\n"
                             % prof_dir)
    sys.stderr.write("[M::main] Version: %s\n" % VERSION)
    sys.stderr.write("[M::main] CMD: miniasm-tpu-torch %s\n" % " ".join(argv))
    sys.stderr.write("[M::main] Real time: %.3f sec; CPU: %.3f sec\n"
                     % (realtime(), cputime()))
    return 0


def _profiler(device):
    """A started torch.profiler over the host, and the card when the run
    is on one (JAX cli.py:131-157 traces the XLA ops); the pipeline's
    stages are its `stage:<name>` ranges."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


if __name__ == "__main__":
    sys.exit(main())
