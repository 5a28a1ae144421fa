"""The one generator of the benchmark's inputs: a configuration (a genome
and its reads) under a traffic mix (what the overlapper reports, in which
order, in which file), from a seed.

A configuration file names the simulator's arguments and `layout_seed`:
the genome, the reads' places and lengths, and so every overlap, come
from that seed, the same in every run.  The run's `--seed` draws the
order of the reads in the read file (and so their names, read000000 on,
and the order in which the overlapper writes their records): the same
work in another order, so that runs of different seeds do the same
amount of it.  A traffic file names:

- `recall`: each true overlap is reported with this probability (1.0:
  every one), drawn from the configuration's layout seed and not from the
  run's, so every run misses the same overlaps;
- `order`: `query_grouped` (minimap2's order: a query's records together,
  queries in read-file order) or `shuffled` (the lines in an order drawn
  from the run's seed, as merged overlapper outputs come);
- `gzip`: 0 for a plain file, else the gzip level of the file;
- `argv`: the assembler's options, before the file;
- `why` and `source`: what the mix stands for, and where its numbers
  come from.

The same seed gives the same bytes.  Read sequences (`-f`) are not
generated: no mix asks for them yet.
"""

from __future__ import annotations

import gzip
import os
import shutil

import numpy as np

from . import simulate as S

SIM_KEYS = ("genome_len", "coverage", "mean_read", "sd_read", "min_read",
            "circular", "min_ovlp_emit", "name_prefix")
TRAFFIC_KEYS = {"recall", "order", "gzip", "argv", "why", "source"}


def check_traffic(t: dict) -> None:
    unknown = set(t) - TRAFFIC_KEYS
    if unknown:
        raise ValueError("traffic keys the generator does not know: %s"
                         % sorted(unknown))
    if not 0.0 < float(t["recall"]) <= 1.0:
        raise ValueError("recall must lie in (0, 1]")
    if t.get("order", "query_grouped") not in ("query_grouped", "shuffled"):
        raise ValueError("order: query_grouped or shuffled")
    if not 0 <= int(t.get("gzip", 0)) <= 9:
        raise ValueError("gzip: a level from 0 (none) to 9")


def make_paf(cfg: dict, traffic: dict, seed: int, workdir: str):
    """Write the cell's PAF for the run's `seed` into `workdir`.  Returns
    (path, lines)."""
    check_traffic(traffic)
    layout = int(cfg["layout_seed"])
    sim = S.simulate(seed=layout,
                     **{k: cfg[k] for k in SIM_KEYS if k in cfg})
    a = S.paf_arrays(sim)
    n = len(a["qi"])
    recall = float(traffic["recall"])
    if recall < 1.0:
        keep = np.random.default_rng([layout, 1]).random(n) < recall
        a = {k: v[keep] for k, v in a.items()}
    # the read file's order, from the run's seed: read i is written as
    # the perm[i]-th read, named after its place
    rng = np.random.default_rng([seed, 2])
    perm = rng.permutation(len(sim["lens"]))
    a["qi"], a["ti"] = perm[a["qi"]], perm[a["ti"]]
    sim = dict(sim, names=["%s%06d" % (cfg.get("name_prefix", "read"), i)
                           for i in range(len(perm))])
    a = S.grouped(a)
    if traffic.get("order", "query_grouped") == "shuffled":
        p = rng.permutation(len(a["qi"]))
        a = {k: v[p] for k, v in a.items()}
    path = os.path.join(workdir, "reads.paf")
    lines = S.write_paf(sim, path, a)
    level = int(traffic.get("gzip", 0))
    if level:
        with open(path, "rb") as src, \
                gzip.open(path + ".gz", "wb", compresslevel=level) as dst:
            shutil.copyfileobj(src, dst, 1 << 24)
        os.remove(path)
        path += ".gz"
    return path, lines
