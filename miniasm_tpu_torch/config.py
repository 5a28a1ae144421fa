"""Pipeline options.

Mirrors the option surface of the reference assembler (ma_opt_t,
reference miniasm.h:12-27; defaults ma_opt_init, common.c:5-23).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Opt:
    # --- pre-selection (reference common.c:6-9) ---
    min_span: int = 2000       # -s
    min_match: int = 100       # -m
    min_dp: int = 3            # -c
    min_iden: float = 0.05     # -i

    # --- overlap classification (reference common.c:11-13) ---
    max_hang: int = 1000       # -h
    min_ovlp: int = 2000       # -o (defaults to min_span, reference main.c:74)
    int_frac: float = 0.8      # -I

    # --- layout / graph cleaning (reference common.c:15-22) ---
    gap_fuzz: int = 1000       # -g
    n_rounds: int = 2          # -n minus one (reference main.c:60)
    bub_dist: int = 50000      # -d
    max_ext: int = 4           # -e
    min_ovlp_drop_ratio: float = 0.5   # -r second value
    max_ovlp_drop_ratio: float = 0.7   # -r first value
    final_ovlp_drop_ratio: float = 0.8  # -F

    @classmethod
    def from_dict(cls, d: dict) -> "Opt":
        """Build from a field dict such as `dataclasses.asdict` of the JAX
        package's Opt.  Its execution-only fields (n_shards, exact) have no
        counterpart here and are ignored; every reference option must be
        present."""
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})


verbose = 3  # reference common.c:3 (ma_verbose)
