"""Host-side read-name interning dictionary.

Equivalent of the reference's sdict (sdict.c:27-86): name -> dense id in
first-appearance order, per-id length, soft-delete flag, and `squeeze`
renumbering that preserves relative order of surviving ids (this order is
load-bearing: all downstream vertex ids and GFA line order derive from it,
reference sdict.c:69-86).

Names never reach the device; device arrays index reads by these dense ids.
"""

from __future__ import annotations

import numpy as np


class SeqDict:
    __slots__ = ("index", "names", "lens", "dels")

    def __init__(self):
        self.index: dict[str, int] = {}
        self.names: list[str] = []
        self.lens: list[int] = []
        self.dels: np.ndarray | None = None  # lazily materialized bool array

    def __len__(self) -> int:
        return len(self.names)

    @property
    def n_seq(self) -> int:
        return len(self.names)

    def put(self, name: str, length: int) -> int:
        """Insert-or-get (reference sd_put, sdict.c:27-45). The length of the
        first insertion wins, matching the reference."""
        i = self.index.get(name)
        if i is None:
            i = len(self.names)
            self.index[name] = i
            self.names.append(name)
            self.lens.append(int(length))
        return i

    def get(self, name: str) -> int:
        return self.index.get(name, -1)

    def lens_array(self) -> np.ndarray:
        return np.asarray(self.lens, dtype=np.uint32)

    def del_array(self) -> np.ndarray:
        if self.dels is None or len(self.dels) != len(self.names):
            old = self.dels
            self.dels = np.zeros(len(self.names), dtype=bool)
            if old is not None:
                self.dels[: len(old)] = old
        return self.dels

    def mark_deleted(self, mask: np.ndarray) -> None:
        d = self.del_array()
        d |= np.asarray(mask, dtype=bool)

    def squeeze(self) -> np.ndarray:
        """Drop deleted ids, renumber survivors densely preserving order;
        return old->new int32 map with -1 for dropped (reference
        sd_squeeze, sdict.c:69-86)."""
        d = self.del_array()
        keep = ~d
        new_of_old = np.cumsum(keep, dtype=np.int64) - 1
        mp = np.where(keep, new_of_old, -1).astype(np.int32)
        self.names = [n for n, k in zip(self.names, keep) if k]
        self.lens = [l for l, k in zip(self.lens, keep) if k]
        self.index = {n: i for i, n in enumerate(self.names)}
        self.dels = np.zeros(len(self.names), dtype=bool)
        return mp

    @staticmethod
    def from_arrays(names, lens) -> "SeqDict":
        d = SeqDict()
        d.names = list(names)
        d.lens = [int(l) for l in lens]
        d.index = dict(zip(d.names, range(len(d.names))))
        return d
