"""K11 `route`: rows to per-destination buckets of an all_to_all send
buffer (csrc/route.cu).

Port of the bucketing of the sharded JAX programs: the mirror-side event
exchange of the select step (miniasm_tpu/parallel/full.py:209-231) and
the repartition of the multi-process worker (parallel/multihost.py:
340-353).  JAX sorts the rows stably by destination, slots each row at
iota - first[dest] and scatters into (R, n_sh, cap) with one capacity
`cap` for every bucket, proved on the host.  torch.distributed's
all_to_all_single takes uneven split sizes, so each bucket here is sized
exactly: a `Layout` reads the histogram of the destinations back once
(the quantum `_round_up` pads to is a TPU layout choice and goes), and
every payload routed through it shares its buckets, so no row can fall
beyond its bucket.  K11 is two kernels: the layout pass, once per
destination vector, and the scatter, once per payload.

The send buffer is (S, R) int32: bucket k is rows [off_k, off_k + size_k),
off the exclusive prefix sum of the sizes, rows in their input order;
all_to_all_single splits it along dim 0.
"""

from __future__ import annotations

import torch

from ..cuda import I32, I64, P, Kernel, ptr

# the scatter, one launch a payload (full.py:221-231, the exchange)
K_ROUTE = Kernel("route", "route.cu", "ma_route",
                 [P, I64, P, I32, I32, P, P],
                 replaces="miniasm_tpu/parallel/full.py:209")
# the layout pass, one launch a destination vector (full.py:211-219: the
# stable sort, each bucket's first row and each row's slot)
K_ROUTE_LAYOUT = Kernel("route_layout", "route.cu", "ma_route_layout",
                        [P, I64, I32, P, P, P],
                        replaces="miniasm_tpu/parallel/full.py:211")

_TILE = 4 * 256  # rows per tile of both kernels (route.cu: TILE)
MAX_SHARDS = 1024  # the scatter keeps 10 (n_sh + 1) words in shared memory


def layout_plain(dest, n_sh: int):
    """Plain PyTorch version of the layout pass: the n_sh + 3 bins of dest
    (below 0, 0..n_sh, above n_sh) as a list and the n_sh + 1 bucket
    offsets (int64, on dest's device)."""
    # bins 0 and n_sh + 2 count the destinations below and above the range
    idx = (dest.to(torch.int64) + 1).clamp(0, n_sh + 2)
    h = torch.bincount(idx, minlength=n_sh + 3).tolist()
    off = torch.zeros(n_sh + 1, dtype=torch.int64)
    off[1:] = torch.cumsum(torch.tensor(h[1:n_sh + 1], dtype=torch.int64), 0)
    return h, off.to(dest.device)


class Layout:
    """The buckets of the send buffer for one destination vector: dest
    (L,) int32 in [0, n_sh], bucket k holding exactly the sizes[k] rows
    with dest == k from row off[k] on.  On the card one K11 layout launch
    counts the rows of each tile per bucket and scans the counts into each
    tile's first position in each bucket (`tile_pos`, kept on the card);
    the bins come back in one read-back.  Each payload routed through it
    then costs one K11 scatter launch and no wait.  On the CPU,
    layout_plain."""

    def __init__(self, dest, n_sh: int):
        if dest.dtype != torch.int32 or dest.dim() != 1:
            raise ValueError("route: (L,) int32 dest expected")
        if not 1 <= n_sh <= MAX_SHARDS or dest.shape[0] >= 2 ** 31:
            raise ValueError("route: %d shards, %d rows out of range"
                             % (n_sh, dest.shape[0]))
        self.dest = dest = dest.contiguous()
        self.n_sh = n_sh
        self.tile_pos = None
        L = dest.shape[0]
        if dest.device.type == "cpu" or not L:
            h, self.off = layout_plain(dest, n_sh)
        else:
            self.tile_pos = torch.empty(-(-L // _TILE) * (n_sh + 1),
                                        dtype=torch.int32, device=dest.device)
            aux = torch.empty(3, dtype=torch.int32, device=dest.device)
            meta = torch.empty(2 * n_sh + 4, dtype=torch.int64,
                               device=dest.device)
            K_ROUTE_LAYOUT(ptr(dest), L, n_sh, ptr(self.tile_pos), ptr(aux),
                           ptr(meta))
            h = meta[:n_sh + 3].tolist()
            self.off = meta[n_sh + 3:]
        if h[0]:
            raise ValueError("route: negative destination")
        if h[-1]:
            raise ValueError("route: destination beyond n_sh = %d" % n_sh)
        self.sizes = h[1:n_sh + 1]
        self.total = sum(self.sizes)


def _check(layout, payload):
    if payload.dtype != torch.int32 or payload.dim() != 2 \
            or payload.shape[1] != layout.dest.shape[0] \
            or payload.device != layout.dest.device:
        raise ValueError("route: an (R, %d) int32 payload on %s expected, "
                         "got %s %s on %s"
                         % (layout.dest.shape[0], layout.dest.device,
                            tuple(payload.shape), payload.dtype,
                            payload.device))


def route_plain(layout, payload):
    """Plain PyTorch version of K11, the JAX recipe: a stable sort by
    destination, each row's slot from searchsorted, index_copy_ into the
    buckets."""
    _check(layout, payload)
    dest, n_sh = layout.dest, layout.n_sh
    dev = dest.device
    L = dest.shape[0]
    out = torch.zeros((layout.total, payload.shape[0]), dtype=torch.int32,
                      device=dev)
    if L == 0:
        return out
    sd, order = torch.sort(dest.to(torch.int64), stable=True)
    first = torch.searchsorted(sd, torch.arange(n_sh + 1, device=dev))
    slot = torch.arange(L, device=dev) - first[sd]
    keep = sd < n_sh
    pos = layout.off[sd[keep]] + slot[keep]
    out.index_copy_(0, pos, payload[:, order[keep]].t())
    return out


def route(layout, payload):
    """K11.  payload (R, L) int32, one column per row of layout.dest.
    Returns the send buffer (layout.total, R) int32, bucket k at rows
    layout.off[k]..; a CPU tensor runs route_plain."""
    _check(layout, payload)
    dest = layout.dest
    if dest.device.type == "cpu":
        return route_plain(layout, payload)
    payload = payload.contiguous()
    L, R, n_sh = dest.shape[0], payload.shape[0], layout.n_sh
    out = torch.empty((layout.total, R), dtype=torch.int32,
                      device=dest.device)
    if L:
        K_ROUTE(ptr(dest), L, ptr(payload), R, n_sh, ptr(layout.tile_pos),
                ptr(out))
    return out
