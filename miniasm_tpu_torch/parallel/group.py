"""Process groups of the sharded and multi-process paths.

The counterpart of miniasm_tpu/parallel/mesh.py:14 make_mesh.  The JAX
package lays a 1-D device mesh over the read-id axis and runs one SPMD
program across it; the port runs one process (rank) per shard and joins
them with torch.distributed:

  - `init` sets up the default process group for one rank: NCCL when the
    rank's device is a card (rank k takes cuda:{k % cards}), gloo when it
    is the CPU.  Another backend is used only when the caller names it
    (the multi-process worker names gloo to run two ranks on one card).
  - `launch(n, fn, *args)` starts n local ranks with torch.multiprocessing
    (spawn) around a file:// rendezvous in a temporary directory, so
    concurrent launches never compete for a TCP port: the counterpart of
    make_mesh(n).  NCCL refuses two ranks on one card, so asking for more
    NCCL ranks than cards raises; the backend is never switched quietly.
  - `Group` holds the rank, size, device and backend, and the collectives
    the sharded code calls.  Gloo runs them on CUDA tensors too (the
    worker's two ranks on one card).
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from ..device import ENV, get_device

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# how long a collective may wait for the other ranks
TIMEOUT = datetime.timedelta(minutes=15)
_CURRENT: list = []


def block_size(n: int, size: int) -> int:
    """Ids per shard when n ids are cut into `size` contiguous blocks
    (full.py:130): shard k owns [k * b, min((k + 1) * b, n))."""
    return -(-max(n, 1) // size)


class Group:
    """This rank's view of the default process group."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 backend: str):
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend

    def block(self, n: int, k: int | None = None):
        """(lo, hi) of shard k's (default: this rank's) block of n ids."""
        b = block_size(n, self.size)
        k = self.rank if k is None else k
        return min(k * b, n), min((k + 1) * b, n)

    # -- collectives --------------------------------------------------------

    def all_reduce(self, t, op: str = "sum"):
        """In-place all_reduce of t with op "sum" or "max"; returns t."""
        dist.all_reduce(t, op=_OPS[op])
        return t

    def all_to_all_rows(self, send, send_counts, recv_counts=None):
        """Send rows [off_k, off_k + send_counts[k]) of send (S, R) to rank
        k; returns (recv (sum(recv_counts), R), recv_counts), the received
        buckets in rank order.  recv_counts is exchanged first unless the
        caller already has it."""
        send_counts = [int(x) for x in send_counts]
        if recv_counts is None:
            sc = torch.tensor(send_counts, dtype=torch.int64,
                              device=self.device)
            rc = torch.empty_like(sc)
            dist.all_to_all_single(rc, sc)
            recv_counts = [int(x) for x in rc.tolist()]
        recv = torch.empty((sum(recv_counts),) + tuple(send.shape[1:]),
                           dtype=send.dtype, device=send.device)
        dist.all_to_all_single(recv, send, recv_counts, send_counts)
        return recv, recv_counts

    def all_gather_cols(self, t, sizes=None):
        """Gather every rank's t (..., n_k), ragged in its last dim; returns
        the list of the ranks' tensors in rank order.  `sizes` (every
        rank's n_k) skips their exchange when the caller knows them."""
        if sizes is None:
            n = torch.tensor([t.shape[-1]], dtype=torch.int64,
                             device=self.device)
            ns = [torch.empty_like(n) for _ in range(self.size)]
            dist.all_gather(ns, n)
            sizes = [int(x) for x in torch.cat(ns).tolist()]
        m = max(max(sizes), 1)
        pad = torch.zeros(tuple(t.shape[:-1]) + (m,), dtype=t.dtype,
                          device=t.device)
        pad[..., :t.shape[-1]] = t
        outs = [torch.empty_like(pad) for _ in range(self.size)]
        dist.all_gather(outs, pad)
        return [o[..., :k] for o, k in zip(outs, sizes)]

    def broadcast(self, t):
        """In-place broadcast of t from rank 0; returns t."""
        dist.broadcast(t, src=0)
        return t

    def broadcast_object(self, obj=None):
        """Rank 0's picklable obj, on every rank."""
        lst = [obj]
        dist.broadcast_object_list(lst, src=0)
        return lst[0]

    def all_gather_object(self, obj):
        """Every rank's picklable obj, in rank order."""
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def scatter_cols(self, parts=None):
        """Rank 0 holds parts, one (R, n_k) tensor per rank; returns this
        rank's part on its device."""
        head = None
        if self.rank == 0:
            if len(parts) != self.size:
                raise ValueError("scatter_cols: %d parts for %d ranks"
                                 % (len(parts), self.size))
            head = (tuple(parts[0].shape[:-1]), parts[0].dtype,
                    [int(p.shape[-1]) for p in parts])
        lead, dtype, sizes = self.broadcast_object(head)
        m = max(max(sizes), 1)
        out = torch.empty(lead + (m,), dtype=dtype, device=self.device)
        ins = []
        if self.rank == 0:
            for p in parts:
                x = torch.zeros(lead + (m,), dtype=dtype, device=self.device)
                x[..., :p.shape[-1]] = p
                ins.append(x)
        dist.scatter(out, ins if self.rank == 0 else None, src=0)
        return out[..., :sizes[self.rank]].contiguous()


def _resolve(rank: int, device, backend):
    """(device, backend) of a rank: `device` (default: the
    MINIASM_TPU_TORCH_DEVICE variable, else the card) and the backend the
    caller names, else NCCL on a card and gloo on the CPU."""
    dev = get_device(device if device is not None else os.environ.get(ENV))
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev, backend or ("nccl" if dev.type == "cuda" else "gloo")


def init(rank: int, size: int, init_method: str, *, backend=None,
         device=None) -> Group:
    """Join the default process group as `rank` of `size` (init_method:
    file://PATH or tcp://HOST:PORT) and return this rank's Group."""
    dev, be = _resolve(rank, device, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(be, init_method=init_method, world_size=size,
                            rank=rank, timeout=TIMEOUT)
    g = Group(rank, size, dev, be)
    _CURRENT[:] = [g]
    return g


def current() -> Group:
    """The Group `init` made in this process."""
    if not _CURRENT or not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "miniasm_tpu_torch.parallel.group.init first")
    return _CURRENT[0]


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    _CURRENT[:] = []


def _entry(rank, size, init_method, backend, device, fn, args):
    init(rank, size, init_method, backend=backend, device=device)
    try:
        fn(*args)
    finally:
        destroy()


def launch(n: int, fn, *args, backend=None, device=None) -> None:
    """Run fn(*args) on n local ranks, each in a spawned process that has
    joined the group (fn finds it with `current()`).  fn must be a
    module-level function.  Raises if a rank raises."""
    import torch.multiprocessing as mp

    dev, be = _resolve(0, device, backend)
    if be == "nccl" and n > torch.cuda.device_count():
        raise RuntimeError(
            "NCCL refuses two ranks on one card: %d ranks asked for, %d "
            "card(s) here; name backend='gloo' to share a card"
            % (n, torch.cuda.device_count()))
    td = tempfile.mkdtemp(prefix="miniasm_group_")
    try:
        mp.spawn(_entry, args=(n, "file://" + os.path.join(td, "rdv"), be,
                               dev.type, fn, args), nprocs=n, join=True)
    finally:
        shutil.rmtree(td, ignore_errors=True)
