"""ctypes wrappers for the native PAF loaders, and the device side of the
main path's streamed loader (CUDA kernels K9 decode3 and K10 unpack4,
csrc/loader.cu).

pafmt.cpp (main path): reader and parser threads tokenize, filter and
intern in C++ while the caller pulls pieces of globalized records into a
small ring of pinned staging buffers, filled in place.  Each filled
piece is copied to the card on a side stream and decoded there at once
while the parser fills the next; at stream end one K10 launch places
every piece into the exact-size (7, n) int32 colmat [qid qs qe tid ts
te flags] (flags bit0=valid bit1=rev bit2=iden_ok) that the select step
takes.
The piece format follows the JAX loader's ladder (pafload.py:597-699):

  FMT3  13.5 B a record: 3 coordinate rows [tid, qs<<16|qe, ts<<16|te],
        flag nibbles and a qid run-length sideband; K9 decodes it to the
        4-row layout.  Used while the stream stays query-grouped with
        16-bit coordinates and 28-bit ids.
  4-row [qid|flags<<28, tid, qs<<16|qe, ts<<16|te]; K10 unpacks it into
        the colmat.  After a sideband overflow (an ungrouped stream), or
        from the start under MINIASM_TPU_FMT3=0 (a test hook).
  7-row the colmat's own layout, copied into its slice by K10's launch.
        After a coordinate or id overflow.

At a switch the parser's filled prefix is cut to its real records and
converted on the host (_fmt3_to_cols), so colmat columns stay aligned
with the C++ g_* arrays that arc_ranks and print_paf address.  On the
CPU the same ladder runs through the kernels' plain versions.

pafread.cpp: one single-threaded pass to the filtered records' SoA
columns on the host (`load_paf_native`, the staged path), and the v2
loader over it (`load_hits_v2`, the main path under
MINIASM_TPU_LOADER=v2): the (7, n) colmat and the exact rank table built
on the host, then one pinned copy to the card, with no K9/K10."""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ...cuda import I32, I64, P, Kernel, ptr
from ...utils import timers
from ...utils.u32 import as_i32
from ..seqdict import SeqDict

_CHUNK = 1 << 19  # records per piece for large inputs
_RING = 3  # pinned staging buffers the parser fills in turn

# _decode3_body (pafload.py:267), run per piece by _decode3_jit (l.249)
# and over the stream by _decode3_concat_jit (l.292)
K_DECODE3 = Kernel("decode3", "loader.cu", "ma_decode3", [P, I64, P],
                   replaces="miniasm_tpu/io/native/pafload.py:267")
# _unpack4_jit (pafload.py:344) with the piece concatenation of
# _concat_jit (l.239): every piece of a load in one launch
K_UNPACK4 = Kernel("unpack4", "loader.cu", "ma_unpack4", [P, I32, P, I64],
                   replaces="miniasm_tpu/io/native/pafload.py:344")
UNPACK4_MAX = 112  # pieces one launch takes (loader.cu U4_MAX)


def fmt3_records(words: int) -> int:
    """Records of a flat FMT3 piece of `words` int32 words (3n + 3n/8)."""
    return words * 8 // 27


def decode3_plain(flat):
    """Plain PyTorch version of K9: one flat FMT3 piece -> (4, n) int32
    [qid|flags<<28, tid, qs<<16|qe, ts<<16|te].  A record's qid is the qid
    of the last run start at or before it, 0 before the first; the run
    starts' valid prefix is ascending and their tail is -1."""
    n = fmt3_records(flat.shape[0])
    m = n // 8
    dev = flat.device
    rows = flat[:3 * n].view(3, n)
    fw = flat[3 * n:3 * n + m].to(torch.int64) & 0xFFFFFFFF
    shifts = 4 * torch.arange(8, dtype=torch.int64, device=dev)
    nib = ((fw[:, None] >> shifts[None, :]) & 0xF).reshape(n)
    bp = flat[3 * n + m:3 * n + 2 * m]
    bq = flat[3 * n + 2 * m:3 * n + 3 * m]
    k = int((bp >= 0).sum())
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    j = torch.searchsorted(bp[:k].contiguous(), idx, right=True)
    qid = torch.where(j > 0, bq[(j - 1).clamp(min=0)], 0).to(torch.int64)
    w0 = as_i32((qid & 0xFFFFFFFF) | (nib << 28))
    return torch.stack([w0, rows[0], rows[1], rows[2]])


def decode3(flat):
    """K9.  flat: one FMT3 piece, (3n + 3n/8,) int32 with n a multiple of
    16.  Returns (4, n) int32; a CPU tensor runs decode3_plain."""
    if flat.device.type == "cpu":
        return decode3_plain(flat)
    n = fmt3_records(flat.shape[0])
    if flat.dtype != torch.int32 or flat.dim() != 1 or n % 16 \
            or flat.shape[0] != 3 * n + 3 * (n // 8):
        raise ValueError("decode3: a flat int32 FMT3 piece expected")
    if flat.data_ptr() % 16:
        # the kernel moves rows in 16-byte words; a new tensor is aligned
        flat = flat.clone()
    out = torch.empty((4, n), dtype=torch.int32, device=flat.device)
    if n:
        K_DECODE3(ptr(flat), n, ptr(out))
    return out


def unpack4_plain(packed):
    """Plain PyTorch version of K10: (4, n) packed -> (7, n) int32
    [qid qs qe tid ts te flags]."""
    w0 = packed[0].to(torch.int64) & 0xFFFFFFFF
    qsqe = packed[2].to(torch.int64) & 0xFFFFFFFF
    tste = packed[3].to(torch.int64) & 0xFFFFFFFF
    i32 = torch.int32
    return torch.stack([(w0 & 0x0FFFFFFF).to(i32), (qsqe >> 16).to(i32),
                        (qsqe & 0xFFFF).to(i32), packed[1],
                        (tste >> 16).to(i32), (tste & 0xFFFF).to(i32),
                        (w0 >> 28).to(i32)])


def unpack4_pieces_plain(pieces, out=None):
    """Plain PyTorch version of K10 over a load's pieces (see unpack4)."""
    total = sum(n for _d, n in pieces)
    if out is None:
        out = torch.empty((7, total), dtype=torch.int32,
                          device=pieces[0][0].device if pieces else "cpu")
    col = 0
    for d, n in pieces:
        out[:, col:col + n] = (unpack4_plain(d[:, :n]) if d.shape[0] == 4
                               else d[:, :n])
        col += n
    return out


def unpack4(pieces, out=None):
    """K10.  pieces: (int32 tensor (4 or 7, m), n) pairs, n <= m the real
    records of each.  Writes them one after another into the (7, N) int32
    colmat `out` from column 0 (default a new (7, sum n) tensor): a 4-row
    piece unpacked, a 7-row piece copied.  Returns `out`.  One launch per
    UNPACK4_MAX pieces; CPU tensors run unpack4_pieces_plain."""
    pieces = [(d, int(n)) for d, n in pieces if n]
    total = sum(n for _d, n in pieces)
    if not pieces or pieces[0][0].device.type == "cpu":
        return unpack4_pieces_plain(pieces, out)
    if out is None:
        out = torch.empty((7, total), dtype=torch.int32,
                          device=pieces[0][0].device)
    if out.dtype != torch.int32 or out.dim() != 2 or out.shape[0] != 7 \
            or out.shape[1] < total:
        raise ValueError("unpack4: a (7, N) int32 colmat of at least %d "
                         "columns expected" % total)
    desc = np.empty((len(pieces), 5), dtype=np.int64)
    col = 0
    for i, (d, n) in enumerate(pieces):
        if d.dtype != torch.int32 or d.dim() != 2 \
                or d.shape[0] not in (4, 7) or not 0 < n <= d.shape[1]:
            raise ValueError("unpack4: (4 or 7, m) int32 pieces of at most "
                             "m records expected")
        desc[i] = (ptr(d), d.shape[0], d.shape[1], n, col)
        col += n
    dst = ptr(out)
    for i in range(0, len(pieces), UNPACK4_MAX):
        chunk = desc[i:i + UNPACK4_MAX]
        K_UNPACK4(chunk.ctypes.data, len(chunk), dst, out.shape[1])
    return out


class _MaMtInfo(ctypes.Structure):
    _fields_ = [
        ("n_orig", ctypes.c_int64),
        ("n_mirror", ctypes.c_int64),
        ("n_seq", ctypes.c_int64),
        ("n_lines", ctypes.c_int64),
        ("max_len", ctypes.c_int64),
        ("names_bytes", ctypes.c_int64),
    ]


def _bind(lib):
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ma_mt_begin.restype = ctypes.c_void_p
    lib.ma_mt_begin.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_char_p,
                                ctypes.c_int64, ctypes.c_int,
                                ctypes.c_double, ctypes.c_int64,
                                ctypes.c_int, ctypes.c_int64]
    for f in (lib.ma_mt_next, lib.ma_mt_next4, lib.ma_mt_next3):
        f.restype = ctypes.c_int64
        f.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int64]
    for f in (lib.ma_mt_pack_failed, lib.ma_mt_rle_failed):
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p]
    lib.ma_mt_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(_MaMtInfo)]
    lib.ma_mt_names.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ma_mt_seq_len.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_uint32)]
    lib.ma_mt_rank.argtypes = [ctypes.c_void_p]
    lib.ma_mt_rank_fetch.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int64),
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_int64)]
    lib.ma_mt_retain_full.argtypes = [ctypes.c_void_p]
    lib.ma_mt_seed_carry.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.ma_mt_print_paf.restype = ctypes.c_int64
    lib.ma_mt_print_paf.argtypes = [ctypes.c_void_p, i32p, i32p, u8p, i32p,
                                    i32p, u8p, u8p, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int]
    lib.ma_mt_free.argtypes = [ctypes.c_void_p]


class HitsMt:
    """Handle over the loader state: read names and lengths, the lazily
    built exact radix permutation of the implied mirrored hit array
    (hit.c:100/ksort.h) for the rare exact-rank order fallback, and the
    -p paf replay over the retained records."""

    def __init__(self, lib, res, cap):
        self._lib = lib
        self._res = res
        self.cap = cap
        self._ranked = False
        info = _MaMtInfo()
        lib.ma_mt_info(res, ctypes.byref(info))
        self.n_orig = int(info.n_orig)
        self.n_mirror = int(info.n_mirror)
        self.n_lines = int(info.n_lines)
        self.max_len = int(info.max_len)
        self._n_seq = int(info.n_seq)
        self._names_bytes = int(info.names_bytes)

    def build_rank(self):
        """CPU-bound exact-permutation build."""
        if not self._ranked:
            self._lib.ma_mt_rank(self._res)
            self._ranked = True

    def arc_ranks(self, idx):
        """Map kernel arc indices (j for q-side rows, cap+j for mirrors)
        to positions in the reference's sorted mirrored hit array."""
        self.build_rank()
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        out = np.empty(idx.shape[0], dtype=np.int64)
        self._lib.ma_mt_rank_fetch(
            self._res, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            idx.shape[0], self.cap,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return out

    def print_paf(self, sub1, sub2, alive, min_span, max_hang_flt,
                  min_ovlp_flt, fd):
        """-p paf on the main path: replay the cut and filter passes over
        the retained records in the exact sorted mirrored order and write
        the print_hits (main.c:21-30) lines of the survivors to fd.
        sub1/sub2 are the per-read (s, e, del) tables of the two passes
        (select_build2 with paf_tables=True); the loader must have been
        opened with retain_full=True.  Returns the lines printed, or -1
        when a write failed."""
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        s1, e1, d1 = (np.ascontiguousarray(x, t) for x, t in
                      zip(sub1, (np.int32, np.int32, np.uint8)))
        s2, e2, d2 = (np.ascontiguousarray(x, t) for x, t in
                      zip(sub2, (np.int32, np.int32, np.uint8)))
        al = np.ascontiguousarray(alive, np.uint8)
        return int(self._lib.ma_mt_print_paf(
            self._res, s1.ctypes.data_as(i32p), e1.ctypes.data_as(i32p),
            d1.ctypes.data_as(u8p), s2.ctypes.data_as(i32p),
            e2.ctypes.data_as(i32p), d2.ctypes.data_as(u8p),
            al.ctypes.data_as(u8p), int(min_span), int(max_hang_flt),
            int(min_ovlp_flt), int(fd)))

    def seqdict(self):
        blob = ctypes.create_string_buffer(max(self._names_bytes, 1))
        self._lib.ma_mt_names(self._res, blob)
        names = (blob.raw[:self._names_bytes].decode("latin-1")
                 .split("\0")[:self._n_seq])
        lens = np.empty(max(self._n_seq, 1), dtype=np.uint32)
        self._lib.ma_mt_seq_len(
            self._res, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        return SeqDict.from_arrays(names, lens[:self._n_seq].tolist())

    def free(self):
        if self._res:
            self._lib.ma_mt_free(self._res)
            self._res = None

    def __del__(self):
        self.free()


def _excl_blob(excl) -> bytes:
    """The NUL-separated names of an exclusion SeqDict (-R), as the C++
    loaders take them."""
    if excl is None or not excl.n_seq:
        return b""
    return b"\0".join(n.encode() for n in excl.names) + b"\0"


def _fmt3_to_cols(buf, sz, n, rows):
    """Host conversion of the first n records of a flat FMT3 piece of
    capacity sz (numpy int32 words) to a (rows, n) piece: 4 = the packed
    layout, 7 = the colmat's.  Runs at a format switch only."""
    r = buf[:3 * sz].reshape(3, sz)[:, :n]
    nw = buf[3 * sz:3 * sz + sz // 8].astype(np.uint32)
    idx = np.arange(n)
    nib = ((nw[idx >> 3] >> (4 * (idx & 7)).astype(np.uint32))
           & 0xF).astype(np.uint32)
    bp = buf[3 * sz + sz // 8: 3 * sz + 2 * (sz // 8)]
    bq = buf[3 * sz + 2 * (sz // 8): 3 * sz + 3 * (sz // 8)]
    k = bp[bp >= 0]
    v = bq[:len(k)]
    j = np.searchsorted(k, idx, side="right") - 1
    qid = v[j] if len(k) else np.zeros(n, np.int32)
    if rows == 4:
        w0 = qid.astype(np.uint32) | (nib << 28)
        return np.stack([w0.astype(np.int32), r[0], r[1], r[2]])
    qsqe = r[1].astype(np.uint32)
    tste = r[2].astype(np.uint32)
    return np.stack([qid.astype(np.int32),
                     (qsqe >> 16).astype(np.int32),
                     (qsqe & 0xFFFF).astype(np.int32),
                     r[0],
                     (tste >> 16).astype(np.int32),
                     (tste & 0xFFFF).astype(np.int32),
                     nib.astype(np.int32)])


class _Uploader:
    """Host pieces to `dev`.  On a card: a ring of pinned staging buffers
    the parser fills in place; each filled piece is copied on a side
    stream and an FMT3 piece decoded there at once (K9), and a buffer is
    refilled only after its copy has finished.  On the CPU: a fresh
    buffer per piece and the plain decode.  Counts the pieces and the
    bytes copied to the card."""

    def __init__(self, dev, words):
        self.dev = dev
        self.cuda = dev.type == "cuda"
        self.words = words
        self.pieces = []  # (device tensor (4 or 7, m), real records)
        self.n_pieces = self.bytes_up = 0
        if self.cuda:
            self.side = torch.cuda.Stream(dev)
            self.ring = [torch.empty(words, dtype=torch.int32,
                                     pin_memory=True) for _ in range(_RING)]
            self.done = [None] * _RING
        self.turn = 0

    def buffer(self):
        """The next staging buffer, free to fill."""
        if not self.cuda:
            return torch.empty(self.words, dtype=torch.int32)
        i = self.turn % _RING
        if self.done[i] is not None:
            with timers.span("ring_wait"):
                self.done[i].synchronize()
        return self.ring[i]

    def push(self, host, n, fmt3=False):
        """Send a filled piece: `host` is the flat FMT3 words (fmt3) or a
        (rows, m) int32 tensor with n real records.  On a card its copy
        and an FMT3 piece's K9 are enqueued on the side stream."""
        with timers.span("push"):
            self.n_pieces += 1
            if not self.cuda:
                self.pieces.append((decode3(host) if fmt3 else host, n))
                return
            self.bytes_up += host.numel() * host.element_size()
            with torch.cuda.stream(self.side):
                d = torch.empty(host.shape, dtype=torch.int32,
                                device=self.dev)
                d.copy_(host, non_blocking=True)
                i = self.turn % _RING
                if host.data_ptr() == self.ring[i].data_ptr():
                    ev = torch.cuda.Event()
                    ev.record(self.side)
                    self.done[i] = ev
                    self.turn += 1
                if fmt3:
                    d = decode3(d)
            self.pieces.append((d, n))

    def colmat(self):
        """The exact-size (7, n) colmat of every piece, on the caller's
        stream."""
        with timers.span("colmat"):
            if self.cuda:
                main = torch.cuda.current_stream(self.dev)
                main.wait_stream(self.side)
                for d, _n in self.pieces:
                    d.record_stream(main)
            total = sum(n for _d, n in self.pieces)
            out = torch.empty((7, total), dtype=torch.int32, device=self.dev)
            unpack4(self.pieces, out)
            self.pieces = []
            return out


def load_hits_mt(fn, min_span, min_match, *, excl=None, bi_dir=True,
                 min_iden=0.05, device=torch.device("cpu"), n_workers=2,
                 retain_full=False, carry_seed=None, upload=True):
    """Parse `fn` with the pipelined loader and build the (7, n) int32
    colmat of the unmirrored originals on `device` through the format
    ladder above; lines naming a read of `excl` are dropped.  With
    upload=False the colmat stays on the host whatever `device`, parsed
    straight into 7-row pieces (nothing to decode), as the host-side
    consumers want it (the sharded paths partition it by owner first).
    With retain_full the C++ state keeps every column for HitsMt.print_paf.
    carry_seed is the bl a leading 10-field line takes (the file is a byte
    range of a larger PAF: the bl of the last 11-field line before it).
    Returns (colmat, SeqDict, HitsMt)."""
    from .build import get_lib

    lib = get_lib()
    _bind(lib)
    try:
        fsz = os.path.getsize(fn) if fn != "-" else 0
    except OSError:
        fsz = 0
    if fn.endswith(".gz"):
        fsz *= 4
    # PAF lines are ~70-90 B: small inputs ride quarter-size pieces
    sz = _CHUNK if fsz == 0 or fsz // 100 >= (1 << 22) else _CHUNK >> 2
    blob = _excl_blob(excl)
    res = lib.ma_mt_begin(fn.encode(), min_span, min_match, blob, len(blob),
                          1 if bi_dir else 0, float(min_iden), sz,
                          n_workers, 0)
    if not res:
        raise FileNotFoundError(2, "could not open PAF file", fn)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f3_words = 3 * sz + 3 * (sz // 8)
    try:
        if carry_seed is not None:
            # before the first piece is pulled (paf.c:56-60 across a split)
            lib.ma_mt_seed_carry(res, int(carry_seed))
        if retain_full:
            lib.ma_mt_retain_full(res)
        # ring: the side stream and the pinned ring (a process's first
        # run on the card makes its CUDA context here)
        with timers.span("ring"):
            up = _Uploader(torch.device(device if upload else "cpu"), 7 * sz)
        fmt = 4 if os.environ.get("MINIASM_TPU_FMT3") == "0" else 3
        if not upload:
            fmt = 7
        switches = 0
        while True:
            buf = up.buffer()
            p = ctypes.cast(buf.data_ptr(), i32p)
            if fmt == 3:
                # parse_wait: the host waits for the parser's next piece
                with timers.span("parse_wait"):
                    n = lib.ma_mt_next3(res, p, sz)
                pf = bool(lib.ma_mt_pack_failed(res))
                if pf or lib.ma_mt_rle_failed(res):
                    # cut the filled prefix to its real records and
                    # convert it on the host to the next format
                    fmt = 7 if pf else 4
                    switches += 1
                    if n:
                        cols = _fmt3_to_cols(buf.numpy(), sz, n, fmt)
                        up.push(torch.from_numpy(cols), n)
                    continue
                if n:
                    up.push(buf[:f3_words], n, fmt3=True)
            else:
                fn_next = lib.ma_mt_next4 if fmt == 4 else lib.ma_mt_next
                with timers.span("parse_wait"):
                    n = fn_next(res, p, sz)
                switched = fmt == 4 and bool(lib.ma_mt_pack_failed(res))
                if n:
                    up.push(buf[:fmt * sz].view(fmt, sz), n)
                if switched:
                    fmt = 7
                    switches += 1
                    continue
            if n < sz:
                break
        colmat = up.colmat()
        h = HitsMt(lib, res, cap=colmat.shape[1])
    except BaseException:
        lib.ma_mt_free(res)
        raise
    if h.n_orig != h.cap:
        raise RuntimeError("loader: %d records in the colmat, %d parsed"
                           % (h.cap, h.n_orig))
    timers.count("load.pieces", up.n_pieces)
    timers.count("load.records", h.n_orig)
    timers.count("load.bytes_up", up.bytes_up)
    timers.count("load.format_switches", switches)
    with timers.span("seqdict"):
        d = h.seqdict()
    return colmat, d, h


class _MaPafLoad(ctypes.Structure):
    _fields_ = [
        ("n_rec", ctypes.c_int64),
        ("n_seq", ctypes.c_int64),
        ("n_lines", ctypes.c_int64),
        ("names_bytes", ctypes.c_int64),
        ("qid", ctypes.POINTER(ctypes.c_int32)),
        ("qs", ctypes.POINTER(ctypes.c_uint32)),
        ("qe", ctypes.POINTER(ctypes.c_uint32)),
        ("tid", ctypes.POINTER(ctypes.c_int32)),
        ("ts", ctypes.POINTER(ctypes.c_uint32)),
        ("te", ctypes.POINTER(ctypes.c_uint32)),
        ("ml", ctypes.POINTER(ctypes.c_uint32)),
        ("bl", ctypes.POINTER(ctypes.c_uint32)),
        ("rev", ctypes.POINTER(ctypes.c_uint8)),
        ("seq_len", ctypes.POINTER(ctypes.c_uint32)),
        ("names", ctypes.POINTER(ctypes.c_char)),
    ]


def _arr(ptr, n, dtype):
    if n == 0:
        return np.zeros(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def load_paf_native(fn, min_span, min_match, excl=None):
    """Load, filter and intern `fn` with ma_paf_load (pafread.cpp) into a
    PafLoad of host columns; lines naming a read of `excl` are dropped."""
    from ..paf import PafLoad
    from .build import get_lib

    lib = get_lib()
    lib.ma_paf_load.restype = ctypes.POINTER(_MaPafLoad)
    lib.ma_paf_load.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_char_p,
                                ctypes.c_int64]
    lib.ma_paf_free.argtypes = [ctypes.POINTER(_MaPafLoad)]
    blob = _excl_blob(excl)
    res = lib.ma_paf_load(fn.encode(), min_span, min_match, blob, len(blob))
    if not res:
        raise FileNotFoundError(2, "could not open PAF file", fn)
    try:
        r = res.contents
        n = int(r.n_rec)
        ns = int(r.n_seq)
        names_blob = ctypes.string_at(r.names, int(r.names_bytes))
        names = names_blob.decode("latin-1").split("\0")[:ns]
        d = SeqDict.from_arrays(names, _arr(r.seq_len, ns, np.uint32).tolist())
        return PafLoad(
            qid=_arr(r.qid, n, np.int32), qs=_arr(r.qs, n, np.uint32),
            qe=_arr(r.qe, n, np.uint32), tid=_arr(r.tid, n, np.int32),
            ts=_arr(r.ts, n, np.uint32), te=_arr(r.te, n, np.uint32),
            ml=_arr(r.ml, n, np.uint32), bl=_arr(r.bl, n, np.uint32),
            rev=_arr(r.rev, n, np.uint8), d=d, n_lines=int(r.n_lines))
    finally:
        lib.ma_paf_free(res)


class _MaHits3(ctypes.Structure):
    _fields_ = [
        ("n_orig", ctypes.c_int64),
        ("n_mirror", ctypes.c_int64),
        ("n_seq", ctypes.c_int64),
        ("n_lines", ctypes.c_int64),
        ("names_bytes", ctypes.c_int64),
        ("max_len", ctypes.c_int64),
        ("colmat", ctypes.POINTER(ctypes.c_int32)),
        ("rank", ctypes.POINTER(ctypes.c_int64)),
        ("seq_len", ctypes.POINTER(ctypes.c_uint32)),
        ("names", ctypes.POINTER(ctypes.c_char)),
        ("raw", ctypes.c_void_p),
        ("bi_dir", ctypes.c_int64),
    ]


class HitsV2:
    """Handle over the v2 loader's result (ma_paf_load_hits3): the host
    colmat of the unmirrored originals in parse order, and the lazily
    built exact rank table of the implied mirrored array (hit.c:100,
    ksort.h).  The interface of HitsMt that the main path uses."""

    def __init__(self, lib, res):
        self._lib = lib
        self._res = res
        r = res.contents
        self.n_orig = int(r.n_orig)
        self.n_mirror = int(r.n_mirror)
        self.n_lines = int(r.n_lines)
        self.max_len = int(r.max_len)
        self._ranked = False

    def colmat(self):
        """The (7, n_orig) int32 columns [qid qs qe tid ts te flags], a
        numpy view over the native buffer (copy before free)."""
        return np.ctypeslib.as_array(self._res.contents.colmat,
                                     shape=(7, self.n_orig))

    def build_rank(self):
        """CPU-bound exact-permutation build."""
        if not self._ranked:
            self._lib.ma_hits3_rank(self._res)
            self._ranked = True

    def arc_ranks(self, idx):
        """Map select arc indices (j for q-side rows, n_orig + j for
        mirrors, as select_build2 numbers them) to positions in the
        reference's sorted mirrored hit array.  The rank table is indexed
        (j<<1)|side."""
        self.build_rank()
        idx = np.asarray(idx, dtype=np.int64)
        rank = np.ctypeslib.as_array(self._res.contents.rank,
                                     shape=(2 * self.n_orig,))
        side = (idx >= self.n_orig).astype(np.int64)
        j = idx - side * self.n_orig
        return rank[(j << 1) | side]

    def seqdict(self):
        r = self._res.contents
        ns = int(r.n_seq)
        names_blob = ctypes.string_at(r.names, int(r.names_bytes))
        names = names_blob.decode("latin-1").split("\0")[:ns]
        return SeqDict.from_arrays(names, _arr(r.seq_len, ns,
                                               np.uint32).tolist())

    def free(self):
        if self._res:
            self._lib.ma_hits3_free(self._res)
            self._res = None

    def __del__(self):
        self.free()


def load_hits_v2(fn, min_span, min_match, *, excl=None, bi_dir=True,
                 min_iden=0.05, device=torch.device("cpu"), upload=True):
    """The v2 loader (JAX pafload.py:163): parse, filter and intern `fn`
    in one host pass (hit.c:70-107 without the mirror and sort), keeping
    the exact mirrored-order rank table on the host; lines naming a read
    of `excl` are dropped.  Returns (colmat, SeqDict, HitsV2): the (7, n)
    int32 colmat on `device`, one pinned copy on a card; with
    upload=False the host view HitsV2.colmat() (copy it before free)."""
    from .build import get_lib

    lib = get_lib()
    lib.ma_paf_load_hits3.restype = ctypes.POINTER(_MaHits3)
    lib.ma_paf_load_hits3.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_char_p,
                                      ctypes.c_int64, ctypes.c_int,
                                      ctypes.c_double]
    lib.ma_hits3_rank.argtypes = [ctypes.POINTER(_MaHits3)]
    lib.ma_hits3_free.argtypes = [ctypes.POINTER(_MaHits3)]
    blob = _excl_blob(excl)
    res = lib.ma_paf_load_hits3(fn.encode(), min_span, min_match, blob,
                                len(blob), 1 if bi_dir else 0,
                                float(min_iden))
    if not res:
        raise FileNotFoundError(2, "could not open PAF file", fn)
    h = HitsV2(lib, res)
    try:
        host = h.colmat()
        d = h.seqdict()
        if not upload:
            return host, d, h
        dev = torch.device(device)
        if dev.type == "cuda":
            staging = torch.empty(host.shape, dtype=torch.int32,
                                  pin_memory=True)
            staging.numpy()[:] = host
            # the caching host allocator reuses the pinned block only
            # after this copy has run
            colmat = staging.to(dev, non_blocking=True)
        else:
            colmat = torch.from_numpy(host.copy())
    except BaseException:
        h.free()
        raise
    return colmat, d, h
