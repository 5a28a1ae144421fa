// Kernels of the main path's streamed loader (io/native/pafload.py).
//
// The host parser (io/native/pafmt.cpp) fills pinned staging pieces in
// the flat FMT3 layout (13.5 B a record) while the stream stays
// query-grouped with 16-bit coordinates, else in the 4-row packed layout
// (16 B); each piece is copied to the card on a side stream and decoded
// there at once, and at stream end every piece is unpacked into the
// exact-size (7, n) colmat [qid qs qe tid ts te flags] that the select
// step takes.
//
// K9 decode3 replaces miniasm_tpu/io/native/pafload.py:267 _decode3_body
// (run per piece by _decode3_jit l.249, or over the whole stream by
// _decode3_concat_jit l.292).  Input: one flat piece of n records (n a
// multiple of 16), int32 words [3n coordinate words (tid, qs<<16|qe,
// ts<<16|te) | n/8 flag-nibble words | n/8 run starts, -1 padded | n/8
// run qids].  Output: the (4, n) packed layout [qid|flags<<28, tid,
// qs<<16|qe, ts<<16|te].  A record's qid is the qid of the last run start
// at or before it (0 before the first); the run starts' valid prefix is
// ascending and their tail is -1, so "start valid and < x" holds on a
// prefix.  (The JAX program scatters run deltas and takes a cumsum; on
// such input the two agree, equal starts resolving to the last run.)
// Bound by bytes: 13.5 B read and 16 B written a record, about 1.2 us for
// a 2^17-record piece at 3.35 TB/s.
//
// A block takes a tile of D3_TILE records, a thread 8 of them (one flag
// word).  The old kernel's time went to each record's own binary search,
// about 14 dependent loads.  Here the block searches once for k0, the
// number of run starts before the tile: D3_THREADS probes a step, the
// first issued with the 16-byte loads of the coordinate rows (copied
// straight through), so a 2^17-record piece waits on one probe step and
// then on one window of 2 D3_THREADS run-table entries from the step's
// lower end, which holds k0 and the tile's run starts (a tile holding
// more, which takes equal starts, searches for each record's run).  The
// run starts inside the tile mark their position in shared memory (the
// last of equal starts marks it), and a block-wide max scan gives every
// record the last marked position at or before it.  What is left over
// the copy is two dependent L2 round trips (PERF.md, section 6).
//
// K10 unpack4 replaces pafload.py:344 _unpack4_jit (the same function
// runs inline in _select2_kernel, select/fused2.py:316-326) and the
// piece concatenation of _concat_jit (l.239) and _decode3_concat_jit:
// one launch per load writes every piece's n columns straight into the
// colmat at the piece's column offset, so no concatenation copy is
// needed.  A 4-row piece is unpacked (elementwise on unsigned words), a
// 7-row piece (after a coordinate or id overflow) copied.  Bound by
// bytes: 16 B read and 28 B written a 4-row record, 28 and 28 a 7-row
// one, about 9 us for the 691,396 records of the E. coli set.
//
// The launch of one piece (2^17 records, 5.8 MB) took twice its bound:
// its time went to the launch and to the ramp of the first loads, paid
// six times a load.  Now the pieces ride one launch: their pointers,
// widths, counts, offsets and first blocks go to the kernel as one
// struct by value (U4_MAX pieces, under the 4 KB of kernel parameters;
// a load with more launches once per full struct), a block takes a tile
// of U4_TILE records of one piece, found by a binary search of the first
// blocks, and a thread U4_PER records a U4_THREADS apart, all its loads
// issued before its stores.  Every access is a 4-byte word, neighbouring
// lanes on neighbouring words: the column offsets and the colmat's width
// are any number, so 16-byte accesses would need a scalar path beside
// them, and coalesced words keep the lines full at this size.
#include "common.cuh"

namespace {

constexpr int D3_THREADS = 128;
constexpr int D3_PER = 8;  // records a thread: the 8 nibbles of a flag word
constexpr int D3_TILE = D3_THREADS * D3_PER;

// 8 consecutive words as two 16-byte accesses (16-byte aligned: the
// tensors are, and 16 | n)
__device__ __forceinline__ void load8(const int32_t* __restrict__ src,
                                      int32_t (&v)[8]) {
    const int4 a = reinterpret_cast<const int4*>(src)[0];
    const int4 b = reinterpret_cast<const int4*>(src)[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void store8(const int32_t (&v)[8],
                                       int32_t* __restrict__ dst) {
    int4* d = reinterpret_cast<int4*>(dst);
    d[0] = make_int4(v[0], v[1], v[2], v[3]);
    d[1] = make_int4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ bool below(int32_t start, int64_t x) {
    return start >= 0 && start < x;
}

// The number of run starts that are valid and below x, knowing that the
// first lo0 are: the first index of [lo0, m) where that fails.  Every
// thread of the block calls it; each step probes D3_THREADS evenly spaced
// entries and narrows the range to the gap after the last probe that held.
__device__ int64_t runs_below(const int32_t* __restrict__ bp, int64_t lo0,
                              int64_t m, int64_t x) {
    int64_t lo = lo0, hi = m;  // the answer lies in [lo, hi]
    while (lo < hi) {
        const int64_t step = (hi - lo + D3_THREADS - 1) / D3_THREADS;
        const int64_t p = lo + (threadIdx.x + 1) * step - 1;
        const bool ok = p < hi && below(bp[p], x);
        lo += static_cast<int64_t>(__syncthreads_count(ok)) * step;
        hi = min(hi, lo + step - 1);
    }
    return lo;
}

__global__ void __launch_bounds__(D3_THREADS)
    decode3_kernel(const int32_t* __restrict__ flat, int64_t n,
                   int32_t* __restrict__ out) {
    constexpr int T = D3_THREADS;
    // mark[j]: j if a run starts at the tile's record j, else -1;
    // qid_at[j]: the qid of the last run starting there
    __shared__ __align__(16) int32_t mark[D3_TILE];
    __shared__ int32_t qid_at[D3_TILE];
    __shared__ int32_t warp_max[T / 32];
    __shared__ int32_t before;  // the qid entering the tile
    const int64_t m = n / 8;
    const uint32_t* nibw = reinterpret_cast<const uint32_t*>(flat + 3 * n);
    const int32_t* bp = flat + 3 * n + m;
    const int32_t* bq = bp + m;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t t0 = static_cast<int64_t>(blockIdx.x) * D3_TILE;
    const int64_t t1 = min(t0 + D3_TILE, n);
    const int64_t g = t0 + threadIdx.x * D3_PER;  // 8 | n: all 8 inside
    const bool mine = g < n;
    // k0, the number of run starts before the tile, lies in [lo, hi]; the
    // first probe of its search is issued with the copy's loads
    int64_t lo = 0, hi = m;
    int64_t step = (m + T - 1) / T;
    int32_t probe = -1;
    if (hi - lo >= T && (threadIdx.x + 1) * step - 1 < hi)
        probe = bp[(threadIdx.x + 1) * step - 1];
    int32_t rows[3][D3_PER];
    uint32_t nib = 0;
    if (mine) {
#pragma unroll
        for (int r = 0; r < 3; ++r) load8(flat + r * n + g, rows[r]);
        nib = nibw[g >> 3];
#pragma unroll
        for (int r = 0; r < 3; ++r) store8(rows[r], out + (r + 1) * n + g);
    }
    reinterpret_cast<int4*>(mark)[2 * threadIdx.x] = make_int4(-1, -1, -1, -1);
    reinterpret_cast<int4*>(mark)[2 * threadIdx.x + 1] =
        make_int4(-1, -1, -1, -1);
    while (hi - lo >= T) {
        lo += static_cast<int64_t>(__syncthreads_count(below(probe, t0))) *
              step;
        hi = min(hi, lo + step - 1);
        if (hi - lo >= T) {
            step = (hi - lo + T - 1) / T;
            const int64_t p = lo + (threadIdx.x + 1) * step - 1;
            probe = p < hi ? bp[p] : -1;
        }
    }
    // the window [lo, lo + 2T) holds k0 (k0 - lo < T) and the runs
    // starting in the tile after it, unless more than T - 1 do
    int32_t wp[2], wn[2], wq[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int64_t k = lo + h * T + threadIdx.x;
        wp[h] = k < m ? bp[k] : -1;
        wn[h] = k + 1 < m ? bp[k + 1] : -1;
        wq[h] = k < m ? bq[k] : 0;
    }
    const int32_t q_lo = threadIdx.x == 0 && lo > 0 ? bq[lo - 1] : 0;
    const int64_t k0 = lo + __syncthreads_count(below(wp[0], t0));
    if (k0 == lo ? threadIdx.x == 0 : lo + threadIdx.x == k0 - 1)
        before = k0 == lo ? q_lo : wq[0];
    // a run start shared by several runs is marked by the last of them
    bool in = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int64_t k = lo + h * T + threadIdx.x;
        in = k >= k0 && wp[h] >= 0 && wp[h] < t1;
        if (in && wn[h] != wp[h]) {
            mark[wp[h] - t0] = static_cast<int32_t>(wp[h] - t0);
            qid_at[wp[h] - t0] = wq[h];
        }
    }
    if (__syncthreads_or(threadIdx.x == T - 1 && in)) {
        // more run starts than the window holds (equal starts): find where
        // the tile's runs end, then each record searches [k0, k1) for the
        // last run at or before it, its 8 searches side by side
        const int64_t k1 = runs_below(bp, lo + 2 * T, m, t1);
        int64_t a[D3_PER], b[D3_PER];  // the runs at or before g + j: [k0, a)
#pragma unroll
        for (int j = 0; j < D3_PER; ++j) a[j] = k0, b[j] = k1;
        for (int64_t w = k1 - k0; w > 0; w >>= 1) {
            // no branch, so a step's 8 loads are in flight together
            int32_t v[D3_PER];
#pragma unroll
            for (int j = 0; j < D3_PER; ++j)
                v[j] = bp[min((a[j] + b[j]) >> 1, k1 - 1)];
#pragma unroll
            for (int j = 0; j < D3_PER; ++j) {
                const int64_t mid = (a[j] + b[j]) >> 1;
                const bool go = a[j] < b[j], le = v[j] <= g + j;
                a[j] = go && le ? mid + 1 : a[j];
                b[j] = go && !le ? mid : b[j];
            }
        }
        if (mine) {
#pragma unroll
            for (int j = 0; j < D3_PER; ++j) {
                const int32_t jj = static_cast<int32_t>(g - t0) + j;
                if (a[j] > k0 && bp[a[j] - 1] == g + j) {
                    mark[jj] = jj;
                    qid_at[jj] = bq[a[j] - 1];
                }
            }
        }
        __syncthreads();
    }
    // the last mark at or before each of this thread's records
    int32_t last[D3_PER];
    int32_t run = -1;
    const int4 a = reinterpret_cast<const int4*>(mark)[2 * threadIdx.x];
    const int4 b = reinterpret_cast<const int4*>(mark)[2 * threadIdx.x + 1];
    const int32_t mk[D3_PER] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < D3_PER; ++j) {
        run = max(run, mk[j]);
        last[j] = run;
    }
    int32_t x = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int32_t y = __shfl_up_sync(0xFFFFFFFFu, x, o);
        if (lane >= o) x = max(x, y);
    }
    if (lane == 31) warp_max[warp] = x;
    int32_t carry = __shfl_up_sync(0xFFFFFFFFu, x, 1);
    if (lane == 0) carry = -1;
    __syncthreads();
    for (int w = 0; w < warp; ++w) carry = max(carry, warp_max[w]);
    if (!mine) return;
    int32_t w0[D3_PER];
#pragma unroll
    for (int j = 0; j < D3_PER; ++j) {
        const int32_t p = max(carry, last[j]);
        const uint32_t qid = static_cast<uint32_t>(p >= 0 ? qid_at[p] : before);
        w0[j] = static_cast<int32_t>(qid | (((nib >> (4 * j)) & 0xFu) << 28));
    }
    store8(w0, out + g);
}

constexpr int U4_THREADS = 256;
constexpr int U4_PER = 4;  // records a thread
constexpr int U4_TILE = U4_THREADS * U4_PER;
constexpr int U4_MAX = 112;  // pieces a launch: 3,584 bytes of parameters

struct U4Piece {
    const int32_t* src;  // rows x src_cols int32, row-major
    int64_t col;         // the piece's first column in the colmat
    int32_t src_cols;
    int32_t n;           // its real records
    int32_t rows;        // 4 (packed) or 7 (the colmat's layout)
    int32_t first;       // its first block
};

struct U4Pieces {
    U4Piece p[U4_MAX];
    int32_t count;
};

__global__ void __launch_bounds__(U4_THREADS)
    unpack4_kernel(const __grid_constant__ U4Pieces ps,
                   int32_t* __restrict__ dst, int64_t dst_cols) {
    // the piece of this block: the last whose first block is at most it
    int lo = 0, hi = ps.count - 1;
    const int b = static_cast<int>(blockIdx.x);
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (ps.p[mid].first <= b) lo = mid; else hi = mid - 1;
    }
    const U4Piece& pc = ps.p[lo];
    const int64_t m = pc.src_cols;
    const int64_t j0 = static_cast<int64_t>(b - pc.first) * U4_TILE +
                       threadIdx.x;
    int32_t* d = dst + pc.col;
    if (pc.rows == 7) {
        int32_t v[U4_PER][7];
#pragma unroll
        for (int k = 0; k < U4_PER; ++k) {
            const int64_t j = j0 + k * U4_THREADS;
            if (j < pc.n)
#pragma unroll
                for (int r = 0; r < 7; ++r) v[k][r] = pc.src[r * m + j];
        }
#pragma unroll
        for (int k = 0; k < U4_PER; ++k) {
            const int64_t j = j0 + k * U4_THREADS;
            if (j < pc.n)
#pragma unroll
                for (int r = 0; r < 7; ++r) d[r * dst_cols + j] = v[k][r];
        }
        return;
    }
    uint32_t w[U4_PER][4];
#pragma unroll
    for (int k = 0; k < U4_PER; ++k) {
        const int64_t j = j0 + k * U4_THREADS;
        if (j < pc.n)
#pragma unroll
            for (int r = 0; r < 4; ++r)
                w[k][r] = static_cast<uint32_t>(pc.src[r * m + j]);
    }
#pragma unroll
    for (int k = 0; k < U4_PER; ++k) {
        const int64_t j = j0 + k * U4_THREADS;
        if (j >= pc.n) continue;
        const uint32_t w0 = w[k][0], qsqe = w[k][2], tste = w[k][3];
        int32_t* o = d + j;
        o[0] = static_cast<int32_t>(w0 & 0x0FFFFFFFu);
        o[dst_cols] = static_cast<int32_t>(qsqe >> 16);
        o[2 * dst_cols] = static_cast<int32_t>(qsqe & 0xFFFFu);
        o[3 * dst_cols] = static_cast<int32_t>(w[k][1]);
        o[4 * dst_cols] = static_cast<int32_t>(tste >> 16);
        o[5 * dst_cols] = static_cast<int32_t>(tste & 0xFFFFu);
        o[6 * dst_cols] = static_cast<int32_t>(w0 >> 28);
    }
}

}  // namespace

extern "C" int ma_decode3(const int32_t* flat, int64_t n, int32_t* out,
                          cudaStream_t stream) {
    decode3_kernel<<<n_blocks(n, D3_TILE), D3_THREADS, 0, stream>>>(flat, n,
                                                                   out);
    return static_cast<int>(cudaGetLastError());
}

// K10.  desc: count rows of 5 int64 [pointer, rows (4 or 7), src_cols,
// n, col] on the host, count in [1, U4_MAX] (pafload.py's UNPACK4_MAX),
// every n >= 1; dst (7, dst_cols) int32.  One launch.
extern "C" int ma_unpack4(const int64_t* desc, int count, int32_t* dst,
                          int64_t dst_cols, cudaStream_t stream) {
    if (count < 1 || count > U4_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    U4Pieces ps;
    ps.count = count;
    int64_t blocks = 0;
    for (int i = 0; i < count; ++i) {
        const int64_t* r = desc + 5 * i;
        if ((r[1] != 4 && r[1] != 7) || r[3] < 1 || r[3] > r[2] ||
            r[2] > INT32_MAX || r[4] < 0 || r[4] + r[3] > dst_cols)
            return static_cast<int>(cudaErrorInvalidValue);
        ps.p[i] = {reinterpret_cast<const int32_t*>(r[0]), r[4],
                   static_cast<int32_t>(r[2]), static_cast<int32_t>(r[3]),
                   static_cast<int32_t>(r[1]),
                   static_cast<int32_t>(blocks)};
        blocks += (r[3] + U4_TILE - 1) / U4_TILE;
    }
    if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    unpack4_kernel<<<static_cast<unsigned>(blocks), U4_THREADS, 0,
                     stream>>>(ps, dst, dst_cols);
    return static_cast<int>(cudaGetLastError());
}
