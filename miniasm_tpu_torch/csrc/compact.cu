// K16 compact: a stable stream compaction of int32 columns (port of the
// compactions the JAX package runs on the host in numpy: the staged path's
// _apply_cut, pipeline.py:41-47, Hits.take, core/hits.py:50, and
// apply_contained's squeeze of the trim table and remap of the hits,
// select/contained.py:65-75).  The port keeps the staged hits on the card,
// so these run there.
//
// The columns are k rows of n int32 words, each row its own pointer (the
// caller composes a matrix from several tensors without a copy: apply_cut
// takes K5's coordinates for rows 1, 2, 4, 5 and the hits for the others;
// a matrix passes a pointer a row into it).  Column i survives where
// its keep byte is set (no keep: every column) and, with a remap mp, where
// both of its ids (rows 0 and 3) map to 0 or more; the survivors carry the
// mapped ids.  They go out in column order, as (k, m) rows of m words, m
// the survivor count, which the call also leaves in a device int64.
//
// What bounds it: the bytes (the keep byte of each column, with mp its
// two ids, read; the k words of each survivor read and written; mp's
// gathers hit L2).  A compaction's scatter needs the survivors of every
// block before it, and a count, a scan of the block counts and a scatter
// as three launches would decide every column twice and pay a serial
// scan.  So one cooperative launch (common.cuh):
//   1. each block decides each column of its chunk once: the keep bytes
//      as two 16-byte loads a lane where the pointer is 16-byte aligned,
//      else one coalesced byte a lane and a ballot a round (four rounds'
//      loads in flight together); with mp the ids' two gathers go into the
//      same ballot.  The bits stay in shared memory, a word a lane (in
//      global scratch past what shared memory holds, about 2**27
//      columns); a block counts its survivors;
//   2. one grid sync (grid_block_offsets): each block learns the
//      survivors of the blocks before it and the total m;
//   3. each block scatters its survivors at row stride m, a round of 32
//      columns of a warp at a time (the survivors of a round are
//      neighbours in every output row), 2-6 rounds' words read before
//      any is written: the rounds of a lane run one after another, so
//      their reads are made to overlap.  The kernel is built for each
//      row count k, so that those words stay in registers.
#include "common.cuh"

namespace {

constexpr int MAX_ROWS = 16;
constexpr int BATCH = 4;  // rounds a lane decides together

struct Compact {
    const int32_t* r[MAX_ROWS];
    int64_t n;
    const uint8_t* keep;  // n bytes or null
    const int32_t* mp;    // T words or null
    int64_t T;
    int J, W;
    int64_t chunk;
    int32_t* spill;  // the blocks' bits and counts, or null: shared memory
    int64_t spill_block;  // words a block there
    int32_t* bsum;  // a word a block
    int64_t* total;
    int32_t* out;
};

// bits l of the 32 keep bytes at p (16-byte aligned): byte l non-zero
__device__ __forceinline__ uint32_t keep_bits32(const uint8_t* p) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    uint32_t m = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        // 0x01 in each non-zero byte, gathered into bits 24-27
        const uint32_t nz = __vcmpne4(w[i], 0u) & 0x01010101u;
        m |= ((nz * 0x01020408u) >> 24) << (4 * i);
    }
    return m;
}

// k = K rows
template <int K>
__global__ void __launch_bounds__(COOP_THREADS)
compact_kernel(Compact p) {
    extern __shared__ int32_t smem[];
    __shared__ int32_t sh[64];
    int32_t* area = p.spill ? p.spill + blockIdx.x * p.spill_block : smem;
    uint32_t* bits = reinterpret_cast<uint32_t*>(area);  // W * THREADS
    int32_t* cnt = area + p.W * COOP_THREADS;            // W * WARPS
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int64_t slice_n = static_cast<int64_t>(p.J) * 32;
    const int64_t chunk0 = static_cast<int64_t>(blockIdx.x) * p.chunk;
    const bool vec = p.keep && !p.mp &&
                     (reinterpret_cast<uintptr_t>(p.keep) & 15) == 0;

    // ---- 1. the keep bits, each column decided once ----
    for (int s = 0; s < p.W; ++s) {
        const int64_t slice = chunk0 + (s * COOP_WARPS + w) * slice_n;
        const int64_t c0 = slice + 32 * lane;  // this lane's round
        uint32_t m = 0;
        if (lane < p.J && c0 < p.n) {
            const int64_t left = p.n - c0;
            if (!p.keep && !p.mp) {
                m = left >= 32 ? FULL : (1u << left) - 1;
            } else if (vec && left >= 32) {
                m = keep_bits32(p.keep + c0);
            } else if (vec) {
                for (int l = 0; l < left; ++l)
                    if (p.keep[c0 + l]) m |= 1u << l;
            }
        }
        if (!vec && (p.keep || p.mp)) {
            // lane l decides column l of a round, one ballot a round;
            // BATCH rounds at a time: their keep bytes and ids, then
            // the ids' remaps, are loaded together
            for (int j0 = 0; j0 < p.J; j0 += BATCH) {
                bool ok[BATCH];
                int32_t q[BATCH], t[BATCH];
#pragma unroll
                for (int u = 0; u < BATCH; ++u) {
                    const int64_t c = slice + 32 * (j0 + u) + lane;
                    ok[u] = j0 + u < p.J && c < p.n;
                    q[u] = t[u] = 0;
                    if (ok[u] && p.mp) {
                        q[u] = __ldg(p.r[0] + c);
                        t[u] = __ldg(p.r[3] + c);
                    }
                    if (ok[u] && p.keep) ok[u] = __ldg(p.keep + c) != 0;
                }
                // both remaps issued together (no short-circuit)
#pragma unroll
                for (int u = 0; u < BATCH; ++u)
                    if (ok[u] && p.mp)
                        ok[u] = (__ldg(p.mp + clamp_index(q[u], p.T)) >= 0) &
                                (__ldg(p.mp + clamp_index(t[u], p.T)) >= 0);
#pragma unroll
                for (int u = 0; u < BATCH; ++u) {
                    if (j0 + u >= p.J) break;  // the same in the whole warp
                    const uint32_t b = __ballot_sync(FULL, ok[u]);
                    if (lane == j0 + u) m = b;
                }
            }
        }
        bits[s * COOP_THREADS + threadIdx.x] = m;
        const int32_t c = __reduce_add_sync(FULL, __popc(m));
        if (lane == 0) cnt[s * COOP_WARPS + w] = c;
    }
    __syncthreads();

    // ---- 2. the slices' offsets in the block, then the blocks' ----
    const int32_t mine[1] = {block_scan_in_place(cnt, p.W * COOP_WARPS, sh)};
    int32_t before[1], total[1];
    grid_block_offsets<1>(mine, p.bsum, before, total, sh);
    const int64_t m_all = total[0];
    if (blockIdx.x == 0 && threadIdx.x == 0) *p.total = m_all;

    // ---- 3. the survivors, R rounds of a warp at a time: a lane's words
    // of R rounds are read before any is written ----
    constexpr int R = K >= 16 ? 2 : K >= 8 ? 3 : 6;
    const uint32_t lt = (1u << lane) - 1;
    for (int s = 0; s < p.W; ++s) {
        const int64_t slice = chunk0 + (s * COOP_WARPS + w) * slice_n;
        const uint32_t m = bits[s * COOP_THREADS + threadIdx.x];
        const int32_t pc = __popc(m);
        const int32_t round0 = warp_incl_sum(pc, lane) - pc;
        const int64_t base =
            static_cast<int64_t>(before[0]) + cnt[s * COOP_WARPS + w];
        for (int j0 = 0; j0 < p.J; j0 += R) {
            int32_t q[R], v[R][K];
            bool on[R];
#pragma unroll
            for (int u = 0; u < R; ++u) {
                on[u] = false;
                q[u] = 0;
                if (j0 + u < p.J) {  // the same in the whole warp
                    const uint32_t mj = __shfl_sync(FULL, m, j0 + u);
                    const int32_t oj = __shfl_sync(FULL, round0, j0 + u);
                    on[u] = (mj >> lane) & 1;
                    q[u] = oj + __popc(mj & lt);
                }
            }
#pragma unroll
            for (int u = 0; u < R; ++u)
                if (on[u]) {
                    const int64_t c = slice + 32 * (j0 + u) + lane;
#pragma unroll
                    for (int r = 0; r < K; ++r) v[u][r] = __ldg(p.r[r] + c);
                }
            if constexpr (K >= 4) {
                if (p.mp) {
#pragma unroll
                    for (int u = 0; u < R; ++u)
                        if (on[u]) {
                            v[u][0] = __ldg(p.mp + clamp_index(v[u][0], p.T));
                            v[u][3] = __ldg(p.mp + clamp_index(v[u][3], p.T));
                        }
                }
            }
#pragma unroll
            for (int u = 0; u < R; ++u)
                if (on[u]) {
#pragma unroll
                    for (int r = 0; r < K; ++r)
                        p.out[r * m_all + base + q[u]] = v[u][r];
                }
        }
    }
}

// the kernel for k rows
const void* kernel_of(int k) {
    switch (k) {
#define MA_CASE(n) \
    case n:        \
        return reinterpret_cast<const void*>(compact_kernel<n>);
        MA_CASE(1) MA_CASE(2) MA_CASE(3) MA_CASE(4) MA_CASE(5) MA_CASE(6)
        MA_CASE(7) MA_CASE(8) MA_CASE(9) MA_CASE(10) MA_CASE(11)
        MA_CASE(12) MA_CASE(13) MA_CASE(14) MA_CASE(15) MA_CASE(16)
#undef MA_CASE
    }
    return nullptr;
}

}  // namespace

// K16.  rows: a host array of k (1..16) device pointers to n int32 words
// each; keep: n bytes or null; mp: T int32 or null (then k >= 4); n at
// most 2**31 - 1.  scratch: scratch_words int32 (at least 4; the first two
// hold the survivor count m as an int64, the rest a word a block: the
// grid takes at most scratch_words - 2 blocks); spill: spill_words int32
// for the blocks' keep bits where they do not fit in shared memory, at
// least coop_spill_words(n, 1) (common.cuh); smem_cap: the most bytes of
// shared memory they may take (0: what the card allows; a smaller cap
// sends them to spill); out: k * n int32, of which the first k * m hold
// the survivors as k rows of m words.  grid: 4 host ints, the blocks
// launched, the columns a block takes, the most blocks the card holds at
// once and the spill words a block takes (0: shared memory); all 0
// without a launch (n == 0).  Fails where the card cannot launch a
// cooperative kernel.
extern "C" int ma_compact(const int32_t* const* rows, int k, int64_t n,
                          const uint8_t* keep, const int32_t* mp, int64_t T,
                          int32_t* scratch, int64_t scratch_words,
                          int32_t* spill, int64_t spill_words,
                          int64_t smem_cap, int32_t* out, int* grid,
                          cudaStream_t stream) {
    grid[0] = grid[1] = grid[2] = grid[3] = 0;
    if (k < 1 || k > MAX_ROWS || n < 0 || n > 0x7fffffff ||
        scratch_words < 4 || (mp && (k < 4 || T <= 0)))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return static_cast<int>(cudaGetLastError());
    Compact p{};
    for (int j = 0; j < k; ++j) p.r[j] = rows[j];
    p.n = n;
    p.keep = keep;
    p.mp = mp;
    p.T = T;
    p.total = reinterpret_cast<int64_t*>(scratch);
    p.bsum = scratch + 2;
    p.out = out;
    const void* kernel = kernel_of(k);
    CoopPlan plan;
    cudaError_t e = coop_plan(
        kernel, n, 1,
        static_cast<int>(std::min<int64_t>(scratch_words - 2, 1 << 30)),
        smem_cap, spill ? spill_words : 0, &plan);
    if (e != cudaSuccess) return static_cast<int>(e);
    p.J = plan.J;
    p.W = plan.W;
    p.chunk = plan.chunk;
    p.spill = plan.spill ? spill : nullptr;
    p.spill_block = plan.spill;
    grid[0] = plan.grid;
    grid[1] = static_cast<int>(plan.chunk);
    grid[2] = plan.max_grid;
    grid[3] = static_cast<int>(plan.spill);
    void* args[] = {&p};
    e = cudaLaunchCooperativeKernel(kernel, dim3(plan.grid),
                                    dim3(COOP_THREADS), args, plan.smem,
                                    stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}
