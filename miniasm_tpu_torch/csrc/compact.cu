// K16 compact: a stable stream compaction of int32 columns (port of the
// compactions the JAX package runs on the host in numpy: the staged path's
// _apply_cut, pipeline.py:41-47, Hits.take, core/hits.py:50, and
// apply_contained's squeeze of the trim table and remap of the hits,
// select/contained.py:65-75).  The port keeps the staged hits on the card,
// so these run there.
//
// The columns are k rows of n int32 words, each row its own pointer (the
// caller composes a matrix from several tensors without a copy: apply_cut
// takes K5's coordinates for rows 1, 2, 4, 5 and the hits for the others).
// Column i survives where its keep byte is set (no keep: every column) and,
// with a remap mp, where both of its ids (rows 0 and 3) map to 0 or more;
// the survivors carry the mapped ids.  They go out in column order, as
// (k, m) rows of m words, m the survivor count, which the call also leaves
// in a device int64.  The output buffer holds k * n words; the scatter reads
// m from device memory, so the host learns m only after the call.
//
// Three launches, like K13's scan (select.cu):
//   (a) count: one block of CT columns, __syncthreads_count of its keeps;
//   (b) scan: the block counts' exclusive scan in place, by one block,
//       and m;
//   (c) scatter: each block again scans its keeps (block_excl_scan,
//       common.cuh), so that survivor p of the block goes to its block's
//       offset + p: the order is the columns' order.
// What bounds it: the bytes (the keep byte and the k words of each column
// read, k words of each survivor written; mp's gathers hit L2).
#include "common.cuh"

namespace {

constexpr int CT = 1024;       // columns a block, a thread each
constexpr int MAX_ROWS = 16;

struct Rows {
    const int32_t* r[MAX_ROWS];
};

__device__ __forceinline__ bool survives(const Rows& rows,
                                         const uint8_t* __restrict__ keep,
                                         const int32_t* __restrict__ mp,
                                         int64_t T, int64_t i) {
    if (keep && !keep[i]) return false;
    if (mp) {
        const bool q = mp[clamp_index(rows.r[0][i], T)] >= 0;
        const bool t = mp[clamp_index(rows.r[3][i], T)] >= 0;
        return q && t;
    }
    return true;
}

// (a)
__global__ void __launch_bounds__(CT)
compact_count_kernel(Rows rows, int64_t n, const uint8_t* __restrict__ keep,
                     const int32_t* __restrict__ mp, int64_t T,
                     int32_t* __restrict__ bsum) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * CT + threadIdx.x;
    const int c = __syncthreads_count(i < n && survives(rows, keep, mp, T, i));
    if (threadIdx.x == 0) bsum[blockIdx.x] = c;
}

// (b)
__global__ void __launch_bounds__(CT)
compact_scan_kernel(int32_t* __restrict__ bsum, int64_t nb,
                    int64_t* __restrict__ total) {
    __shared__ int32_t sh[32];
    int32_t carry = 0;
    for (int64_t b0 = 0; b0 < nb; b0 += CT) {
        const int64_t b = b0 + threadIdx.x;
        const int32_t x = b < nb ? bsum[b] : 0;
        int32_t tot;
        const int32_t before = block_excl_scan(x, sh, &tot);
        if (b < nb) bsum[b] = carry + before;
        carry += tot;
    }
    if (threadIdx.x == 0) *total = carry;
}

// (c)
__global__ void __launch_bounds__(CT)
compact_scatter_kernel(Rows rows, int k, int64_t n,
                       const uint8_t* __restrict__ keep,
                       const int32_t* __restrict__ mp, int64_t T,
                       const int32_t* __restrict__ bsum,
                       const int64_t* __restrict__ total,
                       int32_t* __restrict__ out) {
    __shared__ int32_t sh[32];
    const int64_t i = static_cast<int64_t>(blockIdx.x) * CT + threadIdx.x;
    const bool s = i < n && survives(rows, keep, mp, T, i);
    int32_t tot;
    const int32_t before = block_excl_scan(s ? 1 : 0, sh, &tot);
    if (!s) return;
    const int64_t m = *total;
    const int64_t p = bsum[blockIdx.x] + before;
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) {
        if (r < k) {
            int32_t v = rows.r[r][i];
            if (mp && (r == 0 || r == 3)) v = mp[clamp_index(v, T)];
            out[r * m + p] = v;
        }
    }
}

}  // namespace

// K16.  rows: k (1..16) device pointers to n int32 words each (a host
// array); keep: n bytes or null; mp: T int32 or null (then k >= 4); bsum:
// ceil(n / 1024) int32 of scratch (at least one); total: one int64, the
// survivor count m; out: k * n int32, of which the first k * m hold the
// survivors as k rows of m words.
extern "C" int ma_compact(const int32_t* const* rows, int k, int64_t n,
                          const uint8_t* keep, const int32_t* mp, int64_t T,
                          int32_t* bsum, int64_t* total, int32_t* out,
                          cudaStream_t stream) {
    if (k < 1 || k > MAX_ROWS || n < 0 || n > 0x7fffffff ||
        (mp && (k < 4 || T <= 0)))
        return static_cast<int>(cudaErrorInvalidValue);
    Rows r{};
    for (int j = 0; j < k; ++j) r.r[j] = rows[j];
    const int64_t nb = (n + CT - 1) / CT;
    if (n > 0)
        compact_count_kernel<<<static_cast<unsigned>(nb), CT, 0, stream>>>(
            r, n, keep, mp, T, bsum);
    compact_scan_kernel<<<1, CT, 0, stream>>>(bsum, nb, total);
    if (n > 0)
        compact_scatter_kernel<<<static_cast<unsigned>(nb), CT, 0, stream>>>(
            r, k, n, keep, mp, T, bsum, total, out);
    return static_cast<int>(cudaGetLastError());
}
