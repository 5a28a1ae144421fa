// K11 route: bucket the rows of a payload by destination shard, for one
// all_to_all_single.  Port of the bucketing the sharded JAX programs share:
// miniasm_tpu/parallel/full.py:209-231 (the mirror-side events of each
// sweep pass, to the target read's owner) and
// miniasm_tpu/parallel/multihost.py:340-353 (repart: every row to its query
// read's owner).  JAX sorts the rows stably by destination, takes each
// row's slot = iota - first[dest], and scatters into (R, n_sh, cap).
//
// Here row i of L goes to position off[dest[i]] + (number of rows j < i
// with dest[j] == dest[i]) of the (S, R) int32 send buffer, whose buckets
// start at the caller's offsets off[0..n_sh]; rows with dest == n_sh are
// dropped.  Rows keep their order inside a bucket, as the stable sort
// keeps it.  The offsets are the prefix sums of the histogram of dest
// (parallel/route.py: Layout), so every bucket holds exactly its rows.
//
// Three launches on the caller's stream:
//   1. route_count: one block per tile of TILE rows counts its rows per
//      bucket in shared memory;
//   2. route_scan: one thread per bucket turns the tile counts into each
//      tile's first position in the bucket (a serial scan over the tiles,
//      L / TILE of them, reading the counts and writing the positions to
//      another array, so the loads need not wait for the stores);
//   3. route_scatter: one block per tile walks its rows in rounds of 256.
//      In a round each warp ranks its lanes by __match_any_sync (lanes of
//      one destination) and a popcount of the lower lanes; the warps'
//      counts per bucket, in shared memory, order the warps; a running
//      position per bucket carries the rounds.  Each routed row writes its
//      R payload words.
// Bound on the card: bytes.  It reads dest and the R payload rows once and
// writes the send buffer once, 4 (1 + 2R) bytes a row; the tile counts
// and positions are 2 (L / TILE) (n_sh + 1) words.  The serial scan and
// the per-round barriers make it latency-bound at a few hundred thousand
// rows.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROUNDS = 16;
constexpr int64_t TILE = THREADS * ROUNDS;

__global__ void route_count(const int32_t* __restrict__ dest, int64_t L,
                            int n_sh, int32_t* __restrict__ tile_cnt) {
    extern __shared__ int32_t cnt[];
    const int nb = n_sh + 1;
    for (int b = threadIdx.x; b < nb; b += THREADS) cnt[b] = 0;
    __syncthreads();
    const int64_t base = static_cast<int64_t>(blockIdx.x) * TILE;
    for (int k = 0; k < ROUNDS; ++k) {
        const int64_t i = base + k * THREADS + threadIdx.x;
        if (i < L) atomicAdd(&cnt[dest[i]], 1);
    }
    __syncthreads();
    for (int b = threadIdx.x; b < nb; b += THREADS)
        tile_cnt[static_cast<int64_t>(blockIdx.x) * nb + b] = cnt[b];
}

__global__ void route_scan(int64_t n_tiles, int n_sh,
                           const int64_t* __restrict__ off,
                           const int32_t* __restrict__ tile_cnt,
                           int32_t* __restrict__ tile_pos) {
    const int nb = n_sh + 1;
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= n_sh) return;
    int64_t run = off[b];
#pragma unroll 8
    for (int64_t t = 0; t < n_tiles; ++t) {
        tile_pos[t * nb + b] = static_cast<int32_t>(run);
        run += tile_cnt[t * nb + b];
    }
}

__global__ void route_scatter(const int32_t* __restrict__ dest, int64_t L,
                              const int32_t* __restrict__ payload, int R,
                              int n_sh, const int32_t* __restrict__ tile_pos,
                              int32_t* __restrict__ out) {
    extern __shared__ int32_t sm[];
    const int nb = n_sh + 1;
    int32_t* run = sm;            // [nb] next position of each bucket
    int32_t* wcnt = sm + nb;      // [WARPS][nb] this round's warp counts
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int b = threadIdx.x; b < nb; b += THREADS)
        run[b] = b < n_sh ? tile_pos[static_cast<int64_t>(blockIdx.x) * nb + b]
                          : 0;
    const int64_t base = static_cast<int64_t>(blockIdx.x) * TILE;
    for (int k = 0; k < ROUNDS; ++k) {
        for (int j = threadIdx.x; j < WARPS * nb; j += THREADS) wcnt[j] = 0;
        __syncthreads();
        const int64_t i = base + k * THREADS + threadIdx.x;
        const int d = i < L ? dest[i] : n_sh;
        const unsigned same = __match_any_sync(0xFFFFFFFFu, d);
        const int below = __popc(same & ((1u << lane) - 1u));
        if (below == 0) wcnt[warp * nb + d] = __popc(same);
        __syncthreads();
        if (d < n_sh) {
            int32_t pos = run[d] + below;
            for (int w = 0; w < warp; ++w) pos += wcnt[w * nb + d];
            int32_t* o = out + static_cast<int64_t>(pos) * R;
            for (int r = 0; r < R; ++r) o[r] = payload[r * L + i];
        }
        __syncthreads();
        for (int b = threadIdx.x; b < n_sh; b += THREADS) {
            int32_t s = 0;
            for (int w = 0; w < WARPS; ++w) s += wcnt[w * nb + b];
            run[b] += s;
        }
        __syncthreads();
    }
}

}  // namespace

// scratch: 2 ceil(L / 4096) (n_sh + 1) int32 words (the tile counts, then
// the tile positions); off: the n_sh + 1 bucket offsets (int64, off[n_sh]
// = S); out: (S, R) int32.
extern "C" int ma_route(const int32_t* dest, int64_t L,
                        const int32_t* payload, int R, int n_sh,
                        const int64_t* off, int32_t* scratch, int32_t* out,
                        cudaStream_t stream) {
    if (L == 0) return 0;
    const int64_t n_tiles = (L + TILE - 1) / TILE;
    const int nb = n_sh + 1;
    int32_t* tile_cnt = scratch;
    int32_t* tile_pos = scratch + n_tiles * nb;
    route_count<<<static_cast<unsigned int>(n_tiles), THREADS,
                  nb * sizeof(int32_t), stream>>>(dest, L, n_sh, tile_cnt);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    route_scan<<<n_blocks(n_sh, 128), 128, 0, stream>>>(n_tiles, n_sh, off,
                                                         tile_cnt, tile_pos);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    route_scatter<<<static_cast<unsigned int>(n_tiles), THREADS,
                    (1 + WARPS) * nb * sizeof(int32_t), stream>>>(
        dest, L, payload, R, n_sh, tile_pos, out);
    return static_cast<int>(cudaGetLastError());
}
