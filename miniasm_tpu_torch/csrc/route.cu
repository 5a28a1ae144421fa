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
// start at the offsets off[0..n_sh]; rows with dest == n_sh are dropped.
// Rows keep their order inside a bucket, as the stable sort keeps it.
//
// The work splits along what varies.  What depends on dest alone is done
// once per destination vector (parallel/route.py: Layout), by
// route_layout: one block per L_TILES tiles of TILE rows counts each
// tile's rows per bucket in shared memory (warp-aggregated atomics, with
// the rows below and above the range counted apart; the blocks fit the
// card at once at a million rows), and the last block to finish turns
// the tile counts into each tile's first position in each bucket: the
// lanes of a bucket scan the tiles in parallel segments, one block scan
// over the bucket totals gives the offsets.  It writes the bins and the
// offsets for the one read-back and keeps the tile positions on the card.
// What depends on the payload is route_scatter, the one launch a payload
// costs: one block per tile; a warp ranks each of its rows inside its
// bucket by __match_any_sync and a popcount, walking its own contiguous
// 128 rows; one shared-memory scan per tile orders the warps; the rows
// are staged in shared memory grouped by bucket and each bucket's run is
// written out contiguously, in 16-byte stores when R = 4 (the sweep
// exchange) or 8 (the worker's repartition), else word by word.
// Bound on the card: bytes.  The layout reads dest once (4 bytes a row);
// the scatter reads dest and the R payload rows once and writes the send
// buffer once, 4 (1 + 2R) bytes a row; the tile positions are
// (L / TILE) (n_sh + 1) words.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;             // a scatter block
constexpr int WARPS = THREADS / 32;
constexpr int WROUNDS = 4;               // a warp's rounds of 32 rows
constexpr int WROWS = 32 * WROUNDS;      // a warp's contiguous rows
constexpr int TILE = WARPS * WROWS;      // 1024 rows a tile
constexpr int STAGE = 8;                 // payload words a row staged at once
constexpr int L_THREADS = TILE;          // a layout block: a row a tile
constexpr int L_TILES = 4;               // the tiles a layout block counts

__device__ __forceinline__ int32_t warp_incl_sum(int32_t x, int lane,
                                                 int width = 32) {
    for (int o = 1; o < width; o <<= 1) {
        const int32_t y = __shfl_up_sync(FULL, x, o, width);
        if ((lane & (width - 1)) >= o) x += y;
    }
    return x;
}

// Exclusive prefix sums of a[0..n) in shared memory, in place, by every
// thread of a block of NT threads; returns the total.  tmp: NT / 32 words.
template <int NT>
__device__ int32_t block_excl_scan(int32_t* a, int n, int32_t* tmp) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int per = (n + NT - 1) / NT;
    const int lo = min(static_cast<int>(threadIdx.x) * per, n);
    const int hi = min(lo + per, n);
    int32_t s = 0;
    for (int i = lo; i < hi; ++i) s += a[i];
    const int32_t x = warp_incl_sum(s, lane);
    if (lane == 31) tmp[warp] = x;
    __syncthreads();
    if (warp == 0) {
        int32_t v = lane < NT / 32 ? tmp[lane] : 0;
        v = warp_incl_sum(v, lane);
        if (lane < NT / 32) tmp[lane] = v;
    }
    __syncthreads();
    int32_t run = x - s + (warp ? tmp[warp - 1] : 0);
    const int32_t total = tmp[NT / 32 - 1];
    for (int i = lo; i < hi; ++i) {
        const int32_t v = a[i];
        a[i] = run;
        run += v;
    }
    __syncthreads();
    return total;
}

// tile_pos: (n_tiles, n_sh + 1) int32, the tile counts and then, in place,
// the tiles' first positions in each routed bucket; aux: 3 int32 zeroed by
// the caller [blocks done, rows below the range, rows above it]; meta:
// int64 [n_sh + 3 bins (dest < 0, dest = 0..n_sh, dest > n_sh) | n_sh + 1
// offsets].
__global__ void __launch_bounds__(L_THREADS)
    route_layout(const int32_t* __restrict__ dest, int64_t L, int n_sh,
                 int32_t* tile_pos, int32_t* aux, int64_t* meta) {
    extern __shared__ int32_t sm[];  // [L_TILES][nb] tile counts, then totals
    __shared__ int32_t tmp[L_THREADS / 32];
    __shared__ int32_t out_of_range[2];  // rows below and above the range
    __shared__ bool is_last;
    const int nb = n_sh + 1;
    const int lane = threadIdx.x & 31;
    const int64_t n_tiles = (L + TILE - 1) / TILE;
    for (int j = threadIdx.x; j < L_TILES * nb; j += L_THREADS) sm[j] = 0;
    if (threadIdx.x < 2) out_of_range[threadIdx.x] = 0;
    __syncthreads();
    // a thread's row in each of the block's tiles: its bucket, -1 past L,
    // -2 below the range, -3 above it
    const int64_t base = static_cast<int64_t>(blockIdx.x) * L_TILES * TILE;
    int code[L_TILES];
#pragma unroll
    for (int k = 0; k < L_TILES; ++k) {
        const int64_t i = base + k * TILE + threadIdx.x;
        const int32_t d = i < L ? dest[i] : -1;
        code[k] = i >= L ? -1 : d < 0 ? -2 : d > n_sh ? -3 : d;
    }
#pragma unroll
    for (int k = 0; k < L_TILES; ++k) {
        const unsigned same = __match_any_sync(FULL, code[k]);
        if (code[k] != -1 && lane == __ffs(same) - 1)
            atomicAdd(code[k] >= 0 ? &sm[k * nb + code[k]]
                                   : &out_of_range[-2 - code[k]],
                      __popc(same));
    }
    __syncthreads();
    const int64_t first = static_cast<int64_t>(blockIdx.x) * L_TILES * nb;
    bool wrote = false;
    for (int j = threadIdx.x; j < L_TILES * nb; j += L_THREADS) {
        if (first + j < n_tiles * nb) {
            tile_pos[first + j] = sm[j];
            wrote = true;
        }
    }
    if (threadIdx.x == 0) {
        if (out_of_range[0]) atomicAdd(&aux[1], out_of_range[0]);
        if (out_of_range[1]) atomicAdd(&aux[2], out_of_range[1]);
        wrote = true;
    }
    if (wrote) __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) is_last = atomicAdd(&aux[0], 1) == gridDim.x - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();

    // the last block: W lanes a routed bucket (a power of two, all the
    // block's threads when the buckets are few), each summing a segment of
    // tiles; the dropped bucket's size is what the others leave
    int W = L_THREADS;
    while (W > 1 && n_sh * W > L_THREADS) W >>= 1;
    const int groups = L_THREADS / W;
    const int l = threadIdx.x % W;
    const int64_t seg = (n_tiles + W - 1) / W;
    const int64_t t_lo = min(l * seg, n_tiles), t_hi = min(t_lo + seg, n_tiles);
    int32_t* tot = sm;  // [nb] bucket totals, then offsets
    int32_t pre = 0;    // this lane's tiles' first position in its bucket
    for (int b0 = 0; b0 < n_sh; b0 += groups) {
        const int b = b0 + static_cast<int>(threadIdx.x) / W;
        int32_t s = 0;
        if (b < n_sh) {
#pragma unroll 16
            for (int64_t t = t_lo; t < t_hi; ++t)
                s += __ldcg(&tile_pos[t * nb + b]);
        }
        int32_t x = warp_incl_sum(s, lane, min(W, 32));
        if (W > 32) {  // a bucket spans W / 32 warps: add the earlier ones
            const int warp = threadIdx.x >> 5;
            if (lane == 31) tmp[warp] = x;
            __syncthreads();
            for (int w = warp & ~(W / 32 - 1); w < warp; ++w) x += tmp[w];
            __syncthreads();
        }
        if (b < n_sh && l == W - 1) tot[b] = x;
        if (b0 == 0) pre = x - s;  // W > 1 only when every bucket fits at once
    }
    __syncthreads();
    for (int b = threadIdx.x; b < n_sh; b += L_THREADS) meta[1 + b] = tot[b];
    __syncthreads();
    const int32_t total = block_excl_scan<L_THREADS>(tot, n_sh, tmp);
    if (threadIdx.x == 0) {
        const int32_t below = __ldcg(&aux[1]), above = __ldcg(&aux[2]);
        meta[0] = below;
        meta[nb] = L - below - above - total;
        meta[nb + 1] = above;
        meta[nb + 2 + n_sh] = total;
    }
    for (int b = threadIdx.x; b < n_sh; b += L_THREADS)
        meta[nb + 2 + b] = tot[b];
    for (int b0 = 0; b0 < n_sh; b0 += groups) {
        const int b = b0 + static_cast<int>(threadIdx.x) / W;
        if (b >= n_sh) continue;
        int32_t run = tot[b] + (b0 == 0 ? pre : 0);
#pragma unroll 16
        for (int64_t t = t_lo; t < t_hi; ++t) {
            const int32_t c = __ldcg(&tile_pos[t * nb + b]);
            tile_pos[t * nb + b] = run;
            run += c;
        }
    }
}

// the staged words of a row: a 16-byte multiple for R = 4 or 8, else odd
__host__ __device__ __forceinline__ int stage_stride(int R) {
    return R == 4 || R == 8 ? R : min(R, STAGE) | 1;
}

// V: the row's 16-byte words when R = 4 V (V = 1 or 2), else 0
template <int V>
__global__ void __launch_bounds__(THREADS)
    route_scatter(const int32_t* __restrict__ dest, int64_t L,
                  const int32_t* __restrict__ payload, int R, int n_sh,
                  const int32_t* __restrict__ tile_pos,
                  int32_t* __restrict__ out) {
    extern __shared__ __align__(16) int32_t sm[];
    __shared__ int32_t tmp[WARPS];
    const int nb = n_sh + 1;
    int32_t* stage = sm;                  // [TILE][stride] staged payload
    int32_t* drow = stage + TILE * stage_stride(R);  // [TILE] output rows
    int32_t* wcnt = drow + TILE;          // [WARPS][nb] counts, then prefixes
    int32_t* first = wcnt + WARPS * nb;   // [nb] a bucket's first staged row
    int32_t* shift = first + nb;          // [nb] its output row - staged row
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t tile = blockIdx.x;
    const int32_t my_pos = static_cast<int>(threadIdx.x) < n_sh
                               ? tile_pos[tile * nb + threadIdx.x] : 0;
    for (int j = threadIdx.x; j < WARPS * nb; j += THREADS) wcnt[j] = 0;
    const int64_t wbase = tile * TILE + warp * WROWS;
    int d[WROUNDS];
#pragma unroll
    for (int k = 0; k < WROUNDS; ++k) {
        const int64_t i = wbase + k * 32 + lane;
        d[k] = i < L ? dest[i] : n_sh;
    }
    __syncthreads();
    // each row's rank among its warp's earlier rows of its bucket
    int32_t* mine = wcnt + warp * nb;
    int32_t rank[WROUNDS];
#pragma unroll
    for (int k = 0; k < WROUNDS; ++k) {
        const unsigned same = __match_any_sync(FULL, d[k]);
        const int32_t c = mine[d[k]];
        rank[k] = c + __popc(same & ((1u << lane) - 1u));
        __syncwarp();
        if (lane == __ffs(same) - 1) mine[d[k]] = c + __popc(same);
        __syncwarp();
    }
    __syncthreads();
    // the warps' counts to their prefixes; a bucket's tile count
    for (int b = threadIdx.x; b < nb; b += THREADS) {
        int32_t run = 0;
        for (int w = 0; w < WARPS; ++w) {
            const int32_t c = wcnt[w * nb + b];
            wcnt[w * nb + b] = run;
            run += c;
        }
        first[b] = b < n_sh ? run : 0;
    }
    __syncthreads();
    const int32_t kept = block_excl_scan<THREADS>(first, n_sh, tmp);
    for (int b = threadIdx.x; b < n_sh; b += THREADS)
        shift[b] = (b == static_cast<int>(threadIdx.x)
                        ? my_pos : tile_pos[tile * nb + b]) - first[b];
    __syncthreads();
    int32_t slot[WROUNDS];  // staged row, -1 for a dropped row
#pragma unroll
    for (int k = 0; k < WROUNDS; ++k) {
        slot[k] = d[k] < n_sh ? first[d[k]] + mine[d[k]] + rank[k] : -1;
        if (slot[k] >= 0) drow[slot[k]] = slot[k] + shift[d[k]];
    }
    // R = 4 or 8: a row is 1 or 2 16-byte words, staged and stored whole;
    // else word by word through an odd stride (no bank conflicts)
    for (int r0 = 0; r0 < R; r0 += STAGE) {
        const int cw = V ? 4 * V : min(STAGE, R - r0);
        const int sw = V ? cw : stage_stride(R);
#pragma unroll
        for (int k = 0; k < WROUNDS; ++k) {
            if (slot[k] < 0) continue;
            const int64_t i = wbase + k * 32 + lane;
            const int32_t* src = payload + static_cast<int64_t>(r0) * L + i;
            if constexpr (V != 0) {
                int4* st = reinterpret_cast<int4*>(stage) + slot[k] * V;
#pragma unroll
                for (int h = 0; h < V; ++h)
                    st[h] = make_int4(src[(4 * h) * L], src[(4 * h + 1) * L],
                                      src[(4 * h + 2) * L],
                                      src[(4 * h + 3) * L]);
            } else {
                int32_t v[STAGE];
#pragma unroll
                for (int c = 0; c < STAGE; ++c)
                    if (c < cw) v[c] = src[c * L];
#pragma unroll
                for (int c = 0; c < STAGE; ++c)
                    if (c < cw) stage[slot[k] * sw + c] = v[c];
            }
        }
        __syncthreads();
        if constexpr (V != 0) {
            const int4* st = reinterpret_cast<const int4*>(stage);
            int4* o = reinterpret_cast<int4*>(out);
            for (int q = threadIdx.x; q < kept * V; q += THREADS) {
                const int j = q / V;
                o[static_cast<int64_t>(drow[j]) * V + (q - j * V)] = st[q];
            }
        } else {
            for (int q = threadIdx.x; q < kept * cw; q += THREADS) {
                const int j = q / cw;
                out[static_cast<int64_t>(drow[j]) * R + r0 + (q - j * cw)] =
                    stage[j * sw + (q - j * cw)];
            }
        }
        __syncthreads();
    }
}

template <int V>
cudaError_t launch_scatter(const int32_t* dest, int64_t L,
                           const int32_t* payload, int R, int n_sh,
                           const int32_t* tile_pos, int32_t* out,
                           size_t smem, cudaStream_t stream) {
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            route_scatter<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return e;
    }
    route_scatter<V><<<n_blocks(L, TILE), THREADS, smem, stream>>>(
        dest, L, payload, R, n_sh, tile_pos, out);
    return cudaGetLastError();
}

}  // namespace

// The layout pass: tile_pos (ceil(L / 1024), n_sh + 1) int32 and meta
// 2 n_sh + 4 int64 as route_layout writes them; aux: 3 int32 of scratch.
extern "C" int ma_route_layout(const int32_t* dest, int64_t L, int n_sh,
                               int32_t* tile_pos, int32_t* aux, int64_t* meta,
                               cudaStream_t stream) {
    if (L == 0) return 0;
    cudaError_t e = cudaMemsetAsync(aux, 0, 3 * sizeof(int32_t), stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    route_layout<<<n_blocks(L, L_TILES * TILE), L_THREADS,
                   L_TILES * (n_sh + 1) * sizeof(int32_t), stream>>>(
        dest, L, n_sh, tile_pos, aux, meta);
    return static_cast<int>(cudaGetLastError());
}

// The scatter of one (R, L) int32 payload into out (S, R) int32, a new
// (16-byte aligned) tensor, through the tile positions of the layout pass
// on the same dest.
extern "C" int ma_route(const int32_t* dest, int64_t L,
                        const int32_t* payload, int R, int n_sh,
                        const int32_t* tile_pos, int32_t* out,
                        cudaStream_t stream) {
    if (L == 0) return 0;
    const int nb = n_sh + 1;
    const size_t smem =
        (static_cast<size_t>(TILE) * (stage_stride(R) + 1) + WARPS * nb +
         2 * nb) * sizeof(int32_t);
    const cudaError_t e =
        R == 4   ? launch_scatter<1>(dest, L, payload, R, n_sh, tile_pos, out,
                                     smem, stream)
        : R == 8 ? launch_scatter<2>(dest, L, payload, R, n_sh, tile_pos, out,
                                     smem, stream)
                 : launch_scatter<0>(dest, L, payload, R, n_sh, tile_pos, out,
                                     smem, stream);
    return static_cast<int>(e);
}
