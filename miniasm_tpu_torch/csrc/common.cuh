// Shared helpers for the miniasm_tpu_torch kernels.
//
// The JAX programs these kernels port compute in int32 with two's-
// complement wraparound (XLA semantics); signed overflow is undefined in
// C++, so every add/sub/shift that can wrap goes through uint32_t.
#pragma once

#include <algorithm>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) +
                                static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) -
                                static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wshl1(int32_t a) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) << 1);
}

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int32_t warp_incl_sum(int32_t x, int lane) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int32_t y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    return x;
}

// exclusive scan of x over the block (every thread calls it, blockDim a
// multiple of 32, at most 1024); returns the threads' sum before this one
// and the block's total in *tot.  sh: 32 words of shared memory.  Used by
// K13 (select.cu), and by K16 (compact.cu) and K19 (select.cu) through
// block_scan_in_place.
__device__ __forceinline__ int32_t block_excl_scan(int32_t x, int32_t* sh,
                                                   int32_t* tot) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int32_t inc = warp_incl_sum(x, lane);
    if (lane == 31) sh[w] = inc;
    __syncthreads();
    if (w == 0) {
        const int32_t v = lane < static_cast<int>(blockDim.x >> 5) ? sh[lane]
                                                                   : 0;
        sh[lane] = warp_incl_sum(v, lane);
    }
    __syncthreads();
    const int32_t before = (w ? sh[w - 1] : 0) + inc - x;
    *tot = sh[(blockDim.x >> 5) - 1];
    __syncthreads();
    return before;
}

// ---- the stable stream compactions K16 (compact.cu) and K19 (select.cu):
// one cooperative launch each, every keep decision made once ----
//
// A block of COOP_THREADS threads owns one contiguous chunk of items.  The
// chunk is W words of the block's warps: in word s, warp w owns the slice
// of J * 32 items from chunk + (s * COOP_WARPS + w) * J * 32, and lane j of
// the warp holds the keep bits of the slice's round j (items j * 32 to
// j * 32 + 31, bit l for item j * 32 + l), made by one ballot or one
// vector load of keep bytes.  So items go in the order (s, w, j, l), the
// order of the input, and a survivor's place in its block is the survivors
// of the (s, w) slices before its own, of the rounds before its own, and of
// the lanes before its own in its round: block_scan_in_place, a warp scan
// of the lanes' popcounts, a popcount.  grid_block_offsets adds the
// survivors of the blocks before, after one grid sync.
constexpr int COOP_THREADS = 256;
constexpr int COOP_WARPS = COOP_THREADS / 32;

// exclusive scan in place of the len words a[] (shared memory), by the
// whole block; returns their total.  sh: 32 words of shared memory.
__device__ __forceinline__ int32_t block_scan_in_place(int32_t* a, int len,
                                                       int32_t* sh) {
    int32_t carry = 0;
    for (int e0 = 0; e0 < len; e0 += blockDim.x) {
        const int e = e0 + threadIdx.x;
        const int32_t x = e < len ? a[e] : 0;
        int32_t tot;
        const int32_t before = block_excl_scan(x, sh, &tot);
        if (e < len) a[e] = carry + before;
        carry += tot;
    }
    return carry;
}

// The block offsets of a cooperative launch, shared by K16 and K19: each
// block's N counts (count[], the same in every thread) go to bsum[N *
// blockIdx.x ...], the grid syncs once, and every thread learns, for each
// c < N, the counts of the blocks before its own (before[c]) and of all
// blocks (total[c]), read back through L2.  sh: 2 * N * 32 words of shared
// memory.
template <int N>
__device__ __forceinline__ void grid_block_offsets(const int32_t (&count)[N],
                                                   int32_t* bsum,
                                                   int32_t (&before)[N],
                                                   int32_t (&total)[N],
                                                   int32_t* sh) {
    if (threadIdx.x == 0)
        for (int c = 0; c < N; ++c) bsum[N * blockIdx.x + c] = count[c];
    cooperative_groups::this_grid().sync();
    int32_t b[N] = {}, t[N] = {};
#pragma unroll 4
    for (unsigned i = threadIdx.x; i < gridDim.x; i += blockDim.x)
        for (int c = 0; c < N; ++c) {
            const int32_t v = __ldcg(bsum + N * i + c);
            t[c] += v;
            if (i < blockIdx.x) b[c] += v;
        }
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    for (int c = 0; c < N; ++c) {
        b[c] = __reduce_add_sync(FULL, b[c]);
        t[c] = __reduce_add_sync(FULL, t[c]);
        if (lane == 0) {
            sh[(2 * c) * 32 + w] = b[c];
            sh[(2 * c + 1) * 32 + w] = t[c];
        }
    }
    __syncthreads();
    for (int c = 0; c < N; ++c) {
        before[c] = total[c] = 0;
        for (unsigned k = 0; k < blockDim.x / 32; ++k) {
            before[c] += sh[(2 * c) * 32 + k];
            total[c] += sh[(2 * c + 1) * 32 + k];
        }
    }
    __syncthreads();
}

// the launch of a compaction over n items (n >= 1) with `words` keep-bit
// words a thread a word s (K16 1, K19 2).  Each block keeps `words` bit
// arrays of W words a thread and `words` arrays of W * COOP_WARPS slice
// counts: words * W * (COOP_THREADS + COOP_WARPS) words, in shared memory
// where they fit (smem bytes; spill 0), else in global scratch (spill
// words a block, smem 0), so that every n a kernel accepts has a launch.
// In shared memory the grid is as many blocks as the card holds at once
// (the occupancy, with that shared memory, times the SMs, at most
// max_grid), each thread takes J <= 32 rounds of the warp's slice per
// word, W words (more than one only past 32 rounds), and the grid only
// the blocks the items need.  In global scratch a lane takes 32 rounds a
// word and the grid the card holds without dynamic shared memory.
struct CoopPlan {
    int grid, J, W, max_grid;
    int64_t chunk;  // items a block
    size_t smem;
    int64_t spill;  // words of global scratch a block
};

// the global scratch a compaction of n items may spill its bits to: at
// most grid * W * COOP_THREADS < n / 16 + 256 words a bit array, as the
// grid's chunks of W * COOP_THREADS * 32 items cover n, plus the slice
// counts (COOP_WARPS / COOP_THREADS = 1 / 32 more).  The wrappers
// (utils/compact.py, parallel/full.py) allocate this much.
static inline int64_t coop_spill_words(int64_t n, int words) {
    return words * (33 * n / 512 + 265);
}

static inline cudaError_t coop_plan(const void* kernel, int64_t n, int words,
                                    int max_grid, int64_t smem_cap,
                                    int64_t spill_words, CoopPlan* p) {
    // a block's words for one word of bits a thread
    const int64_t unit = static_cast<int64_t>(words) *
                         (COOP_THREADS + COOP_WARPS);
    int dev = 0, coop = 0, sms = 0, per_sm = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    // the kernels' static shared memory takes under 1 KB of it
    int64_t cap = static_cast<int64_t>(optin) - 1024;
    if (smem_cap > 0) cap = std::min(cap, smem_cap);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, COOP_THREADS, 4 * unit);
    // fewer blocks fit where the bits take more shared memory: shrink the
    // grid until the plan's shared memory lets it run at once
    bool spill = false;
    for (int it = 0; e == cudaSuccess; ++it) {
        if (per_sm < 1 || it > 16) {
            e = cudaErrorInvalidValue;
            break;
        }
        p->max_grid = static_cast<int>(
            std::min<int64_t>(static_cast<int64_t>(per_sm) * sms, max_grid));
        const int64_t lanes = static_cast<int64_t>(p->max_grid) * COOP_THREADS;
        const int64_t per_lane = (n + lanes - 1) / lanes;
        p->J = static_cast<int>(std::min<int64_t>(per_lane, 32));
        p->W = static_cast<int>((per_lane + 31) / 32);
        p->chunk = static_cast<int64_t>(p->W) * p->J * COOP_THREADS;
        p->grid = static_cast<int>((n + p->chunk - 1) / p->chunk);
        p->smem = static_cast<size_t>(p->W * unit * 4);
        p->spill = 0;
        if (static_cast<int64_t>(p->smem) > cap) {
            spill = true;
            break;
        }
        if (p->smem > 48 * 1024)
            e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(p->smem));
        int fit = per_sm;  // W == 1: the query above
        if (e == cudaSuccess && p->W != 1)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &fit, kernel, COOP_THREADS, p->smem);
        if (e != cudaSuccess) break;
        if (static_cast<int64_t>(fit) * sms >= p->grid) break;
        per_sm = fit;
    }
    if (e != cudaSuccess || !spill) return e;
    // the bits in global scratch
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      COOP_THREADS, 0);
    if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidValue;
    if (e != cudaSuccess) return e;
    p->max_grid = static_cast<int>(
        std::min<int64_t>(static_cast<int64_t>(per_sm) * sms, max_grid));
    const int64_t word = static_cast<int64_t>(COOP_THREADS) * 32;
    const int64_t most = static_cast<int64_t>(p->max_grid) * word;
    p->J = 32;
    p->W = static_cast<int>((n + most - 1) / most);
    p->chunk = static_cast<int64_t>(p->W) * word;
    p->grid = static_cast<int>((n + p->chunk - 1) / p->chunk);
    p->smem = 0;
    p->spill = p->W * unit;
    if (p->spill * p->grid > spill_words) return cudaErrorInvalidValue;
    return cudaSuccess;
}

// The blocks of a cooperative launch of `kernel` (blocks of `threads`
// threads with `smem` bytes of dynamic shared memory) that the card holds
// at once: the occupancy limit times the SMs, both read per call, at most
// `need` and at least 1, into *grid.  Used by K13 (select.cu) and K14
// (clean.cu).
static inline cudaError_t coop_blocks(const void* kernel, int threads,
                                      size_t smem, int64_t need, int* grid) {
    int dev = 0, coop = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (e == cudaSuccess && per_sm < 1)
        e = cudaErrorCooperativeLaunchTooLarge;
    if (e != cudaSuccess) return e;
    *grid = static_cast<int>(
        std::max<int64_t>(1, std::min<int64_t>(
                                 static_cast<int64_t>(per_sm) * sms, need)));
    return cudaSuccess;
}

// ---- warp-aggregated updates of per-read words (K12, K13: select.cu) ----
//
// Every lane of the warp calls them with K keys, its reads (a negative
// key: no update).  With RUNS, for each k the lanes of a run of equal
// keys, lanes next to each other, find each other by one shuffle and one
// ballot, and one lane of the run makes its one atomic: the loader keeps a
// query's rows together, so a warp's q-sides mostly form one or two runs,
// which per-lane atomics would serialise on one word.  Without RUNS (the
// targets, in no order) each lane makes its own.  Every shuffle names the
// whole warp: a run's mask in __match_any_sync, __reduce_max_sync or
// __shfl_sync costs more on the card than the atomics it saves.  The runs
// of all K keys come first, then the atomics, so that a lane's K atomics
// (and the loads before them) are in flight together.

// the lanes below this one
__device__ __forceinline__ unsigned lanes_below(int lane) {
    return (1u << lane) - 1u;
}

// the run of equal keys that holds this lane: its first and last lane
struct Run32 {
    int first, last;
};

__device__ __forceinline__ Run32 key_run(int32_t key, int lane) {
    const int32_t prev = __shfl_up_sync(FULL, key, 1);
    const unsigned heads = __ballot_sync(FULL, lane == 0 || prev != key);
    const unsigned upto = lane == 31 ? FULL : (2u << lane) - 1u;
    const unsigned after = heads & ~upto;  // the heads of the later runs
    return {31 - __clz(static_cast<int>(heads & upto)),
            after ? __ffs(static_cast<int>(after)) - 2 : 31};
}

// word[key] = max(word[key], the lanes' v), not where the word already
// holds at least as much (read through L2, so that no SM keeps a copy of
// a word in L1 while the words change).  A run's maximum comes to its
// last lane by a segmented scan.
template <int K, bool RUNS>
__device__ __forceinline__ void warp_max_batch(int32_t* word,
                                               const int32_t (&key)[K],
                                               const int32_t (&v)[K],
                                               int lane) {
    int32_t m[K], have[K];
    bool lead[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        m[k] = v[k];
        lead[k] = key[k] >= 0;
        if (RUNS) {
            const Run32 run = key_run(key[k], lane);
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int32_t y = __shfl_up_sync(FULL, m[k], o);
                if (lane - o >= run.first) m[k] = max(m[k], y);
            }
            lead[k] = lead[k] && lane == run.last;
        }
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
        have[k] = lead[k] ? __ldcg(word + key[k]) : 0x7fffffff;
#pragma unroll
    for (int k = 0; k < K; ++k)
        if (have[k] < m[k]) atomicMax(word + key[k], m[k]);
}

// word[key] += the lanes of key, by runs
template <int K>
__device__ __forceinline__ void warp_count_runs(int32_t* word,
                                                const int32_t (&key)[K],
                                                int lane) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const Run32 run = key_run(key[k], lane);
        if (key[k] >= 0 && lane == run.first)
            atomicAdd(word + key[k], run.last - run.first + 1);
    }
}

// cursor[key] += the lanes of key, by runs; returns the cursor before
// that plus the lanes of the run below this one: the lane's own place
__device__ __forceinline__ int32_t warp_slot(int32_t* cursor, int32_t key,
                                             int lane) {
    const Run32 run = key_run(key, lane);
    int32_t at = 0;
    if (key >= 0 && lane == run.first)
        at = atomicAdd(cursor + key, run.last - run.first + 1);
    return __shfl_sync(FULL, at, run.first) + lane - run.first;
}

// number of blocks of `threads` covering n items
static inline unsigned int n_blocks(int64_t n, int threads) {
    return static_cast<unsigned int>((n + threads - 1) / threads);
}

// hit2arc return codes (core/hit2arc.py)
constexpr int32_t MA_HT_INT = -1;
constexpr int32_t MA_HT_QCONT = -2;
constexpr int32_t MA_HT_TCONT = -3;
constexpr int32_t MA_HT_SHORT_OVLP = -4;

struct Arc {
    int32_t r, u, v, l, ol;
};

// ma_hit2arc (miniasm.h:86-104) exactly as core/hit2arc.py computes it;
// rev is 0 or 1.  Used by K1 (select.cu) and K6 (staged.cu).
__device__ __forceinline__ Arc hit2arc(int32_t qid, int32_t qs, int32_t qe,
                                       int32_t tid, int32_t ts, int32_t te,
                                       int32_t rev, int32_t ql, int32_t tl,
                                       int32_t max_hang, float int_frac,
                                       int32_t min_ovlp) {
    int32_t tl5 = rev ? wsub(tl, te) : ts;
    int32_t tl3 = rev ? ts : wsub(tl, te);
    int32_t qh5 = qs;
    int32_t qh3 = wsub(ql, qe);
    int32_t ext5 = min(qh5, tl5);
    int32_t ext3 = min(qh3, tl3);
    int32_t span = wsub(qe, qs);
    int32_t tot = wadd(wadd(span, ext5), ext3);
    bool internal = ext5 > max_hang || ext3 > max_hang ||
                    __int2float_rn(span) <
                        __fmul_rn(__int2float_rn(tot), int_frac);
    bool qcont = qh5 <= tl5 && qh3 <= tl3;
    bool tcont = qh5 >= tl5 && qh3 >= tl3;
    bool from5 = qh5 > tl5;
    int32_t l = from5 ? wsub(qh5, tl5) : wsub(qh3, tl3);
    bool shrt = tot < min_ovlp ||
                wadd(wadd(wsub(te, ts), ext5), ext3) < min_ovlp;
    int32_t r = l;
    if (shrt) r = MA_HT_SHORT_OVLP;
    if (tcont && !qcont) r = MA_HT_TCONT;
    if (qcont) r = MA_HT_QCONT;
    if (internal) r = MA_HT_INT;
    Arc a;
    a.r = r;
    a.u = wshl1(qid) | (from5 ? 0 : 1);
    a.v = wshl1(tid) | (from5 ? rev : (rev ? 0 : 1));
    a.l = l;
    a.ol = wsub(ql, l);
    return a;
}

struct Coords {
    int32_t qs, qe, ts, te;
};

// The first half of ma_hit_cut (hit.c:170-180): the strand-aware
// projection of the partner read's trim [r?_s, r?_e) onto the hit, with
// signed compares.  The clamp that follows differs between K1 (select.cu,
// signed s-side max on the main path's non-negative projections) and K5
// (staged.cu, all four clamps unsigned as select/cut.py has them).
__device__ __forceinline__ Coords cut_project(int32_t qs0, int32_t qe0,
                                              int32_t ts0, int32_t te0,
                                              bool rev, int32_t rq_s,
                                              int32_t rq_e, int32_t rt_s,
                                              int32_t rt_e) {
    Coords c;
    c.qs = rev ? (te0 < rt_e ? qs0 : wadd(qs0, wsub(te0, rt_e)))
               : (ts0 > rt_s ? qs0 : wadd(qs0, wsub(rt_s, ts0)));
    c.qe = rev ? (ts0 > rt_s ? qe0 : wsub(qe0, wsub(rt_s, ts0)))
               : (te0 < rt_e ? qe0 : wsub(qe0, wsub(te0, rt_e)));
    c.ts = rev ? (qe0 < rq_e ? ts0 : wadd(ts0, wsub(qe0, rq_e)))
               : (qs0 > rq_s ? ts0 : wadd(ts0, wsub(rq_s, qs0)));
    c.te = rev ? (qs0 > rq_s ? te0 : wsub(te0, wsub(rq_s, qs0)))
               : (qe0 < rq_e ? te0 : wsub(te0, wsub(qe0, rq_e)));
    return c;
}

// index clamped into [0, T) like an XLA gather
__device__ __forceinline__ int32_t clamp_index(int32_t i, int64_t T) {
    return min(max(i, 0), static_cast<int32_t>(T - 1));
}
