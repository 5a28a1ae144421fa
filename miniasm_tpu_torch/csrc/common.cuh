// Shared helpers for the miniasm_tpu_torch kernels.
//
// The JAX programs these kernels port compute in int32 with two's-
// complement wraparound (XLA semantics); signed overflow is undefined in
// C++, so every add/sub/shift that can wrap goes through uint32_t.
#pragma once

#include <cstdint>
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
// K13 (select.cu), K16 (compact.cu) and K19 (select.cu).
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
