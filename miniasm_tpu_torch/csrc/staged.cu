// Kernels of the staged selection path (-1, -2, -S below 5; port of the
// per-pass JAX programs that miniasm_tpu/pipeline.py:96-151 runs).
//
// Both take the hits as one (9, n) int32 matrix, rows
// [qid qs qe tid ts te ml bl rev] (uint32 columns as bit patterns), and
// run one thread per hit.  Both are bound by device-memory bytes: about
// 45 bytes a hit against a few tens of int32 operations, so about 20 us
// per pass at 1.4 M hits on an H100; the per-read tables they gather
// from are a few hundred KB and stay in L2.
//
// K5 hit_cut replaces miniasm_tpu/select/cut.py:16 (ma_hit_cut,
// hit.c:162-193).  Per hit it reads 7 words and gathers 3 table words for
// each of its two reads; it writes 4 int32 coordinates and a keep byte.
// All four clamps compare as uint32 (cut.py:51-56): the staged path's
// inputs are uint32 hit columns, so a projection may wrap below zero and
// must then lose the s-side max, unlike K1's signed s-side.
//
// K6 hit2arc replaces the hit2arc calls of select/filter.py:29,
// select/contained.py:30 and graph/asg.py:174 (ma_hit2arc,
// miniasm.h:86-104).  Per hit it reads 7 words and gathers one length for
// each read; it writes 5 int32 rows [r u v l ol].  The staged path itself
// no longer calls it (K17 and K18 classify there); the graft entry's
// forward step (eval/dryrun.py) does.
//
// K17 hit_flt replaces the whole of miniasm_tpu/select/filter.py:16
// (ma_hit_flt, hit.c:195-216) and the reductions pipeline.py:120-122 runs
// after it: per hit the trim-table lengths (wrapping int32 differences, the
// indices clamped as K6's), the alive test, hit2arc at the relaxed
// parameters (int_frac 0.5), the keep byte and dp; per block the int64 sum
// of the kept dp and one atomic add; for each kept hit the present byte
// of its query, the set flt_coverage sums the lengths of (byte stores of 1
// need no atomics).  Bound by bytes, as K6.
//
// K18 hit_marks is hit2arc with per-read byte marks, in three modes:
//   contained (select/contained.py:19): QCONT marks the query, TCONT the
//     target;
//   sg (graph/asg.py:160-190, ma_sg_gen): a reverse self-palindrome or
//     QCONT marks the query; the hit's arc-row keep byte (r >= 0, not a
//     self match) and its arc columns [u v l ol], which K16 compacts;
//   used (core/hits.py:106, ma_hit_mark_unused): qid and tid of every hit,
//     with no classification.
// Bound by bytes: 7 words a hit in (2 in the used mode), a byte mark a
// read, 4 words and a byte a hit out in the sg mode.
#include "common.cuh"

namespace {

__global__ void hit_cut_kernel(const int32_t* __restrict__ hits, int64_t n,
                               const int32_t* __restrict__ tab, int64_t T,
                               int32_t min_span, int32_t* __restrict__ out,
                               uint8_t* __restrict__ keep) {
    int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int32_t qi = clamp_index(hits[i], T), ti = clamp_index(hits[3 * n + i], T);
    int32_t rq_s = tab[qi], rq_e = tab[T + qi], rq_d = tab[2 * T + qi];
    int32_t rt_s = tab[ti], rt_e = tab[T + ti], rt_d = tab[2 * T + ti];
    bool alive = !(rq_d || rt_d);
    bool rev = hits[8 * n + i] != 0;
    Coords p = cut_project(hits[n + i], hits[2 * n + i], hits[4 * n + i],
                           hits[5 * n + i], rev, rq_s, rq_e, rt_s, rt_e);
    // unsigned clamp to the trim interval, then rebase (hit.c:181-184)
    uint32_t urqs = static_cast<uint32_t>(rq_s), urqe = static_cast<uint32_t>(rq_e);
    uint32_t urts = static_cast<uint32_t>(rt_s), urte = static_cast<uint32_t>(rt_e);
    uint32_t qs2 = max(static_cast<uint32_t>(p.qs), urqs) - urqs;
    uint32_t qe2 = min(static_cast<uint32_t>(p.qe), urqe) - urqs;
    uint32_t ts2 = max(static_cast<uint32_t>(p.ts), urts) - urts;
    uint32_t te2 = min(static_cast<uint32_t>(p.te), urte) - urts;
    // the span test on the wrapped int32 difference (hit.c:185)
    int32_t qspan = static_cast<int32_t>(qe2 - qs2);
    int32_t tspan = static_cast<int32_t>(te2 - ts2);
    out[i] = static_cast<int32_t>(qs2);
    out[n + i] = static_cast<int32_t>(qe2);
    out[2 * n + i] = static_cast<int32_t>(ts2);
    out[3 * n + i] = static_cast<int32_t>(te2);
    keep[i] = (alive && qspan >= min_span && tspan >= min_span) ? 1 : 0;
}

__global__ void hit2arc_kernel(const int32_t* __restrict__ hits, int64_t n,
                               const int32_t* __restrict__ len, int64_t T,
                               int32_t max_hang, float int_frac,
                               int32_t min_ovlp, int32_t* __restrict__ out) {
    int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int32_t q = hits[i], t = hits[3 * n + i];
    Arc a = hit2arc(q, hits[n + i], hits[2 * n + i], t, hits[4 * n + i],
                    hits[5 * n + i], hits[8 * n + i] != 0 ? 1 : 0,
                    len[clamp_index(q, T)], len[clamp_index(t, T)],
                    max_hang, int_frac, min_ovlp);
    out[i] = a.r;
    out[n + i] = a.u;
    out[2 * n + i] = a.v;
    out[3 * n + i] = a.l;
    out[4 * n + i] = a.ol;
}

__global__ void hit_flt_kernel(const int32_t* __restrict__ hits, int64_t n,
                               const int32_t* __restrict__ sub, int64_t T,
                               int32_t max_hang, int32_t min_ovlp,
                               uint8_t* __restrict__ keep,
                               int32_t* __restrict__ dp,
                               unsigned long long* __restrict__ dp_sum,
                               uint8_t* __restrict__ present) {
    __shared__ long long sh[32];
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
    long long d = 0;
    if (i < n) {
        const int32_t q = hits[i], t = hits[3 * n + i];
        const int32_t qi = clamp_index(q, T), ti = clamp_index(t, T);
        const int32_t ql = wsub(sub[T + qi], sub[qi]);
        const int32_t tl = wsub(sub[T + ti], sub[ti]);
        const bool alive = !(sub[2 * T + qi] || sub[2 * T + ti]);
        const int32_t r = hit2arc(q, hits[n + i], hits[2 * n + i], t,
                                  hits[4 * n + i], hits[5 * n + i],
                                  hits[8 * n + i] != 0 ? 1 : 0, ql, tl,
                                  max_hang, 0.5f, min_ovlp).r;
        const bool k = alive && (r >= 0 || r == MA_HT_QCONT ||
                                 r == MA_HT_TCONT);
        const int32_t v = k ? (r >= 0 ? r : (r == MA_HT_QCONT ? ql : tl)) : 0;
        keep[i] = k ? 1 : 0;
        dp[i] = v;
        if (k) present[qi] = 1;
        d = v;
    }
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) d += __shfl_down_sync(FULL, d, o);
    if (lane == 0) sh[w] = d;
    __syncthreads();
    if (threadIdx.x == 0) {
        long long s = 0;
        for (int k = 0; k < static_cast<int>(blockDim.x >> 5); ++k) s += sh[k];
        if (s) atomicAdd(dp_sum, static_cast<unsigned long long>(s));
    }
}

constexpr int MARK_CONTAINED = 0, MARK_SG = 1, MARK_USED = 2;

__global__ void hit_marks_kernel(const int32_t* __restrict__ hits, int64_t n,
                                 const int32_t* __restrict__ len, int64_t T,
                                 int32_t max_hang, float int_frac,
                                 int32_t min_ovlp, int mode,
                                 uint8_t* __restrict__ mark,
                                 uint8_t* __restrict__ keep,
                                 int32_t* __restrict__ arcs) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
    if (i >= n) return;
    const int32_t q = hits[i], t = hits[3 * n + i];
    const int32_t qi = clamp_index(q, T), ti = clamp_index(t, T);
    if (mode == MARK_USED) {
        mark[qi] = 1;
        mark[ti] = 1;
        return;
    }
    const int32_t qs = hits[n + i], qe = hits[2 * n + i];
    const int32_t ts = hits[4 * n + i], te = hits[5 * n + i];
    const int32_t rev = hits[8 * n + i] != 0 ? 1 : 0;
    const Arc a = hit2arc(q, qs, qe, t, ts, te, rev, len[qi], len[ti],
                          max_hang, int_frac, min_ovlp);
    if (mode == MARK_CONTAINED) {
        if (a.r == MA_HT_QCONT) mark[qi] = 1;
        if (a.r == MA_HT_TCONT) mark[ti] = 1;
        return;
    }
    const bool self = q == t;
    const bool pal = a.r >= 0 && self && qs == ts && qe == te && rev;
    if (pal || a.r == MA_HT_QCONT) mark[qi] = 1;
    keep[i] = a.r >= 0 && !self ? 1 : 0;
    arcs[i] = a.u;
    arcs[n + i] = a.v;
    arcs[2 * n + i] = a.l;
    arcs[3 * n + i] = a.ol;
}

}  // namespace

extern "C" int ma_hit_cut(const int32_t* hits, int64_t n, const int32_t* tab,
                          int64_t T, int min_span, int32_t* out,
                          uint8_t* keep, cudaStream_t stream) {
    const int threads = 256;
    hit_cut_kernel<<<n_blocks(n, threads), threads, 0, stream>>>(
        hits, n, tab, T, min_span, out, keep);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int ma_hit2arc(const int32_t* hits, int64_t n, const int32_t* len,
                          int64_t T, int max_hang, float int_frac,
                          int min_ovlp, int32_t* out, cudaStream_t stream) {
    const int threads = 256;
    hit2arc_kernel<<<n_blocks(n, threads), threads, 0, stream>>>(
        hits, n, len, T, max_hang, int_frac, min_ovlp, out);
    return static_cast<int>(cudaGetLastError());
}

// K17.  hits (9, n), sub (3, T) int32 [s e del]; keep n bytes, dp n int32;
// dp_sum one int64 and present T bytes, both zeroed here.
extern "C" int ma_hit_flt(const int32_t* hits, int64_t n, const int32_t* sub,
                          int64_t T, int max_hang, int min_ovlp,
                          uint8_t* keep, int32_t* dp, int64_t* dp_sum,
                          uint8_t* present, cudaStream_t stream) {
    if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaMemsetAsync(dp_sum, 0, sizeof(int64_t), stream);
    if (e == cudaSuccess) e = cudaMemsetAsync(present, 0, T, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int threads = 256;
    if (n > 0)
        hit_flt_kernel<<<n_blocks(n, threads), threads, 0, stream>>>(
            hits, n, sub, T, max_hang, min_ovlp, keep, dp,
            reinterpret_cast<unsigned long long*>(dp_sum), present);
    return static_cast<int>(cudaGetLastError());
}

// K18.  hits (9, n); len: T int32 (null in the used mode); mode 0
// contained, 1 sg, 2 used; mark: T bytes, zeroed here; keep (n bytes) and
// arcs (4, n) int32 [u v l ol]: the sg mode's, else null.
extern "C" int ma_hit_marks(const int32_t* hits, int64_t n, const int32_t* len,
                            int64_t T, int max_hang, float int_frac,
                            int min_ovlp, int mode, uint8_t* mark,
                            uint8_t* keep, int32_t* arcs,
                            cudaStream_t stream) {
    if (T <= 0 || mode < MARK_CONTAINED || mode > MARK_USED ||
        (mode != MARK_USED && !len) || (mode == MARK_SG && (!keep || !arcs)))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = cudaMemsetAsync(mark, 0, T, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int threads = 256;
    if (n > 0)
        hit_marks_kernel<<<n_blocks(n, threads), threads, 0, stream>>>(
            hits, n, len, T, max_hang, int_frac, min_ovlp, mode, mark, keep,
            arcs);
    return static_cast<int>(cudaGetLastError());
}
