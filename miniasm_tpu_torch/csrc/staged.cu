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
// each read; it writes 5 int32 rows [r u v l ol].
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
