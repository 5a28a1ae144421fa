// Read-selection kernels of the select step (port of the JAX device
// program miniasm_tpu/select/fused2.py:_select2_kernel).
//
// K1 cut_hit2arc replaces the elementwise chain of _select2_kernel:
//   _cut_pass (fused2.py:254-298) -> both hit2arc lanes
//   (core/hit2arc.py:28; fused2.py:352-355 and 403-406) -> the filter
//   masks and dp values (fused2.py:358-376).
// One thread per original PAF row.  Per row it reads 7 int32 words and one
// lane byte and gathers three trim-table words for each of its two reads
// (the tables are a few hundred KB and stay in L2); it writes 6 int32 rows
// (relaxed pass) or 15 (final pass).  It is bound by device-memory bytes:
// about 60-90 bytes a row, tens of microseconds at 0.9 M rows on an H100.
// Every int32 add/sub wraps like XLA's (common.cuh), the reference's e-side
// clamp compares as uint32 (hit.c:181-184), and the int_frac test is one
// float32 multiply and compare (miniasm.h:94).
//
// K2 sweep replaces the coverage sweep (sweep_events, fused2.py:131-251:
// transition compaction + packed segment_min / seg_reduce_argmax).  The
// events arrive sorted by torch.sort on the int64 key seg<<32 | pos*2+is_end
// with skipped events keyed 0x7FFFFFFF (last within their read) and padding
// rows in segment T.  One thread per read binary-searches its event range
// and walks it in order, keeping the depth and the FIRST longest region of
// depth >= min_dp (`len > max`, hit.c:142).  The pass reads the 4N keys
// once (bytes bound: ~29 MB at 0.9 M rows) but a thread walks its ~100
// events serially, so it is latency bound at this size.
#include "common.cuh"

namespace {

constexpr uint32_t SKIP_KEY = 0x7FFFFFFFu;

__device__ __forceinline__ bool flt_keep(int32_t r) {
    return r >= 0 || r == MA_HT_QCONT || r == MA_HT_TCONT;
}

__device__ __forceinline__ int32_t flt_dp(int32_t r, int32_t sq, int32_t st) {
    return r >= 0 ? r : (r == MA_HT_QCONT ? sq : st);
}

__global__ void cut_hit2arc_kernel(
    const int32_t* __restrict__ qid, const int32_t* __restrict__ tid,
    const int32_t* __restrict__ flags, const int32_t* __restrict__ coords,
    const uint8_t* __restrict__ lanes, const int32_t* __restrict__ tab,
    int64_t T, int64_t n, int32_t min_span, int32_t max_hang,
    float int_frac, int32_t min_ovlp, int final_pass,
    int32_t* __restrict__ out) {
    int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    // gathers clamp like XLA's
    int32_t q = qid[i], t = tid[i];
    int32_t qi = clamp_index(q, T), ti = clamp_index(t, T);
    int32_t rq_s = tab[qi], rq_e = tab[T + qi], rq_d = tab[2 * T + qi];
    int32_t rt_s = tab[ti], rt_e = tab[T + ti], rt_d = tab[2 * T + ti];
    bool alive = !(rq_d || rt_d);
    int32_t rev = (flags[i] >> 1) & 1;
    Coords p = cut_project(coords[i], coords[n + i], coords[2 * n + i],
                           coords[3 * n + i], rev, rq_s, rq_e, rt_s, rt_e);
    int32_t qs1 = p.qs, qe1 = p.qe, ts1 = p.ts, te1 = p.te;
    // clamp + rebase (hit.c:181-184): s-side signed max, e-side UNSIGNED min
    uint32_t qs2 = static_cast<uint32_t>(wsub(max(qs1, rq_s), rq_s));
    uint32_t ts2 = static_cast<uint32_t>(wsub(max(ts1, rt_s), rt_s));
    uint32_t uqe1 = static_cast<uint32_t>(qe1), urqe = static_cast<uint32_t>(rq_e);
    uint32_t ute1 = static_cast<uint32_t>(te1), urte = static_cast<uint32_t>(rt_e);
    uint32_t qe2 = (uqe1 < urqe ? uqe1 : urqe) - static_cast<uint32_t>(rq_s);
    uint32_t te2 = (ute1 < urte ? ute1 : urte) - static_cast<uint32_t>(rt_s);
    int32_t qspan = static_cast<int32_t>(qe2 - qs2);
    int32_t tspan = static_cast<int32_t>(te2 - ts2);
    bool keep = alive && qspan >= min_span && tspan >= min_span;
    int32_t slq = wsub(rq_e, rq_s), slt = wsub(rt_e, rt_s);

    int32_t cqs = static_cast<int32_t>(qs2), cqe = static_cast<int32_t>(qe2);
    int32_t cts = static_cast<int32_t>(ts2), cte = static_cast<int32_t>(te2);
    out[i] = cqs;
    out[n + i] = cqe;
    out[2 * n + i] = cts;
    out[3 * n + i] = cte;
    uint8_t ln = lanes[i];
    bool vq = (ln & 1) && keep;
    bool vm = (ln & 2) && keep;
    Arc aq = hit2arc(q, cqs, cqe, t, cts, cte, rev, slq, slt, max_hang,
                     int_frac, min_ovlp);
    Arc am = hit2arc(t, cts, cte, q, cqs, cqe, rev, slt, slq, max_hang,
                     int_frac, min_ovlp);
    if (!final_pass) {
        // relaxed filter pass (hit.c:195-216)
        bool fq = vq && flt_keep(aq.r);
        bool fm = vm && flt_keep(am.r);
        out[4 * n + i] = (vq ? 1 : 0) | (vm ? 2 : 0) | (fq ? 4 : 0) |
                         (fm ? 8 : 0);
        out[5 * n + i] = wadd(fq ? flt_dp(aq.r, slq, slt) : 0,
                              fm ? flt_dp(am.r, slt, slq) : 0);
        return;
    }
    out[4 * n + i] = (vq ? 1 : 0) | (vm ? 2 : 0);
    out[5 * n + i] = aq.r;
    out[6 * n + i] = aq.u;
    out[7 * n + i] = aq.v;
    out[8 * n + i] = aq.l;
    out[9 * n + i] = aq.ol;
    out[10 * n + i] = am.r;
    out[11 * n + i] = am.u;
    out[12 * n + i] = am.v;
    out[13 * n + i] = am.l;
    out[14 * n + i] = am.ol;
}

__device__ __forceinline__ int64_t lower_bound(const int64_t* __restrict__ a,
                                               int64_t n, int64_t x) {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (a[mid] < x) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

__global__ void sweep_kernel(const int64_t* __restrict__ keys, int64_t n_ev,
                             int64_t T, int32_t min_dp, int32_t end_clip,
                             int32_t* __restrict__ out) {
    int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (r >= T) return;
    int64_t lo = lower_bound(keys, n_ev, r << 32);
    int64_t hi = lower_bound(keys, n_ev, (r + 1) << 32);
    bool has_query = hi > lo;
    int32_t depth = 0, cur_s = 0, best = 0, bs = 0, be = 0;
    for (int64_t k = lo; k < hi; ++k) {
        uint32_t key = static_cast<uint32_t>(keys[k] & 0xFFFFFFFFll);
        if (key == SKIP_KEY) break;  // skipped events sort last
        int32_t pos = static_cast<int32_t>(key >> 1);
        int32_t old = depth;
        depth += (key & 1) ? -1 : 1;
        if (old < min_dp && depth >= min_dp) {
            cur_s = pos;
        } else if (old >= min_dp && depth < min_dp) {
            int32_t len = pos - cur_s;
            if (len > best) {
                best = len;
                bs = cur_s;
                be = pos;
            }
        }
    }
    bool has_region = has_query && best > 0;
    out[r] = has_region ? bs - end_clip : 0;
    out[T + r] = has_region ? be + end_clip : 0;
    out[2 * T + r] = (has_query && !has_region) ? 1 : 0;
    out[3 * T + r] = has_query ? 1 : 0;
}

}  // namespace

extern "C" int ma_cut_hit2arc(const int32_t* qid, const int32_t* tid,
                              const int32_t* flags, const int32_t* coords,
                              const uint8_t* lanes, const int32_t* tab,
                              int64_t T, int64_t n, int min_span,
                              int max_hang, float int_frac, int min_ovlp,
                              int final_pass, int32_t* out,
                              cudaStream_t stream) {
    const int threads = 256;
    cut_hit2arc_kernel<<<n_blocks(n, threads), threads, 0, stream>>>(
        qid, tid, flags, coords, lanes, tab, T, n, min_span, max_hang,
        int_frac, min_ovlp, final_pass, out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int ma_sweep(const int64_t* keys, int64_t n_ev, int64_t T,
                        int min_dp, int end_clip, int32_t* out,
                        cudaStream_t stream) {
    const int threads = 128;
    sweep_kernel<<<n_blocks(T, threads), threads, 0, stream>>>(
        keys, n_ev, T, min_dp, end_clip, out);
    return static_cast<int>(cudaGetLastError());
}
