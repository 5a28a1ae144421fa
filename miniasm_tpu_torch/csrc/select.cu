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
// K2 sweep replaces the whole coverage sweep, sweep_events (fused2.py:131-
// 251): the (seg, key) event sort, the depth cumsum, the transition
// compaction and the per-read first-longest reduction (packed segment_min
// or seg_reduce_argmax).  It takes the events unsorted: seg is the read
// (outside [0, T) for an absent side), key is pos*2 + is_end, or SKIP
// (0x7FFFFFFF) for a skipped event; it returns per read [s, e, del,
// has_query].  The in-read order is the UNSIGNED order of the keys (as an
// int64 sort of seg<<32 | key gives it), pos = key >> 1 as uint32.  One
// call makes five launches on the caller's stream, after one memset:
//   (a) count: the valid events of each read, by one atomic per run of
//       equal reads in a warp (the q-side events of a query-grouped PAF
//       arrive in runs); a skipped event only flags its read (has_query:
//       hit.c:115,152).
//   (b) alloc: each read's bucket, by a warp scan of 32 counts and one
//       atomic a warp on the running total.  The buckets' order in the
//       buffer is arbitrary, and so is (c)'s order within a bucket: equal
//       keys are equal values and the sweep reads only values, so the
//       result is exact.
//   (c) scatter: each valid key, as a uint32, to its read's cursor (one
//       atomic per run again, four events a thread in flight).  Skipped
//       keys stay out: they sort last in their read and add nothing to the
//       depth.
//   (d) one warp a read of at most REG_EVENTS events, E = 1-8 a lane in
//       registers, sorted by a bitonic network (registers within a lane,
//       shuffles across lanes).  The sweep: the depth by a warp scan of
//       +-1, the up and down crossings of min_dp, each down crossing
//       paired with the last up crossing before it (crossings alternate,
//       up first, since the depth starts and ends at 0; the nearest one in
//       a lower lane comes by ballot), and the FIRST longest region
//       (`len > max`, hit.c:142) by a (length desc, index asc) warp
//       reduction.  A larger read goes on a list.
//   (e) one block a listed read, a grid of one block per SM walking the
//       list: the network run by the whole block, in dynamic shared memory
//       where the read fits `smem_cap` bytes, else in place in its bucket
//       in device memory; then the sweep by one warp.  The host cannot see
//       the list's length without a sync, so (e) is launched on every
//       call; with the list empty its blocks read one word and exit.
// The network compares ascending only (the first step of each merge pairs
// a slot with its mirror), so slots past n act as +inf: in memory the
// pairs that reach them are skipped, in registers they hold 0xffffffff.
// What bounds it: the bytes (the 8-byte events read twice, the 4-byte keys
// written and read once; L2 holds the second read at E. coli scale), the
// L2 transactions of (c) where reads arrive in random order (an atomic
// and a 4-byte store an event: the m-side of the main path), and the
// sorts' shuffles (n log^2 n / 4 compare-exchanges a read).
#include <atomic>

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

constexpr uint32_t NO_READ = 0xffffffffu;
constexpr int EV_THREADS = 256;    // count and scatter
constexpr int EV_ITEMS = 4;        // events a thread
constexpr int ALLOC_THREADS = 256;
constexpr int SW_WARPS = 8;        // reads a block on the warp path
constexpr int REG_EVENTS = 256;    // the largest read a warp sorts
constexpr int BIG_THREADS = 1024;
constexpr int SMEM_MAX = 232448;   // an H100 block's shared memory

__device__ __forceinline__ unsigned lanes_upto(int lane) {
    return lane == 31 ? FULL : (2u << lane) - 1u;
}

// The runs of equal reads among a warp's events: the head of the lane's
// run and the run's length (valid on the head lane).
struct Run {
    int head, len;
    bool is_head;
};

__device__ __forceinline__ Run run_of(uint32_t r, int lane) {
    const uint32_t prev = __shfl_up_sync(FULL, r, 1);
    const bool is_head = lane == 0 || prev != r;
    const unsigned heads = __ballot_sync(FULL, is_head);
    const unsigned after = heads & ~lanes_upto(lane);
    Run run;
    run.is_head = is_head;
    run.head = 31 - __clz(static_cast<int>(heads & lanes_upto(lane)));
    run.len = (after ? __ffs(static_cast<int>(after)) - 1 : 32) - lane;
    return run;
}

// (a) cnt[r] = the valid events of read r; has[r] = 1 where a skipped
// event names r.  Thread t of a block takes events t, t + 256, ...
__global__ void __launch_bounds__(EV_THREADS)
ev_count_kernel(const int32_t* __restrict__ seg,
                const int32_t* __restrict__ key, int64_t n, uint32_t T,
                int32_t* __restrict__ cnt, uint8_t* __restrict__ has) {
    const int64_t base =
        static_cast<int64_t>(blockIdx.x) * EV_THREADS * EV_ITEMS +
        threadIdx.x;
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int q = 0; q < EV_ITEMS; ++q) {
        const int64_t i = base + q * EV_THREADS;
        uint32_t r = NO_READ;
        if (i < n) {
            const uint32_t s = static_cast<uint32_t>(seg[i]);
            if (s < T) {
                if (static_cast<uint32_t>(key[i]) != SKIP_KEY) r = s;
                else has[s] = 1;
            }
        }
        const Run run = run_of(r, lane);
        if (run.is_head && r != NO_READ) atomicAdd(&cnt[r], run.len);
    }
}

// (b) each read's bucket: off[r] = cur[r] = its start in buf, taken by one
// atomic a warp on the running total (the buckets' order is arbitrary)
__global__ void __launch_bounds__(ALLOC_THREADS)
ev_alloc_kernel(const int32_t* __restrict__ cnt, int64_t T,
                int32_t* __restrict__ total, int32_t* __restrict__ off,
                int32_t* __restrict__ cur) {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * ALLOC_THREADS +
                      threadIdx.x;
    const int lane = threadIdx.x & 31;
    const int32_t c = r < T ? cnt[r] : 0;
    const int32_t x = warp_incl_sum(c, lane);
    int32_t base = 0;
    if (lane == 31 && x > 0) base = atomicAdd(total, x);
    base = __shfl_sync(FULL, base, 31) + x - c;
    if (r < T) {
        off[r] = base;
        cur[r] = base;
    }
}

// (c) every valid key into its read's bucket, at the read's cursor
__global__ void __launch_bounds__(EV_THREADS)
ev_scatter_kernel(const int32_t* __restrict__ seg,
                  const int32_t* __restrict__ key, int64_t n, uint32_t T,
                  int32_t* __restrict__ cur, uint32_t* __restrict__ buf) {
    const int64_t base =
        static_cast<int64_t>(blockIdx.x) * EV_THREADS * EV_ITEMS +
        threadIdx.x;
    const int lane = threadIdx.x & 31;
    uint32_t r[EV_ITEMS], k[EV_ITEMS];
    Run run[EV_ITEMS];
    int32_t top[EV_ITEMS];
#pragma unroll
    for (int q = 0; q < EV_ITEMS; ++q) {
        const int64_t i = base + q * EV_THREADS;
        r[q] = NO_READ;
        k[q] = 0;
        if (i < n) {
            const uint32_t s = static_cast<uint32_t>(seg[i]);
            k[q] = static_cast<uint32_t>(key[i]);
            if (s < T && k[q] != SKIP_KEY) r[q] = s;
        }
    }
    // the atomics of all the thread's events are in flight together
#pragma unroll
    for (int q = 0; q < EV_ITEMS; ++q) {
        run[q] = run_of(r[q], lane);
        top[q] = (run[q].is_head && r[q] != NO_READ)
                     ? atomicAdd(&cur[r[q]], run[q].len) : 0;
    }
#pragma unroll
    for (int q = 0; q < EV_ITEMS; ++q) {
        const int32_t t = __shfl_sync(FULL, top[q], run[q].head);
        if (r[q] != NO_READ) buf[t + lane - run[q].head] = k[q];
    }
}

// Ascending bitonic network over a[0, n), run by the whole block.  Every
// compare-exchange moves the smaller key to the lower slot, so slots past
// n act as +inf and the pairs that reach them are skipped.  K2 sorts
// uint32 keys, K13 uint64.
template <typename K>
__device__ void bitonic_sort(K* a, uint32_t n) {
    if (n < 2) return;
    const uint32_t P = 1u << (32 - __clz(static_cast<int>(n - 1)));
    const uint32_t half = P >> 1;
    for (uint32_t k = 2; k != 0 && k <= P; k <<= 1) {
        for (uint32_t d = k >> 1; d > 0; d >>= 1) {
            // the first step of a size-k merge pairs each slot of a k-block's
            // lower half with its mirror, the later ones slot i with i + d
            const uint32_t flip = d == (k >> 1) ? k - 1 : 0;
            for (uint32_t p = threadIdx.x; p < half; p += blockDim.x) {
                const uint32_t i = ((p & ~(d - 1)) << 1) | (p & (d - 1));
                const uint32_t j = flip ? (i ^ flip) : (i + d);
                if (j < n) {
                    const K x = a[i], y = a[j];
                    if (x > y) {
                        a[i] = y;
                        a[j] = x;
                    }
                }
            }
            __syncthreads();
        }
    }
}

// The same network on 32 * E keys in a warp's registers, key lane * E + e
// in x[e] (padded with all ones: the n smallest are the read's keys):
// partners within a lane compare in registers, the others by shuffle.
template <int E, typename K>
__device__ __forceinline__ void reg_sort(K (&x)[E], int lane) {
#pragma unroll
    for (int k = 2; k <= 32 * E; k <<= 1) {
        if (k <= E) {
#pragma unroll
            for (int e = 0; e < E; ++e) {
                const int f = e ^ (k - 1);
                if (f > e) {
                    const K a = min(x[e], x[f]), b = max(x[e], x[f]);
                    x[e] = a;
                    x[f] = b;
                }
            }
        } else {
            // partner lane ^ (k/E - 1), register E-1-e; the lower lane
            // keeps the minimum
            const bool lower = (lane & (k / E / 2)) == 0;
            K y[E];
#pragma unroll
            for (int e = 0; e < E; ++e)
                y[e] = __shfl_xor_sync(FULL, x[E - 1 - e], k / E - 1);
#pragma unroll
            for (int e = 0; e < E; ++e)
                x[e] = lower ? min(x[e], y[e]) : max(x[e], y[e]);
        }
#pragma unroll
        for (int d = k / 4; d > 0; d /= 2) {
            if (d < E) {
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    if ((e & d) == 0) {
                        const K a = min(x[e], x[e + d]);
                        const K b = max(x[e], x[e + d]);
                        x[e] = a;
                        x[e + d] = b;
                    }
                }
            } else {
                const bool lower = (lane & (d / E)) == 0;
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    const K y = __shfl_xor_sync(FULL, x[e], d / E);
                    x[e] = lower ? min(x[e], y) : max(x[e], y);
                }
            }
        }
    }
}

struct Region {
    int32_t len, s, e;
};

// The first longest region over the lanes' candidates: length desc, then
// the down crossing's index asc.
__device__ __forceinline__ Region warp_best(int32_t best, int32_t bs,
                                            int32_t be, uint32_t bi) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const int32_t ol = __shfl_xor_sync(FULL, best, o);
        const uint32_t oi = __shfl_xor_sync(FULL, bi, o);
        const int32_t os = __shfl_xor_sync(FULL, bs, o);
        const int32_t oe = __shfl_xor_sync(FULL, be, o);
        if (ol > best || (ol == best && oi < bi)) {
            best = ol;
            bi = oi;
            bs = os;
            be = oe;
        }
    }
    return {best, bs, be};
}

// The sweep of a sorted bucket a[0, n) by one whole warp, in chunks of 32:
// the first longest region of depth >= min_dp (len 0: none).
__device__ Region warp_sweep(const uint32_t* a, uint32_t n, int32_t min_dp,
                             int lane) {
    int32_t depth = 0, cur_s = 0;  // before the chunk
    int32_t best = 0, bs = 0, be = 0;
    uint32_t bi = 0xffffffffu;  // the lane's best down crossing
    for (uint32_t base = 0; base < n; base += 32) {
        const uint32_t i = base + lane;
        const bool in = i < n;
        const uint32_t k = in ? a[i] : 0u;
        const int32_t delta = in ? ((k & 1u) ? -1 : 1) : 0;
        const int32_t pos = static_cast<int32_t>(k >> 1);
        const int32_t now = depth + warp_incl_sum(delta, lane);
        const int32_t old = now - delta;
        const bool up = in && old < min_dp && now >= min_dp;
        const bool down = in && old >= min_dp && now < min_dp;
        const unsigned ups = __ballot_sync(FULL, up);
        const unsigned before = ups & (lanes_upto(lane) >> 1);
        const int32_t from = __shfl_sync(
            FULL, pos, before ? 31 - __clz(static_cast<int>(before)) : 0);
        if (down) {
            const int32_t start = before ? from : cur_s;
            const int32_t len = wsub(pos, start);
            if (len > best) {
                best = len;
                bs = start;
                be = pos;
                bi = i;
            }
        }
        if (ups) cur_s = __shfl_sync(FULL, pos,
                                     31 - __clz(static_cast<int>(ups)));
        depth = __shfl_sync(FULL, now, 31);
    }
    return warp_best(best, bs, be, bi);
}

// The sweep of a read of n <= 32 * E keys sorted in registers: each lane
// walks its E keys twice, first for its last up crossing (the lanes above
// take the nearest one below them by ballot), then for its regions.
template <int E>
__device__ __forceinline__ Region reg_sweep(const uint32_t (&x)[E],
                                            uint32_t n, int32_t min_dp,
                                            int lane) {
    const uint32_t first = static_cast<uint32_t>(lane) * E;
    int32_t sum = 0;
#pragma unroll
    for (int e = 0; e < E; ++e)
        if (first + e < n) sum += (x[e] & 1u) ? -1 : 1;
    const int32_t depth = warp_incl_sum(sum, lane) - sum;
    int32_t d = depth, last_up = 0;
    bool any_up = false;
#pragma unroll
    for (int e = 0; e < E; ++e) {
        if (first + e < n) {
            const int32_t old = d;
            d += (x[e] & 1u) ? -1 : 1;
            if (old < min_dp && d >= min_dp) {
                any_up = true;
                last_up = static_cast<int32_t>(x[e] >> 1);
            }
        }
    }
    const unsigned before = __ballot_sync(FULL, any_up) &
                            (lanes_upto(lane) >> 1);
    const int32_t from = __shfl_sync(
        FULL, last_up, before ? 31 - __clz(static_cast<int>(before)) : 0);
    int32_t cur_s = before ? from : 0;
    int32_t best = 0, bs = 0, be = 0;
    uint32_t bi = 0xffffffffu;
    d = depth;
#pragma unroll
    for (int e = 0; e < E; ++e) {
        if (first + e < n) {
            const int32_t old = d;
            const int32_t pos = static_cast<int32_t>(x[e] >> 1);
            d += (x[e] & 1u) ? -1 : 1;
            if (old < min_dp && d >= min_dp) {
                cur_s = pos;
            } else if (old >= min_dp && d < min_dp) {
                const int32_t len = wsub(pos, cur_s);
                if (len > best) {
                    best = len;
                    bs = cur_s;
                    be = pos;
                    bi = first + e;
                }
            }
        }
    }
    return warp_best(best, bs, be, bi);
}

template <int E>
__device__ __forceinline__ Region reg_read(const uint32_t* __restrict__ a,
                                           uint32_t n, int32_t min_dp,
                                           int lane) {
    uint32_t x[E];
    const uint32_t first = static_cast<uint32_t>(lane) * E;
#pragma unroll
    for (int e = 0; e < E; ++e)
        x[e] = first + e < n ? a[first + e] : 0xffffffffu;
    reg_sort<E>(x, lane);
    return reg_sweep<E>(x, n, min_dp, lane);
}

__device__ __forceinline__ void write_row(int32_t* __restrict__ out,
                                          int64_t T, int64_t r, bool hq,
                                          Region g, int32_t end_clip) {
    const bool hr = hq && g.len > 0;
    out[r] = hr ? wsub(g.s, end_clip) : 0;
    out[T + r] = hr ? wadd(g.e, end_clip) : 0;
    out[2 * T + r] = (hq && !hr) ? 1 : 0;
    out[3 * T + r] = hq ? 1 : 0;
}

// (d) one warp a read of at most warp_cap (<= REG_EVENTS) events, sorted
// in registers; a larger read goes on the list for (e)
__global__ void __launch_bounds__(SW_WARPS * 32)
ev_sweep_warp_kernel(const uint32_t* __restrict__ buf,
                     const int32_t* __restrict__ off,
                     const int32_t* __restrict__ cnt,
                     const uint8_t* __restrict__ has, int64_t T,
                     int32_t min_dp, int32_t end_clip, uint32_t warp_cap,
                     int32_t* __restrict__ out, int32_t* __restrict__ big,
                     int32_t* __restrict__ nbig) {
    const int lane = threadIdx.x & 31;
    const int64_t r =
        static_cast<int64_t>(blockIdx.x) * SW_WARPS + (threadIdx.x >> 5);
    if (r >= T) return;  // the whole warp
    const uint32_t n = static_cast<uint32_t>(cnt[r]);
    if (n > warp_cap) {
        if (lane == 0) big[atomicAdd(nbig, 1)] = static_cast<int32_t>(r);
        return;
    }
    const uint32_t* a = buf + off[r];
    Region g;
    if (n <= 32) {
        g = reg_read<1>(a, n, min_dp, lane);
    } else if (n <= 64) {
        g = reg_read<2>(a, n, min_dp, lane);
    } else if (n <= 128) {
        g = reg_read<4>(a, n, min_dp, lane);
    } else {
        g = reg_read<REG_EVENTS / 32>(a, n, min_dp, lane);
    }
    if (lane == 0) write_row(out, T, r, n > 0 || has[r], g, end_clip);
}

// (e) one block a listed read, in dynamic shared memory where it fits
// smem_keys keys, else in place in its bucket (counted in ndev)
__global__ void __launch_bounds__(BIG_THREADS)
ev_sweep_big_kernel(uint32_t* buf, const int32_t* __restrict__ off,
                    const int32_t* __restrict__ cnt, int64_t T,
                    int32_t min_dp, int32_t end_clip, uint32_t smem_keys,
                    int32_t* __restrict__ out,
                    const int32_t* __restrict__ big,
                    const int32_t* __restrict__ nbig,
                    int32_t* __restrict__ ndev) {
    extern __shared__ uint32_t sbuf[];
    const int lane = threadIdx.x & 31;
    const int32_t nb = *nbig;
    for (int32_t li = blockIdx.x; li < nb; li += gridDim.x) {
        const int64_t r = big[li];
        const uint32_t n = static_cast<uint32_t>(cnt[r]);
        uint32_t* a = buf + off[r];
        if (n <= smem_keys) {
            for (uint32_t i = threadIdx.x; i < n; i += blockDim.x)
                sbuf[i] = a[i];
            a = sbuf;
        } else if (threadIdx.x == 0) {
            atomicAdd(ndev, 1);
        }
        __syncthreads();
        bitonic_sort(a, n);
        if (threadIdx.x < 32) {
            const Region g = warp_sweep(a, n, min_dp, lane);
            if (lane == 0) write_row(out, T, r, true, g, end_clip);
        }
        __syncthreads();  // before the next read reuses sbuf
    }
}


// ---------------------------------------------------------------------------
// K12 read_marks: the containment / used / palindrome marks of the final
// pass (fused2.py:401-426; hit.c:225-236, asm.c:9-39).  One thread per
// original row reads its lane bits and both sides' hit2arc codes from K1's
// final-pass output and raises the per-read word of its query (used,
// contained, palindrome: bits 0-2) and of its target (used, contained) by
// atomicMax.  It is a max, not an or, because both packages reduce with
// amax: a palindromic self-hit row (5) and a row that marks the same read
// contained (3) leave 5.  A row with no valid lane adds 0 and is skipped;
// a word that already holds at least the row's value is not touched.

__global__ void read_marks_kernel(const int32_t* __restrict__ qid,
                                  const int32_t* __restrict__ tid,
                                  const int32_t* __restrict__ flags,
                                  const int32_t* __restrict__ out, int64_t n,
                                  int64_t T, int32_t* __restrict__ tab) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
    if (i >= n) return;
    const int32_t bits = out[4 * n + i];
    const bool vq = bits & 1, vm = bits & 2;
    if (!vq && !vm) return;
    const int32_t rq_raw = out[5 * n + i], rm_raw = out[10 * n + i];
    const int32_t rq = vq ? rq_raw : 0, rm = vm ? rm_raw : 0;
    const int32_t q = qid[i], t = tid[i];
    const bool pal = vq && rq_raw >= 0 && q == t && out[i] == out[2 * n + i] &&
                     out[n + i] == out[3 * n + i] && ((flags[i] >> 1) & 1);
    const int32_t qbits = 1 | ((rq == MA_HT_QCONT || rm == MA_HT_TCONT) << 1) |
                          (pal << 2);
    const int32_t tbits = 1 | ((rq == MA_HT_TCONT || rm == MA_HT_QCONT) << 1);
    int32_t* wq = tab + clamp_index(q, T);
    int32_t* wt = tab + clamp_index(t, T);
    if (*wq < qbits) atomicMax(wq, qbits);
    if (*wt < tbits) atomicMax(wt, tbits);
}

// ---------------------------------------------------------------------------
// K13 arc_order: arc compaction and the stable hit-key order of the final
// pass (fused2.py:428-520).  An arc row is a valid lane whose hit2arc code
// is an arc (>= 0), not a self match, between two reads that survive (used,
// not sub-deleted, not contained: hit.c:237-251).  Row i < n is the q-side
// of original i, row n + i its m-side; the arcs go out ordered by the hit
// key (the side's read, its ORIGINAL start), ties in row order.  K2's
// pattern on arcs, one call making these launches after one memset:
//   (a) count: each read's arcs (the side's read: qid, or tid for the
//       m-side) and m_contained (hit.c:244: the valid lanes between two
//       surviving reads), a warp sum and one atomic a warp;
//   (b) scan: the exclusive scan of the counts in read order, in three
//       launches (block sums, their scan in one block, each block's scan
//       plus its offset), so that read r's bucket starts at its first
//       position in the output; the total is n_arc;
//   (c) scatter: each arc's 64-bit key, its start (sign bit flipped, so
//       the unsigned order is the signed one) over its row, into its read's
//       bucket at an atomic cursor: the bucket's order is arbitrary, but
//       (start, row) is unique, so its sort restores the stable order;
//   (d) sort: one warp a read of at most REG_EVENTS arcs, in registers (the
//       bitonic network of K2 on 64-bit keys); a larger read goes on a list
//       for (e), one block a listed read, in shared memory where it fits
//       smem_cap bytes, else in place in device memory.  Each writes its
//       read's arcs in order to the five output columns (u, v, l, ol from
//       K1's final pass, the row) and counts the neighbours of equal key
//       (dup_hit: equal starts within one read).
// res: [m_contained, n_arc, dup_hit, u[2n], v[2n], l[2n], ol[2n], row[2n]];
// only the first n_arc positions of each column are written (the JAX
// program pads its arcmat to 2n rows; no reader of the port looks past
// n_arc).

typedef unsigned long long u64;
constexpr int SCAN_THREADS = 1024;
constexpr int ARC_THREADS = 256;

__device__ __forceinline__ bool read_alive(const int32_t* __restrict__ tab,
                                           const uint8_t* __restrict__ mdel,
                                           int32_t r) {
    const int32_t w = tab[r];
    return (w & 1) && !(w & 2) && !mdel[r];
}

// the row's arc lanes: bit 0 its q-side, bit 1 its m-side; with the
// valid lanes between two surviving reads (m_contained's terms) in mc
__device__ __forceinline__ int arc_lanes(
    const int32_t* __restrict__ qid, const int32_t* __restrict__ tid,
    const int32_t* __restrict__ out, const int32_t* __restrict__ tab,
    const uint8_t* __restrict__ mdel, int64_t n, int64_t T, int64_t i,
    int32_t& q, int32_t& t, int& mc) {
    const int32_t bits = out[4 * n + i];
    mc = 0;
    if (!(bits & 3)) return 0;
    q = clamp_index(qid[i], T);
    t = clamp_index(tid[i], T);
    if (!read_alive(tab, mdel, q) || !read_alive(tab, mdel, t)) return 0;
    const bool vq = bits & 1, vm = bits & 2;
    mc = vq + vm;
    if (qid[i] == tid[i]) return 0;
    return (vq && out[5 * n + i] >= 0 ? 1 : 0) |
           (vm && out[10 * n + i] >= 0 ? 2 : 0);
}

__device__ __forceinline__ int32_t block_sum(int32_t x, int32_t* sh) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    x = __reduce_add_sync(FULL, x);
    if (lane == 0) sh[w] = x;
    __syncthreads();
    int32_t tot = 0;
    for (int k = 0; k < static_cast<int>(blockDim.x >> 5); ++k) tot += sh[k];
    __syncthreads();
    return tot;
}

// (a)
__global__ void __launch_bounds__(ARC_THREADS)
arc_count_kernel(const int32_t* __restrict__ qid,
                 const int32_t* __restrict__ tid,
                 const int32_t* __restrict__ out,
                 const int32_t* __restrict__ tab,
                 const uint8_t* __restrict__ mdel, int64_t n, int64_t T,
                 int32_t* __restrict__ cnt, int32_t* __restrict__ res) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * ARC_THREADS +
                      threadIdx.x;
    int32_t q = 0, t = 0;
    int mc = 0;
    const int a = i < n ? arc_lanes(qid, tid, out, tab, mdel, n, T, i, q, t,
                                    mc) : 0;
    if (a & 1) atomicAdd(&cnt[q], 1);
    if (a & 2) atomicAdd(&cnt[t], 1);
    const int32_t s = __reduce_add_sync(FULL, mc);
    if ((threadIdx.x & 31) == 0 && s) atomicAdd(&res[0], s);
}

// (b) 1: the sum of each block of SCAN_THREADS counts
__global__ void __launch_bounds__(SCAN_THREADS)
scan_sums_kernel(const int32_t* __restrict__ cnt, int64_t T,
                 int32_t* __restrict__ bsum) {
    __shared__ int32_t sh[32];
    const int64_t r = static_cast<int64_t>(blockIdx.x) * SCAN_THREADS +
                      threadIdx.x;
    const int32_t s = block_sum(r < T ? cnt[r] : 0, sh);
    if (threadIdx.x == 0) bsum[blockIdx.x] = s;
}

// (b) 2: the block sums' exclusive scan in place, by one block; the total
// is n_arc
__global__ void __launch_bounds__(SCAN_THREADS)
scan_blocks_kernel(int32_t* __restrict__ bsum, int64_t nb,
                   int32_t* __restrict__ res) {
    __shared__ int32_t sh[32];
    int32_t carry = 0;
    for (int64_t b0 = 0; b0 < nb; b0 += SCAN_THREADS) {
        const int64_t b = b0 + threadIdx.x;
        const int32_t x = b < nb ? bsum[b] : 0;
        int32_t tot;
        const int32_t before = block_excl_scan(x, sh, &tot);
        if (b < nb) bsum[b] = carry + before;
        carry += tot;
    }
    if (threadIdx.x == 0) res[1] = carry;
}

// (b) 3: off[r] = cur[r] = the first position of read r's arcs
__global__ void __launch_bounds__(SCAN_THREADS)
scan_offsets_kernel(const int32_t* __restrict__ cnt, int64_t T,
                    const int32_t* __restrict__ bsum,
                    int32_t* __restrict__ off, int32_t* __restrict__ cur) {
    __shared__ int32_t sh[32];
    const int64_t r = static_cast<int64_t>(blockIdx.x) * SCAN_THREADS +
                      threadIdx.x;
    int32_t tot;
    const int32_t before = block_excl_scan(r < T ? cnt[r] : 0, sh, &tot);
    if (r < T) {
        off[r] = bsum[blockIdx.x] + before;
        cur[r] = off[r];
    }
}

// (c)
__global__ void __launch_bounds__(ARC_THREADS)
arc_scatter_kernel(const int32_t* __restrict__ qid,
                   const int32_t* __restrict__ qs0,
                   const int32_t* __restrict__ tid,
                   const int32_t* __restrict__ ts0,
                   const int32_t* __restrict__ out,
                   const int32_t* __restrict__ tab,
                   const uint8_t* __restrict__ mdel, int64_t n, int64_t T,
                   int32_t* __restrict__ cur, u64* __restrict__ keys) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * ARC_THREADS +
                      threadIdx.x;
    if (i >= n) return;
    int32_t q = 0, t = 0;
    int mc;
    const int a = arc_lanes(qid, tid, out, tab, mdel, n, T, i, q, t, mc);
    if (a & 1) {
        const u64 k = (static_cast<u64>(static_cast<uint32_t>(qs0[i]) ^
                                        0x80000000u) << 32) |
                      static_cast<uint32_t>(i);
        keys[atomicAdd(&cur[q], 1)] = k;
    }
    if (a & 2) {
        const u64 k = (static_cast<u64>(static_cast<uint32_t>(ts0[i]) ^
                                        0x80000000u) << 32) |
                      static_cast<uint32_t>(n + i);
        keys[atomicAdd(&cur[t], 1)] = k;
    }
}

// the arc of sorted key k at output position p
__device__ __forceinline__ void write_arc(const int32_t* __restrict__ out,
                                          int64_t n, int64_t cap,
                                          int32_t* __restrict__ cols,
                                          int64_t p, u64 k) {
    const int64_t row = static_cast<uint32_t>(k);
    const int64_t src = row < n ? 6 * n + row : 11 * n + (row - n);
    cols[p] = out[src];
    cols[cap + p] = out[src + n];
    cols[2 * cap + p] = out[src + 2 * n];
    cols[3 * cap + p] = out[src + 3 * n];
    cols[4 * cap + p] = static_cast<int32_t>(row);
}

template <int E>
__device__ __forceinline__ int32_t arc_sort_warp(
    const u64* __restrict__ a, uint32_t cnt, const int32_t* __restrict__ out,
    int64_t n, int64_t cap, int32_t* __restrict__ cols, int64_t base,
    int lane) {
    u64 x[E];
    const uint32_t first = static_cast<uint32_t>(lane) * E;
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] = first + e < cnt ? a[first + e] : ~0ull;
    reg_sort<E>(x, lane);
    u64 prev = __shfl_up_sync(FULL, x[E - 1], 1);
    int32_t dups = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const uint32_t p = first + e;
        if (p < cnt) {
            write_arc(out, n, cap, cols, base + p, x[e]);
            if (p > 0 && (prev >> 32) == (x[e] >> 32)) ++dups;
        }
        prev = x[e];
    }
    return dups;
}

// (d)
__global__ void __launch_bounds__(SW_WARPS * 32)
arc_sort_warp_kernel(const u64* __restrict__ keys,
                     const int32_t* __restrict__ off,
                     const int32_t* __restrict__ cnt, int64_t T,
                     uint32_t warp_cap, const int32_t* __restrict__ out,
                     int64_t n, int64_t cap, int32_t* __restrict__ res,
                     int32_t* __restrict__ big, int32_t* __restrict__ nbig) {
    const int lane = threadIdx.x & 31;
    const int64_t r =
        static_cast<int64_t>(blockIdx.x) * SW_WARPS + (threadIdx.x >> 5);
    if (r >= T) return;  // the whole warp
    const uint32_t c = static_cast<uint32_t>(cnt[r]);
    if (c == 0) return;
    if (c > warp_cap) {
        if (lane == 0) big[atomicAdd(nbig, 1)] = static_cast<int32_t>(r);
        return;
    }
    const int64_t base = off[r];
    const u64* a = keys + base;
    int32_t* cols = res + 3;
    int32_t d;
    if (c <= 32) {
        d = arc_sort_warp<1>(a, c, out, n, cap, cols, base, lane);
    } else if (c <= 64) {
        d = arc_sort_warp<2>(a, c, out, n, cap, cols, base, lane);
    } else if (c <= 128) {
        d = arc_sort_warp<4>(a, c, out, n, cap, cols, base, lane);
    } else {
        d = arc_sort_warp<REG_EVENTS / 32>(a, c, out, n, cap, cols, base,
                                           lane);
    }
    d = __reduce_add_sync(FULL, d);
    if (lane == 0 && d) atomicAdd(&res[2], d);
}

// (e) one block a listed read: in dynamic shared memory where it fits
// smem_keys keys, else in place in its bucket (counted in ndev)
__global__ void __launch_bounds__(BIG_THREADS)
arc_sort_big_kernel(u64* keys, const int32_t* __restrict__ off,
                    const int32_t* __restrict__ cnt, uint32_t smem_keys,
                    const int32_t* __restrict__ out, int64_t n, int64_t cap,
                    int32_t* __restrict__ res,
                    const int32_t* __restrict__ big,
                    const int32_t* __restrict__ nbig,
                    int32_t* __restrict__ ndev) {
    extern __shared__ u64 skeys[];
    const int32_t nb = *nbig;
    int32_t* cols = res + 3;
    for (int32_t li = blockIdx.x; li < nb; li += gridDim.x) {
        const int64_t r = big[li];
        const uint32_t c = static_cast<uint32_t>(cnt[r]);
        const int64_t base = off[r];
        u64* a = keys + base;
        if (c <= smem_keys) {
            for (uint32_t i = threadIdx.x; i < c; i += blockDim.x)
                skeys[i] = a[i];
            a = skeys;
        } else if (threadIdx.x == 0) {
            atomicAdd(ndev, 1);
        }
        __syncthreads();
        bitonic_sort(a, c);
        int32_t d = 0;
        for (uint32_t p = threadIdx.x; p < c; p += blockDim.x) {
            write_arc(out, n, cap, cols, base + p, a[p]);
            if (p > 0 && (a[p - 1] >> 32) == (a[p] >> 32)) ++d;
        }
        d = __reduce_add_sync(FULL, d);
        if ((threadIdx.x & 31) == 0 && d) atomicAdd(&res[2], d);
        __syncthreads();  // before the next read reuses skeys
    }
}

// (e)'s dynamic shared memory may reach SMEM_MAX: raised once per device
// and kernel (K2's and K13's)
template <typename F>
cudaError_t allow_big_smem(F kernel, std::atomic<uint64_t>& done, int dev) {
    const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
    if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
    return e;
}

std::atomic<uint64_t> sweep_smem_done{0}, arc_smem_done{0};

// K19 shard_arcs replaces the sharded step's arc tail
// (miniasm_tpu/parallel/full.py:358-378, inside the shard_map program of
// _make_select_step): read_alive from the OR-reduced marks, the aq/at
// gathers, m_contained, the arc lanes and their compaction into the seven
// arcmat rows [u l v ol gid side-read start].  Row j's q-side is lane j
// of the JAX program, its m-side lane n + j, and the arcs go out in lane
// order: all q-sides in row order, then all m-sides (the order of its
// jnp.nonzero over the concatenated lanes: order_arcs sorts them stably
// by hit key, so ties keep it).
//
// Bound by bytes: a row's lane bits, a live row's reads, codes and the
// marks of its reads (L2), an arc's five K1 words, gid and hit key read,
// seven words written.  A row's two lanes share its reads and their six
// marks, and a count, a scan and a scatter over the 2n lanes would gather
// them four times (two threads far apart, in the count and again in the
// scatter).  So one cooperative launch (common.cuh), one thread a row:
//   1. each row's reads and marks are gathered once and decide both of its
//      lanes, one ballot each a round of 32 rows; a lane's loads of four
//      rounds are in flight together; the bits stay in shared memory (in
//      global scratch past what shared memory holds, about 2**26 rows); a
//      block counts its q-sides, its m-sides and its m_contained terms;
//   2. one grid sync (grid_block_offsets): the three counts of the blocks
//      before each block and over all;
//   3. each block writes its q-sides at their q offset and its m-sides at
//      the q total plus their m offset, a round of a warp at a time, both
//      sides' words read before either is written; block 0 writes
//      [m_contained, n_arc] (no atomic, no memset).
struct ShardArcs {
    const int32_t *qid, *qs0, *tid, *ts0, *gid, *out, *marks;
    const uint8_t* mdel;
    int64_t n, T;
    int J, W;
    int64_t chunk;
    int32_t* spill;  // the blocks' bits and counts, or null: shared memory
    int64_t spill_block;  // words a block there
    int32_t* bsum;  // three words a block
    int64_t* cnt;
    int32_t* arcs;
};

// an arc's seven arcmat words, read for row i's side (m: the m-side)
struct ArcWords {
    int32_t u, l, v, ol, g, rd, st;
};

__device__ __forceinline__ ArcWords load_arc(const ShardArcs& a, int64_t i,
                                             bool m) {
    const int64_t n = a.n;
    const int64_t src = (m ? 11 : 6) * n + i;  // u; v, l, ol follow
    ArcWords w;
    w.u = __ldg(a.out + src);
    w.v = __ldg(a.out + src + n);
    w.l = __ldg(a.out + src + 2 * n);
    w.ol = __ldg(a.out + src + 3 * n);
    w.g = __ldg(a.gid + i) | (m ? 1 : 0);
    w.rd = __ldg((m ? a.tid : a.qid) + i);
    w.st = __ldg((m ? a.ts0 : a.qs0) + i);
    return w;
}

// the arc at column p of the (7, na) arcmat
__device__ __forceinline__ void store_arc(const ShardArcs& a,
                                          const ArcWords& w, int64_t na,
                                          int64_t p) {
    a.arcs[p] = w.u;
    a.arcs[na + p] = w.l;
    a.arcs[2 * na + p] = w.v;
    a.arcs[3 * na + p] = w.ol;
    a.arcs[4 * na + p] = w.g;
    a.arcs[5 * na + p] = w.rd;
    a.arcs[6 * na + p] = w.st;
}

// rounds a lane decides together: their loads are in flight at once
constexpr int SA_BATCH = 4;

__global__ void __launch_bounds__(COOP_THREADS)
shard_arcs_kernel(ShardArcs a) {
    extern __shared__ int32_t smem[];
    __shared__ int32_t sh[192];
    const int WT = a.W * COOP_THREADS, WW = a.W * COOP_WARPS;
    int32_t* area = a.spill ? a.spill + blockIdx.x * a.spill_block : smem;
    uint32_t* qbits = reinterpret_cast<uint32_t*>(area);
    uint32_t* mbits = qbits + WT;
    int32_t* qcnt = area + 2 * WT;
    int32_t* mcnt = qcnt + WW;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int64_t n = a.n, T = a.T;
    const int64_t slice_n = static_cast<int64_t>(a.J) * 32;
    const int64_t chunk0 = static_cast<int64_t>(blockIdx.x) * a.chunk;

    // ---- 1. both lanes of each row, decided once, SA_BATCH rounds at a
    // time: their lane bits, then reads and codes, then marks ----
    int32_t mc = 0;
    for (int s = 0; s < a.W; ++s) {
        const int64_t slice = chunk0 + (s * COOP_WARPS + w) * slice_n;
        uint32_t mq = 0, mm = 0;
        for (int j0 = 0; j0 < a.J; j0 += SA_BATCH) {
            int32_t lanes[SA_BATCH], q0[SA_BATCH], t0[SA_BATCH],
                cq[SA_BATCH], cm[SA_BATCH];
            bool aq[SA_BATCH], am[SA_BATCH];
#pragma unroll
            for (int u = 0; u < SA_BATCH; ++u) {
                const int64_t i = slice + 32 * (j0 + u) + lane;
                lanes[u] = j0 + u < a.J && i < n
                               ? __ldg(a.out + 4 * n + i) & 3
                               : 0;
            }
            // the reads and both codes, then the six marks: each level's
            // loads issued together (no short-circuit between them)
#pragma unroll
            for (int u = 0; u < SA_BATCH; ++u) {
                const int64_t i = slice + 32 * (j0 + u) + lane;
                q0[u] = t0[u] = 0;
                cq[u] = cm[u] = -1;
                if (lanes[u]) {
                    q0[u] = __ldg(a.qid + i);
                    t0[u] = __ldg(a.tid + i);
                    cq[u] = __ldg(a.out + 5 * n + i);
                    cm[u] = __ldg(a.out + 10 * n + i);
                }
            }
#pragma unroll
            for (int u = 0; u < SA_BATCH; ++u) {
                const int32_t q = clamp_index(q0[u], T),
                              t = clamp_index(t0[u], T);
                // read_alive = used & ~mdel & ~cont, for both reads
                const bool alive =
                    lanes[u] != 0 && ((__ldg(a.marks + q) != 0) &
                                      (__ldg(a.marks + T + q) == 0) &
                                      (__ldg(a.mdel + q) == 0) &
                                      (__ldg(a.marks + t) != 0) &
                                      (__ldg(a.marks + T + t) == 0) &
                                      (__ldg(a.mdel + t) == 0));
                if (alive) mc += (lanes[u] & 1) + (lanes[u] >> 1);
                const bool arc = alive && q0[u] != t0[u];
                aq[u] = arc && (lanes[u] & 1) && cq[u] >= 0;
                am[u] = arc && (lanes[u] & 2) && cm[u] >= 0;
            }
#pragma unroll
            for (int u = 0; u < SA_BATCH; ++u) {
                if (j0 + u >= a.J) break;  // the same in the whole warp
                const uint32_t bq = __ballot_sync(FULL, aq[u]);
                const uint32_t bm = __ballot_sync(FULL, am[u]);
                if (lane == j0 + u) {
                    mq = bq;
                    mm = bm;
                }
            }
        }
        qbits[s * COOP_THREADS + threadIdx.x] = mq;
        mbits[s * COOP_THREADS + threadIdx.x] = mm;
        const int32_t nq = __reduce_add_sync(FULL, __popc(mq));
        const int32_t nm = __reduce_add_sync(FULL, __popc(mm));
        if (lane == 0) {
            qcnt[s * COOP_WARPS + w] = nq;
            mcnt[s * COOP_WARPS + w] = nm;
        }
    }
    mc = __reduce_add_sync(FULL, mc);
    if (lane == 0) sh[64 + w] = mc;
    __syncthreads();
    int32_t mc_block = 0;
    for (int k = 0; k < COOP_WARPS; ++k) mc_block += sh[64 + k];

    // ---- 2. the slices' offsets in the block, then the blocks' ----
    const int32_t mine[3] = {block_scan_in_place(qcnt, WW, sh),
                             block_scan_in_place(mcnt, WW, sh), mc_block};
    int32_t before[3], total[3];
    grid_block_offsets<3>(mine, a.bsum, before, total, sh);
    const int64_t na = static_cast<int64_t>(total[0]) + total[1];
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        a.cnt[0] = total[2];
        a.cnt[1] = na;
    }

    // ---- 3. a round's q-sides at their q offset and its m-sides after
    // all q-sides, both read before either is written ----
    const uint32_t lt = (1u << lane) - 1;
    for (int s = 0; s < a.W; ++s) {
        const int64_t slice = chunk0 + (s * COOP_WARPS + w) * slice_n;
        const uint32_t mq = qbits[s * COOP_THREADS + threadIdx.x];
        const uint32_t mm = mbits[s * COOP_THREADS + threadIdx.x];
        const int32_t pq = __popc(mq), pm = __popc(mm);
        const int32_t rq = warp_incl_sum(pq, lane) - pq;
        const int32_t rm = warp_incl_sum(pm, lane) - pm;
        const int64_t bq =
            static_cast<int64_t>(before[0]) + qcnt[s * COOP_WARPS + w];
        const int64_t bm = static_cast<int64_t>(total[0]) + before[1] +
                           mcnt[s * COOP_WARPS + w];
        for (int j = 0; j < a.J; ++j) {
            const uint32_t mqj = __shfl_sync(FULL, mq, j);
            const uint32_t mmj = __shfl_sync(FULL, mm, j);
            const int32_t oq = __shfl_sync(FULL, rq, j);
            const int32_t om = __shfl_sync(FULL, rm, j);
            const int64_t i = slice + 32 * j + lane;
            const bool hq = (mqj >> lane) & 1, hm = (mmj >> lane) & 1;
            ArcWords wq{}, wm{};
            if (hq) wq = load_arc(a, i, false);
            if (hm) wm = load_arc(a, i, true);
            if (hq) store_arc(a, wq, na, bq + oq + __popc(mqj & lt));
            if (hm) store_arc(a, wm, na, bm + om + __popc(mmj & lt));
        }
    }
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

// seg, key: n int32 events; buf: n int32, the keys bucketed by read; aux:
// 4T + 3 + ceil(T / 4) int32 of scratch, laid out cnt[T] | has[T] (bytes,
// padded to words) | nbig | ndev | total | off[T] | cur[T] | big[T]; out:
// (4, T) int32.  smem_cap: the on-chip memory, in bytes, a read's sort may
// use: a read of more than min(smem_cap / 4, REG_EVENTS) events goes to
// (e), which sorts it in device memory when it needs more than
// min(smem_cap, SMEM_MAX) bytes.  After the call aux's nbig and ndev hold
// the reads that went to (e) and those of them sorted in device memory.
extern "C" int ma_sweep_events(const int32_t* seg, const int32_t* key,
                               int64_t n, int64_t T, int min_dp,
                               int end_clip, int32_t* buf, int32_t* aux,
                               int smem_cap, int32_t* out,
                               cudaStream_t stream) {
    if (T <= 0 || T > 0x7fffffff || n < 0 || n > 0x7fffffff)
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t has_words = (T + 3) / 4;
    int32_t* cnt = aux;
    uint8_t* has = reinterpret_cast<uint8_t*>(aux + T);
    int32_t* nbig = aux + T + has_words;
    int32_t* ndev = nbig + 1;
    int32_t* total = ndev + 1;
    int32_t* off = total + 1;
    int32_t* cur = off + T;
    int32_t* big = cur + T;
    uint32_t* keys = reinterpret_cast<uint32_t*>(buf);
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = allow_big_smem(ev_sweep_big_kernel, sweep_smem_done, dev);
    if (e == cudaSuccess)
        e = cudaMemsetAsync(aux, 0, (T + has_words + 3) * sizeof(int32_t),
                            stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    const uint32_t uT = static_cast<uint32_t>(T);
    const unsigned ev_blocks = n_blocks(n, EV_THREADS * EV_ITEMS);
    if (n > 0)
        ev_count_kernel<<<ev_blocks, EV_THREADS, 0, stream>>>(
            seg, key, n, uT, cnt, has);
    ev_alloc_kernel<<<n_blocks(T, ALLOC_THREADS), ALLOC_THREADS, 0,
                      stream>>>(cnt, T, total, off, cur);
    if (n > 0)
        ev_scatter_kernel<<<ev_blocks, EV_THREADS, 0, stream>>>(
            seg, key, n, uT, cur, keys);
    const uint32_t cap =
        static_cast<uint32_t>(smem_cap > 0 ? smem_cap : 0) / 4;
    ev_sweep_warp_kernel<<<n_blocks(T, SW_WARPS), SW_WARPS * 32, 0,
                           stream>>>(
        keys, off, cnt, has, T, min_dp, end_clip,
        cap < REG_EVENTS ? cap : REG_EVENTS, out, big, nbig);
    const uint32_t smem_keys = cap < SMEM_MAX / 4 ? cap : SMEM_MAX / 4;
    ev_sweep_big_kernel<<<static_cast<unsigned int>(T < sms ? T : sms),
                          BIG_THREADS, static_cast<size_t>(smem_keys) * 4,
                          stream>>>(
        keys, off, cnt, T, min_dp, end_clip, smem_keys, out, big, nbig,
        ndev);
    return static_cast<int>(cudaGetLastError());
}

// K12.  qid, tid, flags: n int32 (the colmat's rows 0, 3, 6); out: K1's
// final-pass output (15, n); tab: T int32, zeroed here, then per read the
// max of its rows' mark words (bit 0 used, 1 contained, 2 palindrome).
extern "C" int ma_read_marks(const int32_t* qid, const int32_t* tid,
                             const int32_t* flags, const int32_t* out,
                             int64_t n, int64_t T, int32_t* tab,
                             cudaStream_t stream) {
    if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaMemsetAsync(tab, 0, T * sizeof(int32_t), stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int threads = 256;
    if (n > 0)
        read_marks_kernel<<<n_blocks(n, threads), threads, 0, stream>>>(
            qid, tid, flags, out, n, T, tab);
    return static_cast<int>(cudaGetLastError());
}

// K13.  qid, qs0, tid, ts0: n int32 (the colmat's rows 0, 1, 3, 4: the
// ORIGINAL starts); out: K1's final-pass output (15, n); tab: K12's T
// words; mdel: T bytes, the merged sub-deletion; keys: 2n uint64 of
// scratch; aux: 4T + 2 + ceil(T / 1024) int32 of scratch, laid out
// cnt[T] | nbig | ndev | off[T] | cur[T] | big[T] | bsum; res: 3 + 10n
// int32 (see K13 above).  smem_cap as K2's.  After the call aux's nbig and
// ndev hold the reads sorted by a block and those of them sorted in
// device memory.
extern "C" int ma_arc_order(const int32_t* qid, const int32_t* qs0,
                            const int32_t* tid, const int32_t* ts0,
                            const int32_t* out, int64_t n,
                            const int32_t* tab, const uint8_t* mdel,
                            int64_t T, uint64_t* keys, int32_t* aux,
                            int smem_cap, int32_t* res,
                            cudaStream_t stream) {
    if (T <= 0 || T > 0x7fffffff || n < 0 || n >= (int64_t{1} << 30))
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t cap = 2 * n;
    const int64_t nb = (T + SCAN_THREADS - 1) / SCAN_THREADS;
    int32_t* cnt = aux;
    int32_t* nbig = cnt + T;
    int32_t* ndev = nbig + 1;
    int32_t* off = ndev + 1;
    int32_t* cur = off + T;
    int32_t* big = cur + T;
    int32_t* bsum = big + T;
    u64* k64 = reinterpret_cast<u64*>(keys);
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = allow_big_smem(arc_sort_big_kernel, arc_smem_done, dev);
    if (e == cudaSuccess)
        e = cudaMemsetAsync(aux, 0, (T + 2) * sizeof(int32_t), stream);
    if (e == cudaSuccess)
        e = cudaMemsetAsync(res, 0, 3 * sizeof(int32_t), stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    const unsigned row_blocks = n_blocks(n, ARC_THREADS);
    if (n > 0)
        arc_count_kernel<<<row_blocks, ARC_THREADS, 0, stream>>>(
            qid, tid, out, tab, mdel, n, T, cnt, res);
    scan_sums_kernel<<<static_cast<unsigned>(nb), SCAN_THREADS, 0, stream>>>(
        cnt, T, bsum);
    scan_blocks_kernel<<<1, SCAN_THREADS, 0, stream>>>(bsum, nb, res);
    scan_offsets_kernel<<<static_cast<unsigned>(nb), SCAN_THREADS, 0,
                          stream>>>(cnt, T, bsum, off, cur);
    if (n > 0)
        arc_scatter_kernel<<<row_blocks, ARC_THREADS, 0, stream>>>(
            qid, qs0, tid, ts0, out, tab, mdel, n, T, cur, k64);
    const uint32_t cap_keys =
        static_cast<uint32_t>(smem_cap > 0 ? smem_cap : 0) / 8;
    arc_sort_warp_kernel<<<n_blocks(T, SW_WARPS), SW_WARPS * 32, 0,
                           stream>>>(
        k64, off, cnt, T, cap_keys < REG_EVENTS ? cap_keys : REG_EVENTS, out,
        n, cap, res, big, nbig);
    const uint32_t smem_keys =
        cap_keys < SMEM_MAX / 8 ? cap_keys : SMEM_MAX / 8;
    arc_sort_big_kernel<<<static_cast<unsigned int>(T < sms ? T : sms),
                          BIG_THREADS, static_cast<size_t>(smem_keys) * 8,
                          stream>>>(
        k64, off, cnt, smem_keys, out, n, cap, res, big, nbig, ndev);
    return static_cast<int>(cudaGetLastError());
}

// K19.  qid, qs0, tid, ts0, gid: n int32 (the step's rows 0, 1, 3, 4, 7:
// the ORIGINAL starts), n below 2**30; out: K1's final-pass output (15,
// n); marks: (3, T) int32 0/1 [used cont pal], OR-reduced over the ranks;
// mdel: T bytes, the merged sub-deletion; cnt: two int64 [m_contained,
// n_arc]; bsum: bsum_words int32 of scratch, three a block (the grid
// takes at most bsum_words / 3 blocks); spill: spill_words int32 for the
// blocks' lane bits where they do not fit in shared memory, at least
// coop_spill_words(n, 2) (common.cuh); smem_cap: the most bytes of shared
// memory they may take (0: what the card allows); arcs: 14n int32, of
// which the first 7 n_arc hold the arcs as 7 rows of n_arc words.  grid:
// 4 host ints, as K16's (compact.cu).  Fails where the card cannot launch
// a cooperative kernel.
extern "C" int ma_shard_arcs(const int32_t* qid, const int32_t* qs0,
                             const int32_t* tid, const int32_t* ts0,
                             const int32_t* gid, const int32_t* out,
                             int64_t n, const int32_t* marks,
                             const uint8_t* mdel, int64_t T, int64_t* cnt,
                             int32_t* bsum, int64_t bsum_words,
                             int32_t* spill, int64_t spill_words,
                             int64_t smem_cap, int32_t* arcs, int* grid,
                             cudaStream_t stream) {
    grid[0] = grid[1] = grid[2] = grid[3] = 0;
    if (T <= 0 || T > 0x7fffffff || n < 0 || n >= (int64_t{1} << 30) ||
        bsum_words < 3)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0)
        return static_cast<int>(
            cudaMemsetAsync(cnt, 0, 2 * sizeof(int64_t), stream));
    const void* kernel = reinterpret_cast<const void*>(shard_arcs_kernel);
    CoopPlan plan;
    cudaError_t e = coop_plan(
        kernel, n, 2,
        static_cast<int>(std::min<int64_t>(bsum_words / 3, 1 << 30)),
        smem_cap, spill ? spill_words : 0, &plan);
    if (e != cudaSuccess) return static_cast<int>(e);
    ShardArcs a = {qid,  qs0,  tid,    ts0,    gid,        out,
                   marks, mdel, n,     T,      plan.J,     plan.W,
                   plan.chunk, plan.spill ? spill : nullptr, plan.spill,
                   bsum, cnt,  arcs};
    grid[0] = plan.grid;
    grid[1] = static_cast<int>(plan.chunk);
    grid[2] = plan.max_grid;
    grid[3] = static_cast<int>(plan.spill);
    void* args[] = {&a};
    e = cudaLaunchCooperativeKernel(kernel, dim3(plan.grid),
                                    dim3(COOP_THREADS), args, plan.smem,
                                    stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}
