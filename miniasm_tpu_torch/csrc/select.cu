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
// pass (fused2.py:401-426; hit.c:225-236, asm.c:9-39).  Row i raises the
// per-read word of its query (used, contained, palindrome: bits 0-2) and
// of its target (used, contained).  It is a max, not an or, because both
// packages reduce with amax: a palindromic self-hit row (5) and a row that
// marks the same read contained (3) leave 5.  A row with no valid lane
// adds nothing.  The lanes of a warp that mark one read raise its word by
// one atomic, and not where the word already holds as much
// (warp_max_batch, common.cuh): the loader keeps a query's rows together,
// so a warp's q-sides mostly share one word.  K13's launch runs these
// marks as its second phase; K12 alone serves the sharded step, whose
// marks are OR-ed across the ranks before its arc tail (K19).

// the words of B rows, i0 + u * stride, u < B, below lim, for their
// marks: loaded
// whatever the rows' lanes (nearly every row of the final pass has a
// valid lane), so that the loads go out together
template <int B>
struct MarkRows {
    int32_t bits[B], q[B], t[B], rq[B], rm[B];

    __device__ __forceinline__ void load(const int32_t* __restrict__ qid,
                                         const int32_t* __restrict__ tid,
                                         const int32_t* __restrict__ out,
                                         int64_t n, int64_t i0,
                                         int64_t stride, int64_t lim) {
#pragma unroll
        for (int u = 0; u < B; ++u) {
            const int64_t i = i0 + u * stride;
            bits[u] = q[u] = t[u] = rq[u] = rm[u] = 0;
            if (i < lim) {
                bits[u] = __ldg(out + 4 * n + i) & 3;
                q[u] = __ldg(qid + i);
                t[u] = __ldg(tid + i);
                rq[u] = __ldg(out + 5 * n + i);
                rm[u] = __ldg(out + 10 * n + i);
            }
        }
    }

    // the rows' mark words raised into tab[T]; every lane of the warp
    // calls it (a row past lim marks nothing).  With rowflag, each row's
    // byte for K13's count: its lanes (bits 0-1), its codes that are arcs
    // (bit 2 the q-side's, bit 3 the m-side's), a self hit (bit 4)
    __device__ __forceinline__ void raise(const int32_t* __restrict__ flags,
                                          const int32_t* __restrict__ out,
                                          int64_t n, int64_t T, int64_t i0,
                                          int64_t stride, int64_t lim,
                                          int32_t* tab, uint8_t* rowflag,
                                          int lane) const {
        int32_t kq[B], vq_[B], kt[B], vt[B];
#pragma unroll
        for (int u = 0; u < B; ++u) {
            const int64_t i = i0 + u * stride;
            const bool vq = bits[u] & 1, vm = bits[u] & 2;
            // a palindromic self hit: reverse strand, equal cut coordinates
            const bool pal = vq && rq[u] >= 0 && q[u] == t[u] &&
                             __ldg(out + i) == __ldg(out + 2 * n + i) &&
                             __ldg(out + n + i) == __ldg(out + 3 * n + i) &&
                             ((__ldg(flags + i) >> 1) & 1);
            const int32_t cq = vq ? rq[u] : 0, cm = vm ? rm[u] : 0;
            kq[u] = bits[u] ? clamp_index(q[u], T) : -1;
            kt[u] = bits[u] ? clamp_index(t[u], T) : -1;
            vq_[u] = 1 | ((cq == MA_HT_QCONT || cm == MA_HT_TCONT) << 1) |
                     (pal << 2);
            vt[u] = 1 | ((cq == MA_HT_TCONT || cm == MA_HT_QCONT) << 1);
            if (rowflag && i < lim)
                __stcg(rowflag + i,
                       static_cast<uint8_t>(bits[u] | (rq[u] >= 0) << 2 |
                                            (rm[u] >= 0) << 3 |
                                            (q[u] == t[u]) << 4));
        }
        // the queries in runs, the targets lane by lane
        warp_max_batch<B, true>(tab, kq, vq_, lane);
        warp_max_batch<B, false>(tab, kt, vt, lane);
    }
};

__global__ void __launch_bounds__(256)
read_marks_kernel(const int32_t* __restrict__ qid,
                  const int32_t* __restrict__ tid,
                  const int32_t* __restrict__ flags,
                  const int32_t* __restrict__ out, int64_t n, int64_t T,
                  int32_t* __restrict__ tab) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
    MarkRows<1> m;
    m.load(qid, tid, out, n, i, 0, n);
    m.raise(flags, out, n, T, i, 0, n, tab, nullptr, threadIdx.x & 31);
}

// ---------------------------------------------------------------------------
// K13 arc_order: the select program's tail after the final cut pass
// (fused2.py:401-520): K12's marks, the flags row, and the arc compaction
// in the stable hit-key order.  An arc row is a valid lane whose hit2arc
// code is an arc (>= 0), not a self match, between two reads that survive
// (used, not sub-deleted, not contained: hit.c:237-251).  Row i < n is the
// q-side of original i, row n + i its m-side; the arcs go out ordered by
// the hit key (the side's read, its ORIGINAL start), ties in row order.
//
// It replaces a chain of 24 kernels and 3 memsets: K12's memset and
// kernel, 16 elementwise torch ops for the flags row, K13's two memsets
// and seven kernels (count, three scan launches, scatter, warp sort,
// block sort).  What bounds the work is bytes: each row's lane bits,
// reads and codes, mdel, each arc's start and four words read, the flags
// row and the arcs written; a pass over the rows costs more than the
// arcs, which are a few percent of the lanes.  So it is one cooperative
// launch of every block the card holds at once (coop_blocks), 256 threads
// a block, a contiguous range of rows and of reads a block, its phases
// apart by six grid syncs, with no memset:
//   1. zero: the per-read words tab[T] and arc counts cnt[T]; the head's
//      dup_hit and the tier counters (the first round's row words for
//      phase 2 are loaded before, to overlap);
//   2. marks: K12's MarkRows, TAIL_BATCH rows a thread in flight, and a
//      byte a row for phase 3 (its lanes, which codes are arcs, a self
//      hit), so that phase 3 reads that byte and the reads, not the codes;
//   3. count: each row's arc lanes from its byte, its reads, tab and mdel
//      (arc_rows), added to its reads' cnt (the queries by runs of a
//      warp, the targets lane by lane); each arc's hit key (its start, sign
//      bit flipped so that the unsigned order is the signed one, over its
//      row) and read to the block's own list; the block's m_contained
//      terms; the flags row (mdel | cont << 1 | used << 2 | pal << 3), a
//      thread a read;
//   4. offsets: the arcs of each block's chunk of reads and its
//      m_contained across the grid (grid_block_offsets, one more grid
//      sync), then each block scans its chunk's cnt and writes each read's
//      cursor, its first place in the output; block 0 writes the head's
//      m_contained and n_arc;
//   5. scatter: each block's list into the reads' buckets at the cursors
//      (one atomic a run of a read): a pass over the arcs, not the rows.
//      A bucket's order is arbitrary, but (start, row) is unique, so the
//      sort restores the stable order;
//   6. sort and write, a round of a block's reads at a time: the reads of
//      at most min(smem_cap / 8, REG_EVENTS) arcs sorted by a warp each in
//      registers, the warps taking them in turn, the larger by the whole
//      block, in TAIL_SMEM_KEYS keys of shared memory at most (a moderate
//      cap, so that the grid keeps every block it can hold), else in place
//      in device memory; each arc written to the five columns (u, v, l,
//      ol, the row) at a stride of n_arc; the neighbours of equal key
//      (dup_hit: equal starts within a read) to the head, one atomic a
//      block.
// Within the launch every word another block wrote is read through L2
// (__ldcg), and tab, written through L2 and by atomics until phase 2
// ends, through L1 only after it.

typedef unsigned long long u64;
constexpr int TAIL_THREADS = 256;
constexpr int TAIL_WARPS = TAIL_THREADS / 32;
constexpr int TAIL_BATCH = 4;         // rows a thread has in flight
constexpr int TAIL_SMEM_KEYS = 2048;  // a block-sorted read in shared memory
constexpr int TAIL_SYNCS = 6;
constexpr int TAIL_MIN_BLOCKS = 3;    // blocks an SM: at most 85 registers

struct SelectTail {
    const int32_t *qid, *qs0, *tid, *ts0, *flags, *out;
    const uint8_t* mdel;
    int64_t n, T, n_meta;
    int64_t rows;        // rows a block (phases 2, 3 and 5)
    int64_t chunk;       // reads a block (phases 4 and 6)
    uint32_t warp_cap;   // the largest read sorted by a warp
    uint32_t smem_keys;  // the largest read sorted in shared memory
    int32_t *tab, *cnt, *cur;  // T words each
    int32_t* bsum;  // two words a block: its chunk's arcs, its m_contained
    int32_t* aux;   // [reads sorted by a block, of them in device memory]
    u64* keys;      // 2n: the buckets
    u64* list_key;  // 2 rows a block: the block's arcs, in no order
    int32_t* list_read;
    uint8_t* rowflag;  // n: MarkRows::raise's byte a row
    int32_t *head, *flags_row, *arcs;
};

// rows i0 + u * stride, u < B, below lim: each row's arc lanes as its
// reads (kq: the q-side's read, kt: the m-side's, -1 where that side is
// no arc), its m_contained terms (the valid lanes between two surviving
// reads) added to mc, and the arc sides' ORIGINAL starts (sq, st).  Each
// level's loads are issued together: a row's byte from phase 2 and its
// reads, then the marks and mdel of both reads (tab through L1: no SM
// holds a copy of it from before the marks were done, see phase 1), then
// the starts of the arcs.
template <int B>
__device__ __forceinline__ void arc_rows(const SelectTail& p, int64_t i0,
                                         int64_t stride, int64_t lim,
                                         int32_t (&kq)[B], int32_t (&kt)[B],
                                         int32_t& mc, int32_t (&sq)[B],
                                         int32_t (&st)[B]) {
    const int64_t T = p.T;
    int32_t fl[B], q[B], t[B], wq[B], wt[B];
    uint8_t dq[B], dt[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
        const int64_t i = i0 + u * stride;
        fl[u] = q[u] = t[u] = 0;
        if (i < lim) {
            fl[u] = __ldcg(p.rowflag + i);
            q[u] = clamp_index(__ldg(p.qid + i), T);
            t[u] = clamp_index(__ldg(p.tid + i), T);
        }
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
        wq[u] = wt[u] = 0;
        dq[u] = dt[u] = 1;
        if (fl[u] & 3) {
            wq[u] = __ldca(p.tab + q[u]);
            wt[u] = __ldca(p.tab + t[u]);
            dq[u] = __ldg(p.mdel + q[u]);
            dt[u] = __ldg(p.mdel + t[u]);
        }
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
        const int64_t i = i0 + u * stride;
        // read_alive = used & ~cont & ~mdel, for both reads
        const bool alive = (wq[u] & 1) && !(wq[u] & 2) && !dq[u] &&
                           (wt[u] & 1) && !(wt[u] & 2) && !dt[u];
        if (alive) mc += (fl[u] & 1) + ((fl[u] >> 1) & 1);
        const bool arc = alive && !(fl[u] & 16);
        kq[u] = arc && (fl[u] & 5) == 5 ? q[u] : -1;
        kt[u] = arc && (fl[u] & 10) == 10 ? t[u] : -1;
        sq[u] = kq[u] >= 0 ? __ldg(p.qs0 + i) : 0;
        st[u] = kt[u] >= 0 ? __ldg(p.ts0 + i) : 0;
    }
}

// the hit key of an arc: its side's ORIGINAL start (sign bit flipped, so
// that the unsigned order is the signed one) over its row
__device__ __forceinline__ u64 hit_key(int32_t start, int64_t row) {
    return (static_cast<u64>(static_cast<uint32_t>(start) ^ 0x80000000u)
            << 32) | static_cast<uint32_t>(row);
}

// the arc of sorted key k at output position p of the (5, na) columns
__device__ __forceinline__ void write_arc(const int32_t* __restrict__ out,
                                          int64_t n, int64_t na,
                                          int32_t* __restrict__ cols,
                                          int64_t p, u64 k) {
    const int64_t row = static_cast<uint32_t>(k);
    const int64_t src = row < n ? 6 * n + row : 11 * n + (row - n);
    cols[p] = __ldg(out + src);
    cols[na + p] = __ldg(out + src + n);
    cols[2 * na + p] = __ldg(out + src + 2 * n);
    cols[3 * na + p] = __ldg(out + src + 3 * n);
    cols[4 * na + p] = static_cast<int32_t>(row);
}

// one read of cnt <= 32 * E arcs at keys[base...], sorted by a warp in
// registers and written; returns the lane's neighbours of equal key
template <int E>
__device__ __forceinline__ int32_t arc_sort_warp(const SelectTail& p,
                                                 uint32_t cnt, int64_t base,
                                                 int64_t na, int lane) {
    u64 x[E];
    const uint32_t first = static_cast<uint32_t>(lane) * E;
#pragma unroll
    for (int e = 0; e < E; ++e)
        x[e] = first + e < cnt ? __ldcg(p.keys + base + first + e) : ~0ull;
    reg_sort<E>(x, lane);
    u64 prev = __shfl_up_sync(FULL, x[E - 1], 1);
    int32_t dups = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const uint32_t q = first + e;
        if (q < cnt) {
            write_arc(p.out, p.n, na, p.arcs, base + q, x[e]);
            if (q > 0 && (prev >> 32) == (x[e] >> 32)) ++dups;
        }
        prev = x[e];
    }
    return dups;
}

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
    return a < b ? a : b;
}

// the sum of x over the block; sh: TAIL_WARPS words of shared memory
__device__ __forceinline__ int32_t tail_block_sum(int32_t x, int32_t* sh) {
    x = __reduce_add_sync(FULL, x);
    __syncthreads();  // sh's readers before
    if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = x;
    __syncthreads();
    int32_t s = 0;
    for (int k = 0; k < TAIL_WARPS; ++k) s += sh[k];
    return s;
}

__global__ void __launch_bounds__(TAIL_THREADS, TAIL_MIN_BLOCKS)
arc_order_kernel(SelectTail p) {
    extern __shared__ u64 skeys[];
    __shared__ int32_t sh[4 * 32];
    // a round's reads of arcs: those for the warps, those for the block
    __shared__ int32_t wr_read[TAIL_THREADS], wr_cnt[TAIL_THREADS],
        big_read[TAIL_THREADS];
    __shared__ int64_t wr_base[TAIL_THREADS];
    __shared__ int32_t n_list, n_warp, n_big;
    cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int64_t n = p.n, T = p.T;
    const int64_t g0 = static_cast<int64_t>(blockIdx.x) * TAIL_THREADS +
                       threadIdx.x;
    const int64_t gstride = static_cast<int64_t>(gridDim.x) * TAIL_THREADS;
    // block b takes the rows [row0, row1), in rounds of TAIL_BATCH *
    // TAIL_THREADS: row b0 + threadIdx.x + u * TAIL_THREADS, u <
    // TAIL_BATCH, of round b0 (the same rounds in every thread: the warp
    // intrinsics need every lane); and the reads [r0, r1)
    const int64_t rnd = static_cast<int64_t>(TAIL_BATCH) * TAIL_THREADS;
    const int64_t row0 = lmin(n, static_cast<int64_t>(blockIdx.x) * p.rows);
    const int64_t row1 = lmin(n, row0 + p.rows);
    const int64_t r0 = lmin(T, static_cast<int64_t>(blockIdx.x) * p.chunk);
    const int64_t r1 = lmin(T, r0 + p.chunk);
    // the block's arc list: 2 rows' room a row
    u64* const lkey = p.list_key + 2 * blockIdx.x * p.rows;
    int32_t* const lread = p.list_read + 2 * blockIdx.x * p.rows;

    // the first round's words for the marks, loaded before the zeroing
    // and its grid sync, so that their latency overlaps both
    MarkRows<TAIL_BATCH> marks;
    marks.load(p.qid, p.tid, p.out, n, row0 + threadIdx.x, TAIL_THREADS,
               row1);

    // ---- 1. zero (through L2: no SM may keep a line of tab in L1 until
    // the marks are done) ----
    for (int64_t r = g0; r < T; r += gstride) {
        __stcg(p.tab + r, 0);
        __stcg(p.cnt + r, 0);
    }
    if (g0 == 0) {
        p.head[2] = 0;
        p.aux[0] = p.aux[1] = 0;
    }
    if (threadIdx.x == 0) n_list = 0;
    grid.sync();

    // ---- 2. marks ----
    for (int64_t b0 = row0; b0 < row1; b0 += rnd) {
        if (b0 != row0)
            marks.load(p.qid, p.tid, p.out, n, b0 + threadIdx.x,
                       TAIL_THREADS, row1);
        marks.raise(p.flags, p.out, n, T, b0 + threadIdx.x, TAIL_THREADS,
                    row1, p.tab, p.rowflag, lane);
    }
    grid.sync();

    // ---- 3. count: the arcs to their reads' counts and to the block's
    // list; the m_contained terms; the flags row ----
    int32_t mc = 0;
    for (int64_t r = g0; r < p.n_meta; r += gstride) {
        const int32_t m = __ldca(p.tab + r);
        p.flags_row[r] = (__ldg(p.mdel + r) ? 1 : 0) | (m & 2) |
                         ((m & 1) << 2) | ((m & 4) << 1);
    }
    for (int64_t b0 = row0; b0 < row1; b0 += rnd) {
        const int64_t i0 = b0 + threadIdx.x;
        int32_t kq[TAIL_BATCH], kt[TAIL_BATCH], sq[TAIL_BATCH],
            st[TAIL_BATCH];
        arc_rows<TAIL_BATCH>(p, i0, TAIL_THREADS, row1, kq, kt, mc, sq, st);
        // the queries by runs, the targets lane by lane (a chunk count
        // a read's arc here would cost more than the sync phase 4 takes)
        warp_count_runs<TAIL_BATCH>(p.cnt, kq, lane);
#pragma unroll
        for (int u = 0; u < TAIL_BATCH; ++u)
            if (kt[u] >= 0) atomicAdd(p.cnt + kt[u], 1);
        // each side's arcs of the warp in lane order, at one shared
        // atomic a side: the q-sides of a query stay together
#pragma unroll
        for (int k = 0; k < 2 * TAIL_BATCH; ++k) {
            const int u = k >> 1;
            const int32_t rd = k & 1 ? kt[u] : kq[u];
            const unsigned has = __ballot_sync(FULL, rd >= 0);
            if (!has) continue;  // the whole warp
            int32_t at = 0;
            if (lane == 0) at = atomicAdd(&n_list, __popc(has));
            at = __shfl_sync(FULL, at, 0) + __popc(has & lanes_below(lane));
            if (rd >= 0) {
                const int64_t i = i0 + u * TAIL_THREADS;
                __stcg(lkey + at, hit_key(k & 1 ? st[u] : sq[u],
                                          k & 1 ? n + i : i));
                __stcg(lread + at, rd);
            }
        }
    }
    mc = tail_block_sum(mc, sh);
    grid.sync();

    // ---- 4. offsets: the arcs of the block's chunk of reads and its
    // m_contained, across the grid (grid_block_offsets syncs it), then
    // each read's cursor, its first place in the output ----
    int64_t na;  // n_arc
    {
        const int32_t c0 = r0 + threadIdx.x < r1
                               ? __ldcg(p.cnt + r0 + threadIdx.x) : 0;
        int32_t mine = c0;
        for (int64_t r = r0 + threadIdx.x + TAIL_THREADS; r < r1;
             r += TAIL_THREADS)
            mine += __ldcg(p.cnt + r);
        const int32_t counts[2] = {tail_block_sum(mine, sh), mc};
        int32_t before[2], total[2];
        grid_block_offsets<2>(counts, p.bsum, before, total, sh);
        na = total[0];
        if (blockIdx.x == 0 && threadIdx.x == 0) {
            p.head[0] = total[1];
            p.head[1] = total[0];
        }
        int32_t carry = before[0];
        for (int64_t s0 = r0; s0 < r1; s0 += TAIL_THREADS) {
            const int64_t r = s0 + threadIdx.x;
            const int32_t x = s0 == r0 ? c0 : r < r1 ? __ldcg(p.cnt + r) : 0;
            int32_t tot;
            const int32_t ex = block_excl_scan(x, sh, &tot);
            if (r < r1) __stcg(p.cur + r, carry + ex);
            carry += tot;
        }
    }
    grid.sync();

    // ---- 5. scatter: the block's arcs from its list into their reads'
    // buckets, at the cursors ----
    for (int32_t e0 = 0; e0 < n_list; e0 += TAIL_THREADS) {
        const int32_t e = e0 + threadIdx.x;
        int32_t rd = -1;
        u64 k = 0;
        if (e < n_list) {
            rd = __ldcg(lread + e);
            k = __ldcg(lkey + e);
        }
        const int32_t slot = warp_slot(p.cur, rd, lane);
        if (rd >= 0) __stcg(p.keys + slot, k);
    }
    grid.sync();

    // ---- 6. sort and write, a round of the chunk's reads at a time: the
    // reads of at most warp_cap arcs by the warps, in turn, then the larger
    // ones by the whole block ----
    int32_t dups = 0;
    for (int64_t s0 = r0; s0 < r1; s0 += TAIL_THREADS) {
        if (threadIdx.x == 0) n_warp = n_big = 0;
        __syncthreads();
        const int64_t r = s0 + threadIdx.x;
        if (r < r1) {
            const int32_t c = __ldcg(p.cnt + r);
            const int32_t end = __ldcg(p.cur + r);
            if (c > 0 && static_cast<uint32_t>(c) <= p.warp_cap) {
                const int k = atomicAdd(&n_warp, 1);
                wr_read[k] = static_cast<int32_t>(r);
                wr_cnt[k] = c;
                wr_base[k] = static_cast<int64_t>(end) - c;
            } else if (c > 0) {
                big_read[atomicAdd(&n_big, 1)] = static_cast<int32_t>(r);
            }
        }
        __syncthreads();
        for (int k = w; k < n_warp; k += TAIL_WARPS) {  // the whole warp
            const uint32_t c = static_cast<uint32_t>(wr_cnt[k]);
            const int64_t base = wr_base[k];
            if (c <= 32) {
                dups += arc_sort_warp<1>(p, c, base, na, lane);
            } else if (c <= 64) {
                dups += arc_sort_warp<2>(p, c, base, na, lane);
            } else if (c <= 128) {
                dups += arc_sort_warp<4>(p, c, base, na, lane);
            } else {
                dups += arc_sort_warp<REG_EVENTS / 32>(p, c, base, na,
                                                       lane);
            }
        }
        for (int k = 0; k < n_big; ++k) {
            const int64_t rb = big_read[k];
            const uint32_t c = static_cast<uint32_t>(__ldcg(p.cnt + rb));
            const int64_t base = __ldcg(p.cur + rb) - static_cast<int64_t>(c);
            u64* a = p.keys + base;
            if (c <= p.smem_keys) {
                for (uint32_t i = threadIdx.x; i < c; i += TAIL_THREADS)
                    skeys[i] = __ldcg(a + i);
                a = skeys;
            }
            if (threadIdx.x == 0) {
                atomicAdd(p.aux, 1);
                if (c > p.smem_keys) atomicAdd(p.aux + 1, 1);
            }
            __syncthreads();
            bitonic_sort(a, c);
            __syncthreads();
            for (uint32_t q = threadIdx.x; q < c; q += TAIL_THREADS) {
                write_arc(p.out, n, na, p.arcs, base + q, a[q]);
                if (q > 0 && (a[q - 1] >> 32) == (a[q] >> 32)) ++dups;
            }
            __syncthreads();  // before the next read reuses skeys
        }
        __syncthreads();  // before the lists are reset
    }
    // dup_hit: one atomic a block
    dups = tail_block_sum(dups, sh);
    if (threadIdx.x == 0 && dups) atomicAdd(p.head + 2, dups);
}

// (e)'s dynamic shared memory may reach SMEM_MAX: raised once per device
template <typename F>
cudaError_t allow_big_smem(F kernel, std::atomic<uint64_t>& done, int dev) {
    const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
    if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
    return e;
}

std::atomic<uint64_t> sweep_smem_done{0};

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
    const uint32_t lt = lanes_below(lane);
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

// K13, with K12's marks.  qid, qs0, tid, ts0, flags: n int32 (the
// colmat's rows 0, 1, 3, 4, 6: the ORIGINAL starts), n below 2**30; out:
// K1's final-pass output (15, n); mdel: T bytes, the merged sub-deletion;
// n_meta: the reads of the flags row (at most T); max_grid: the most
// blocks; scratch: 3T + 4 max_grid + 2 + 2n + ceil(n / 4) int32, laid
// out tab[T] | cnt[T] | cur[T] | bsum[2 max_grid] | aux[2] (the reads
// sorted by a block, those of them sorted in device memory) |
// list_read[2n + 2 max_grid] | rowflag[n bytes]; keys: 4n + 2 max_grid
// uint64: the buckets [2n] | list_key[2n + 2 max_grid]; head: 3 int32 [m_contained, n_arc, dup_hit]; flags_row:
// n_meta int32; arcs: 5 rows of n_arc int32 (at most 10n words): u, v, l,
// ol, row.  smem_cap: the on-chip bytes a read's sort may take: a read of
// more than min(smem_cap / 8, REG_EVENTS) arcs is sorted by a block, in
// shared memory where it needs at most min(smem_cap, 8 TAIL_SMEM_KEYS)
// bytes, else in device memory.  grid: 4 host ints, [the blocks launched,
// the reads a block, the most blocks the card holds with this launch's
// shared memory, the grid syncs].  Fails where the card cannot launch a
// cooperative kernel.
extern "C" int ma_arc_order(const int32_t* qid, const int32_t* qs0,
                            const int32_t* tid, const int32_t* ts0,
                            const int32_t* flags, const int32_t* out,
                            int64_t n, const uint8_t* mdel, int64_t T,
                            int64_t n_meta, int32_t* scratch,
                            int64_t max_grid, uint64_t* keys, int smem_cap,
                            int32_t* head, int32_t* flags_row, int32_t* arcs,
                            int* grid, cudaStream_t stream) {
    grid[0] = grid[1] = grid[2] = grid[3] = 0;
    if (T <= 0 || T > 0x7fffffff || n < 0 || n >= (int64_t{1} << 30) ||
        n_meta < 0 || n_meta > T || max_grid < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const uint32_t cap_keys =
        static_cast<uint32_t>(smem_cap > 0 ? smem_cap : 0) / 8;
    const uint32_t smem_keys = std::min<uint32_t>(cap_keys, TAIL_SMEM_KEYS);
    const void* kernel = reinterpret_cast<const void*>(arc_order_kernel);
    const size_t smem = static_cast<size_t>(smem_keys) * 8;
    // every block the card holds at once, at most those the rows (a round
    // a block) and the reads need
    const int64_t rnd = static_cast<int64_t>(TAIL_BATCH) * TAIL_THREADS;
    const int64_t need = std::max((n + rnd - 1) / rnd,
                                  (T + TAIL_THREADS - 1) / TAIL_THREADS);
    int most = 0;
    cudaError_t e = coop_blocks(kernel, TAIL_THREADS, smem, max_grid, &most);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int blocks = static_cast<int>(std::min<int64_t>(most, need));
    SelectTail p;
    p.qid = qid;
    p.qs0 = qs0;
    p.tid = tid;
    p.ts0 = ts0;
    p.flags = flags;
    p.out = out;
    p.mdel = mdel;
    p.n = n;
    p.T = T;
    p.n_meta = n_meta;
    p.rows = std::max<int64_t>(1, (n + blocks - 1) / blocks);
    p.chunk = (T + blocks - 1) / blocks;
    p.warp_cap = std::min<uint32_t>(cap_keys, REG_EVENTS);
    p.smem_keys = smem_keys;
    p.tab = scratch;
    p.cnt = scratch + T;
    p.cur = scratch + 2 * T;
    p.bsum = scratch + 3 * T;
    p.aux = p.bsum + 2 * max_grid;
    p.list_read = p.aux + 2;
    p.rowflag = reinterpret_cast<uint8_t*>(p.list_read + 2 * n + 2 * max_grid);
    p.keys = reinterpret_cast<u64*>(keys);
    p.list_key = p.keys + 2 * n;
    p.head = head;
    p.flags_row = flags_row;
    p.arcs = arcs;
    // the block lists hold 2 rows a block: 2 blocks rows <= 2n + 2 blocks
    grid[0] = blocks;
    grid[1] = static_cast<int>(p.chunk);
    grid[2] = most;
    grid[3] = TAIL_SYNCS;
    void* args[] = {&p};
    e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(TAIL_THREADS),
                                    args, smem, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
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
