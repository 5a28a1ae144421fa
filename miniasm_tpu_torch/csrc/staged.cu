// Kernels of the staged selection path (-1, -2, -S below 5; port of the
// per-pass JAX programs that miniasm_tpu/pipeline.py:96-151 runs), and K6,
// the graft entry's tail.
//
// K5 takes the hits as one (9, n) int32 matrix, rows
// [qid qs qe tid ts te ml bl rev] (uint32 columns as bit patterns), and
// runs one thread per hit.  It is bound by device-memory bytes: about 45
// bytes a hit against a few tens of int32 operations, so about 20 us per
// pass at 1.4 M hits on an H100; the per-read tables it gathers from are
// a few hundred KB and stay in L2.
//
// K5 hit_cut replaces miniasm_tpu/select/cut.py:16 (ma_hit_cut,
// hit.c:162-193).  Per hit it reads 7 words and gathers 3 table words for
// each of its two reads; it writes 4 int32 coordinates and a keep byte.
// All four clamps compare as uint32 (cut.py:51-56): the staged path's
// inputs are uint32 hit columns, so a projection may wrap below zero and
// must then lose the s-side max, unlike K1's signed s-side.
//
// K6 hit2arc replaces the hit2arc program (miniasm_tpu/core/hit2arc.py:28,
// ma_hit2arc, miniasm.h:86-104) as the graft entry's forward step calls it
// (__graft_entry__.py:60-65; the port's eval/dryrun.py:entry): the whole
// step after K5 in one launch.  Per column it reads qid, tid, rev and
// valid where they lie in the entry's (10, n) columns (by row stride),
// K5's 4 coordinates and keep byte, and the two reads' lengths e - s from
// the (3, T) trim table (wrapping int32 differences of the uint32 bits,
// the ids taken as jnp's gather takes them); it writes the 5 int32 rows
// [r u v l ol] and good = keep & valid & r >= 0, and the threads below T
// write sub_del = del != 0, so the grid covers max(n, T).  At the entry's
// 4,096 columns and 74 reads a launch costs its latency, not its 0.2 MB:
// so the lengths, good and sub_del are made here, not by torch ops around
// the kernel, and the one chain of dependent loads is kept short, a
// column a thread in blocks of 256:
// the lengths are gathered from the table, which K2 has just written to
// L2 (blocks that stage them in shared memory first, behind a barrier,
// take as long; one block of 1,024 threads with four columns each issues
// from one SM and takes three times as long).  No staged pass calls it
// (K17 and K18 classify there).
//
// K17 hit_flt replaces the whole of miniasm_tpu/select/filter.py:16
// (ma_hit_flt, hit.c:195-216) and the reductions pipeline.py:120-122 runs
// after it: per hit the trim-table lengths (wrapping int32 differences, the
// indices clamped as K5's), the alive test, hit2arc at the relaxed
// parameters (int_frac 0.5), the keep byte and dp; per block the int64 sum
// of the kept dp and one atomic add; for each kept hit the present byte
// of its query, the set flt_coverage sums the lengths of (byte stores of 1
// need no atomics).  Bound by bytes, as K5.
//
// K18 hit_marks is hit2arc with per-read byte marks, in two launches:
//   contained (select/contained.py:19 contained_marks with core/hits.py:106
//     mark_unused, ma_hit_contained and ma_hit_mark_unused): one launch
//     for the containment pass's two (T,) byte tables, [contained | used]:
//     QCONT marks the query and TCONT the target in the first, every hit
//     both its reads in the second;
//   sg (graph/asg.py:160-190, ma_sg_gen): a reverse self-palindrome or
//     QCONT marks the query; the hit's arc-row keep byte (r >= 0, not a
//     self match) and its arc columns [u v l ol], which K16 compacts.
// Bound by bytes: 7 words a hit and the two lengths in, two byte tables
// (contained) or a byte table and 4 words and a byte a hit (sg) out.
//
// The containment pass launched twice, each a thread a hit storing its
// marks to device memory: the used call stored a byte for every hit's
// target, about 1.4 M stores in no order onto a 23 KB table, each one
// queueing on one of its 180 lines in L2 (on the E. coli set, 8.5 of the
// used call's 15.3 us).  Now one launch reads each hit once, and while
// the tables' bits fit in shared memory (CM_SMEM_READS reads: 48 KB, two
// bits a read), each block sets its hits' marks there (a shared atomic
// or, only where the bit is still clear), then stores the reads it set,
// a warp's stores 128 consecutive bytes each: per block a store per line
// of the table at most, where the hits made one each.  The query side is
// sorted, so a warp marks a run of equal qids once.  The blocks stay for
// the whole pass (CM_BLOCKS_SM an SM), each taking rounds of CM_ROUND
// hits and loading the next round's words while it marks; past
// CM_SMEM_READS each hit stores its marks to device memory as before, in
// the same single launch.  What is left over the
// parent's contained call alone is the memset of the two tables and the
// blocks' stores of the used table (PERF.md, section 6): a cluster
// sharing one copy of the bitmaps through distributed shared memory
// stores less but paid more for its remote atomics.
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

// a read id as jnp's gather x[i] takes it: a negative id counts from the
// end, then the index is clamped to [0, T)
__device__ __forceinline__ int32_t jnp_index(int32_t i, int64_t T) {
    return clamp_index(i < 0 ? i + static_cast<int32_t>(T) : i, T);
}

// K6's grid: H2A_PER columns a thread, strided by the block, in blocks of
// H2A_THREADS, over the larger of the n columns and the T reads.  Of the
// two grids tried at the entry's 4,096 columns, a column a thread in 16
// blocks of 256 took a third of the time of one block of 1,024 threads
// with four columns each (PERF.md, section 6).
constexpr int H2A_THREADS = 256, H2A_PER = 1;

// K6.
__global__ void hit2arc_kernel(const int32_t* __restrict__ cols, int64_t ld,
                               int64_t n, const int32_t* __restrict__ coords,
                               const uint8_t* __restrict__ keep,
                               const int32_t* __restrict__ sub, int64_t T,
                               int32_t max_hang, float int_frac,
                               int32_t min_ovlp, int32_t* __restrict__ arcs,
                               uint8_t* __restrict__ good,
                               uint8_t* __restrict__ sub_del) {
    const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x *
                          H2A_PER + threadIdx.x;
#pragma unroll
    for (int k = 0; k < H2A_PER; ++k) {
        const int64_t i = first + static_cast<int64_t>(k) * blockDim.x;
        if (i < T) sub_del[i] = sub[2 * T + i] != 0 ? 1 : 0;
        if (i >= n) continue;
        const int32_t q = cols[i], t = cols[3 * ld + i];
        const int32_t qi = jnp_index(q, T), ti = jnp_index(t, T);
        const int32_t ql = wsub(sub[T + qi], sub[qi]);
        const int32_t tl = wsub(sub[T + ti], sub[ti]);
        const Arc a = hit2arc(q, coords[i], coords[n + i], t,
                              coords[2 * n + i], coords[3 * n + i],
                              cols[8 * ld + i] != 0 ? 1 : 0, ql, tl,
                              max_hang, int_frac, min_ovlp);
        arcs[i] = a.r;
        arcs[n + i] = a.u;
        arcs[2 * n + i] = a.v;
        arcs[3 * n + i] = a.l;
        arcs[4 * n + i] = a.ol;
        good[i] = keep[i] && cols[9 * ld + i] != 0 && a.r >= 0 ? 1 : 0;
    }
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

constexpr int MARK_CONTAINED = 0, MARK_SG = 1;
constexpr int CM_THREADS = 512;
constexpr int CM_PER = 2;  // hits a thread a round
constexpr int CM_ROUND = CM_THREADS * CM_PER;  // hits a block a round
constexpr int CM_BLOCKS_SM = 2;  // blocks an SM
// the reads whose two bitmaps a block holds in 48 KB
constexpr int64_t CM_SMEM_READS = 48 * 1024 * 8 / 2;

// set bit r of the shared bitmap b, reading it first: most marks are set
__device__ __forceinline__ void smem_mark(uint32_t* b, int32_t r) {
    const uint32_t m = 1u << (r & 31);
    if (!(b[r >> 5] & m)) atomicOr(b + (r >> 5), m);
}

// out[r] = 1 for every bit r set in b (under T): a thread 4 reads a
// round, so one store of the warp covers 128 consecutive bytes
__device__ __forceinline__ void flush_marks(const uint32_t* b, int64_t T,
                                            uint8_t* __restrict__ out) {
    for (int64_t g = threadIdx.x; 4 * g < T; g += blockDim.x) {
        const uint32_t nib = (b[g >> 3] >> (4 * (g & 7))) & 0xFu;
        if (!nib) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
            if ((nib >> j) & 1u) out[4 * g + j] = 1;
    }
}

// the 7 words [qid qs qe tid ts te rev] of the CM_PER hits a thread
// takes in the block's round from hit base (-1 past n)
__device__ __forceinline__ void load_round(const int32_t* __restrict__ hits,
                                           int64_t n, int64_t base,
                                           int32_t (&v)[CM_PER][7]) {
#pragma unroll
    for (int k = 0; k < CM_PER; ++k) {
        const int64_t i = base + k * CM_THREADS + threadIdx.x;
        if (i < n) {
            v[k][0] = hits[i];
            v[k][1] = hits[n + i];
            v[k][2] = hits[2 * n + i];
            v[k][3] = hits[3 * n + i];
            v[k][4] = hits[4 * n + i];
            v[k][5] = hits[5 * n + i];
            v[k][6] = hits[8 * n + i];
        } else {
            v[k][0] = v[k][1] = v[k][2] = v[k][3] = -1;
            v[k][4] = v[k][5] = v[k][6] = -1;
        }
    }
}

// The containment pass.  The hits go in rounds of CM_ROUND, block b
// taking rounds b, b + grid, ...: each thread loads its CM_PER hits' words
// before it classifies any, and the next round's while it marks.  SMEM:
// the marks in two bitmaps of W words in dynamic shared memory
// ([contained | used]), stored at the end; else straight to the tables.
template <bool SMEM>
__global__ void __launch_bounds__(CM_THREADS, CM_BLOCKS_SM)
    contained_marks_kernel(const int32_t* __restrict__ hits, int64_t n,
                           const int32_t* __restrict__ len, int64_t T,
                           int32_t max_hang, float int_frac,
                           int32_t min_ovlp, uint8_t* __restrict__ marks) {
    extern __shared__ uint32_t bits[];
    const int64_t W = (T + 31) >> 5;
    uint8_t* cont = marks;
    uint8_t* used = marks + T;
    if (SMEM) {
        for (int64_t w = threadIdx.x; w < 2 * W; w += CM_THREADS) bits[w] = 0;
        __syncthreads();
    }
    const int lane = threadIdx.x & 31;
    const int64_t step = static_cast<int64_t>(gridDim.x) * CM_ROUND;
    int64_t base = static_cast<int64_t>(blockIdx.x) * CM_ROUND;
    int32_t v[CM_PER][7];
    load_round(hits, n, base, v);
    for (; base < n; base += step) {
        int32_t qi[CM_PER], ti[CM_PER], ql[CM_PER], tl[CM_PER];
#pragma unroll
        for (int k = 0; k < CM_PER; ++k) {
            qi[k] = clamp_index(v[k][0], T);
            ti[k] = clamp_index(v[k][3], T);
            const bool ok = base + k * CM_THREADS + threadIdx.x < n;
            ql[k] = ok ? len[qi[k]] : 0;
            tl[k] = ok ? len[ti[k]] : 0;
        }
        // the next round's words load while this round is marked
        int32_t nv[CM_PER][7];
        load_round(hits, n, base + step, nv);
#pragma unroll
        for (int k = 0; k < CM_PER; ++k) {
            const bool ok = base + k * CM_THREADS + threadIdx.x < n;
            // the first lane of a run of equal queries marks it used
            const int32_t prev = __shfl_up_sync(FULL, qi[k], 1);
            if (!ok) continue;
            const bool head = lane == 0 || prev != qi[k];
            const int32_t r = hit2arc(v[k][0], v[k][1], v[k][2], v[k][3],
                                      v[k][4], v[k][5], v[k][6] != 0 ? 1 : 0,
                                      ql[k], tl[k], max_hang, int_frac,
                                      min_ovlp).r;
            if (SMEM) {
                if (head) smem_mark(bits + W, qi[k]);
                smem_mark(bits + W, ti[k]);
                if (r == MA_HT_QCONT) smem_mark(bits, qi[k]);
                if (r == MA_HT_TCONT) smem_mark(bits, ti[k]);
            } else {
                if (head) used[qi[k]] = 1;
                used[ti[k]] = 1;
                if (r == MA_HT_QCONT) cont[qi[k]] = 1;
                if (r == MA_HT_TCONT) cont[ti[k]] = 1;
            }
        }
#pragma unroll
        for (int k = 0; k < CM_PER; ++k)
#pragma unroll
            for (int w = 0; w < 7; ++w) v[k][w] = nv[k][w];
    }
    if (SMEM) {
        __syncthreads();
        flush_marks(bits, T, cont);
        flush_marks(bits + W, T, used);
    }
}

__global__ void sg_marks_kernel(const int32_t* __restrict__ hits, int64_t n,
                                const int32_t* __restrict__ len, int64_t T,
                                int32_t max_hang, float int_frac,
                                int32_t min_ovlp, uint8_t* __restrict__ mark,
                                uint8_t* __restrict__ keep,
                                int32_t* __restrict__ arcs) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
    if (i >= n) return;
    const int32_t q = hits[i], t = hits[3 * n + i];
    const int32_t qi = clamp_index(q, T), ti = clamp_index(t, T);
    const int32_t qs = hits[n + i], qe = hits[2 * n + i];
    const int32_t ts = hits[4 * n + i], te = hits[5 * n + i];
    const int32_t rev = hits[8 * n + i] != 0 ? 1 : 0;
    const Arc a = hit2arc(q, qs, qe, t, ts, te, rev, len[qi], len[ti],
                          max_hang, int_frac, min_ovlp);
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

// K6.  cols: the entry's (10, n) int32 columns at row stride ld, of which
// rows qid (0), tid (3), rev (8) and valid (9) are read; coords (4, n)
// int32 [qs qe ts te] and keep (n bytes) from K5; sub (3, T) int32 [s e
// del].  arcs (5, n) int32 [r u v l ol], good n bytes, sub_del T bytes.
extern "C" int ma_hit2arc(const int32_t* cols, int64_t ld, int64_t n,
                          const int32_t* coords, const uint8_t* keep,
                          const int32_t* sub, int64_t T, int max_hang,
                          float int_frac, int min_ovlp, int32_t* arcs,
                          uint8_t* good, uint8_t* sub_del,
                          cudaStream_t stream) {
    if (n < 0 || T < 0 || T > INT32_MAX || (n > 0 && T == 0) || ld < n)
        return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = n_blocks(std::max(n, T), H2A_THREADS * H2A_PER);
    if (blocks == 0) return static_cast<int>(cudaSuccess);
    hit2arc_kernel<<<blocks, H2A_THREADS, 0, stream>>>(
        cols, ld, n, coords, keep, sub, T, max_hang, int_frac, min_ovlp,
        arcs, good, sub_del);
    return static_cast<int>(cudaGetLastError());
}

__global__ void h2a_floor_kernel() {}

// K6's latency floor: an empty plain launch of the grid ma_hit2arc takes
// for n columns and T reads (a measurement's entry, counted nowhere).
extern "C" int ma_hit2arc_floor(int64_t n, int64_t T, cudaStream_t stream) {
    const unsigned blocks = n_blocks(std::max(n, T), H2A_THREADS * H2A_PER);
    if (n < 0 || T < 0 || blocks == 0)
        return static_cast<int>(cudaErrorInvalidValue);
    h2a_floor_kernel<<<blocks, H2A_THREADS, 0, stream>>>();
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

// K18.  hits (9, n); len: T int32; mode 0 contained: mark (2, T) bytes
// [contained | used], keep and arcs null; mode 1 sg: mark T bytes, keep
// (n bytes) and arcs (4, n) int32 [u v l ol].  The marks are zeroed here.
// The contained mode's bitmaps take shared memory up to CM_SMEM_READS
// reads, past it the marks go to device memory.  info (host, 3 int64,
// may be null) receives [blocks, hits a block at most, shared memory
// bytes a block].
extern "C" int ma_hit_marks(const int32_t* hits, int64_t n, const int32_t* len,
                            int64_t T, int max_hang, float int_frac,
                            int min_ovlp, int mode, uint8_t* mark,
                            uint8_t* keep, int32_t* arcs, int64_t* info,
                            cudaStream_t stream) {
    if (info) info[0] = info[1] = info[2] = 0;
    if (T <= 0 || T > INT32_MAX || !len ||
        (mode != MARK_CONTAINED && mode != MARK_SG) ||
        (mode == MARK_SG && (!keep || !arcs)))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaMemsetAsync(mark, 0, mode == MARK_SG ? T : 2 * T,
                                    stream);
    if (e != cudaSuccess || n == 0) return static_cast<int>(e);
    if (mode == MARK_SG) {
        const int threads = 256;
        sg_marks_kernel<<<n_blocks(n, threads), threads, 0, stream>>>(
            hits, n, len, T, max_hang, int_frac, min_ovlp, mark, keep, arcs);
        return static_cast<int>(cudaGetLastError());
    }
    // two bitmaps, in the 48 KB a block takes without opting in
    const int64_t smem = 8 * ((T + 31) / 32);
    const bool in_smem = T <= CM_SMEM_READS;
    int dev = 0, sms = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    // CM_BLOCKS_SM blocks an SM, at most a block a round of hits
    const int64_t rounds = (n + CM_ROUND - 1) / CM_ROUND;
    const unsigned grid = static_cast<unsigned>(
        std::min<int64_t>(rounds, static_cast<int64_t>(sms) * CM_BLOCKS_SM));
    if (in_smem)
        contained_marks_kernel<true><<<grid, CM_THREADS, smem, stream>>>(
            hits, n, len, T, max_hang, int_frac, min_ovlp, mark);
    else
        contained_marks_kernel<false><<<grid, CM_THREADS, 0, stream>>>(
            hits, n, len, T, max_hang, int_frac, min_ovlp, mark);
    if (info) {
        info[0] = grid;
        info[1] = (rounds + grid - 1) / grid * CM_ROUND;
        info[2] = in_smem ? smem : 0;
    }
    return static_cast<int>(cudaGetLastError());
}
