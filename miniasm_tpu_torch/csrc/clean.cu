// K3 trans_multi: stage A of the graph-cleaning detection program (port of
// miniasm_tpu/graph/devclean.py:_clean_kernel, stage A, l.179-225):
// Myers transitive-reduction marks (asg.c:148-193) and multi-arc marks
// (asg.c:104-121) over the CSR arc list of a compacted string graph.
//
// A group of L lanes (L = 1, 2, ..., 32, a power of two; a warp holds 32/L
// groups) takes one vertex row; a block of 256 threads takes 256/L rows
// (fewer where a row's slots would not fit its shared memory).  The row's
// (target, length, mark) slots sit in the group's slice of shared memory.
// The slots i = 0..nv-1 run in order, because whether slot i is scanned
// depends on demotions made by earlier slots (devclean.py:200, 211); within
// one slot the group's lanes run over the arc row of the neighbour w = v[i]
// and demote every slot of this row whose target is reachable through w
// within the fuzz bound (duplicate targets demote together; marks only go
// 1 -> 2, so concurrent stores of 2 are benign).  Then each lane marks its
// slots that repeat the target of an earlier live slot (the first live
// slot per target stays).
//
// What bounds it on the card, and what the design does about each:
//   - Latency and launch shape, not bytes: rows hold a handful of slots
//     (the E. coli graphs: at most 3-15), so a block per row idles most of
//     its lanes.  The launch sets L to the longest row rounded up to a
//     power of two, at most 32; longer rows take their slots L at a time.
//     An empty row costs one test.
//   - The serial slot loop: each slot scans its neighbour's row.  Every
//     lane loads the neighbour row bounds (first[w], first[w+1]) of one
//     slot of the next L, so a scan waits for one round of loads.  The
//     lanes read the neighbour row's lengths and targets L arcs at a time,
//     together and coalesced; the rows are sorted by length, so a ballot
//     on the `<= bound` test ends the scan at the first chunk with a
//     violation, the reference's break (asg.c:169).  The group
//     synchronises with __syncwarp on its own lanes.
//   - The multi-arc marks compare each slot with the earlier ones in
//     shared memory, one slot per lane.
//
// A launch covers the rows [row0, row0 + n_rows) and writes the bits of
// their arcs, from arc first[row0] on, into out[0..]: the sharded clean
// gives each rank one block of rows (the JAX kernel's row-sharded tables,
// devclean.py:167-172); the neighbour rows are read from the whole table.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int64_t SMEM_MAX = 232448;  // a block's shared memory on an H100

template <int L>
__global__ void __launch_bounds__(THREADS)
trans_multi_kernel(const int64_t* __restrict__ first,
                   const int32_t* __restrict__ av,
                   const int32_t* __restrict__ al,
                   const uint8_t* __restrict__ sdel_v, int64_t row0,
                   int64_t n_rows, int D, int32_t fuzz, int do_trans,
                   uint8_t* __restrict__ out) {
    extern __shared__ int32_t smem[];
    const int grp = threadIdx.x / L;  // the group's row within the block
    const int t = threadIdx.x % L;    // the lane within the group
    // the group's lanes within the warp
    const unsigned gm = (0xffffffffu >> (32 - L))
                        << ((threadIdx.x & 31) & ~(L - 1));
    const int64_t rl = static_cast<int64_t>(blockIdx.x) * (blockDim.x / L) +
                       grp;
    if (rl >= n_rows) return;  // the whole group
    const int64_t r = row0 + rl;
    const int64_t s = first[r];
    const int nv = static_cast<int>(first[r + 1] - s);
    if (nv == 0) return;
    int32_t* v = smem + static_cast<int64_t>(grp) * 3 * D;
    int32_t* l = v + D;
    int32_t* mark = l + D;
    const bool active = do_trans && !sdel_v[r];
    for (int j = t; j < nv; j += L) {
        v[j] = av[s + j];
        l[j] = al[s + j];
        mark[j] = active ? 1 : 0;  // 1 in play, 2 eliminated
    }
    __syncwarp(gm);
    if (active) {
        const int32_t bound = wadd(l[nv - 1], fuzz);
        int64_t my_ws = 0;
        int my_nw = 0;
        for (int i = 0; i < nv; ++i) {
            if (i % L == 0 && i + t < nv) {
                // the neighbour rows of slots i..i+L-1, one per lane
                my_ws = first[v[i + t]];
                my_nw = static_cast<int>(first[v[i + t] + 1] - my_ws);
            }
            const int64_t ws = __shfl_sync(gm, my_ws, i % L, L);
            const int nw = __shfl_sync(gm, my_nw, i % L, L);
            const int32_t mi = mark[i];
            const int32_t li = l[i];
            __syncwarp(gm);  // the group has read mark[i] before demotions
            if (mi == 1) {
                for (int kb = 0; kb < nw; kb += L) {
                    const int k = kb + t;
                    const bool in = k < nw;
                    int32_t wl = 0, wv = 0;
                    if (in) {
                        wl = al[ws + k];
                        wv = av[ws + k];
                    }
                    const bool within = in && wadd(wl, li) <= bound;
                    if (within)
                        for (int j = 0; j < nv; ++j)
                            if (v[j] == wv && mark[j] != 0) mark[j] = 2;
                    if (__ballot_sync(gm, in && !within) & gm) break;
                }
            }
            __syncwarp(gm);
        }
    }
    const int64_t o = s - first[row0];
    for (int j = t; j < nv; j += L) {
        const bool elim = mark[j] == 2;
        bool multi = false;
        if (!elim)
            for (int j2 = 0; j2 < j; ++j2)
                if (mark[j2] != 2 && v[j2] == v[j]) {
                    multi = true;
                    break;
                }
        out[o + j] = (elim ? 1 : 0) | (multi ? 2 : 0);
    }
}

template <int L>
int launch(const int64_t* first, const int32_t* av, const int32_t* al,
           const uint8_t* sdel_v, int64_t row0, int64_t n_rows, int D,
           int fuzz, int do_trans, uint8_t* bits, cudaStream_t stream) {
    const int64_t per_row = static_cast<int64_t>(D) * 3 * sizeof(int32_t);
    const int64_t rows = std::max<int64_t>(
        1, std::min<int64_t>(THREADS / L, SMEM_MAX / per_row));
    const size_t smem = static_cast<size_t>(rows * per_row);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            trans_multi_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int64_t blocks = (n_rows + rows - 1) / rows;
    trans_multi_kernel<L><<<static_cast<unsigned int>(blocks),
                            static_cast<unsigned int>(rows * L), smem,
                            stream>>>(first, av, al, sdel_v, row0, n_rows, D,
                                      fuzz, do_trans, bits);
    return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// K14 clean_arcs: stage B of the program, its arc half (devclean.py:236-275,
// asg.c:83-138).  A group of L lanes a vertex row, as K3; lane t takes the
// row's slots t, t + L, ...  Per arc u -> v that K3 left live (neither
// eliminated nor multi), the lane scans row v^1 for a live arc to u^1 (a
// row holds a handful of arcs; the E. coli graphs at most 15): none makes
// the arc asymmetric.  The live set downstream is live1 minus the
// asymmetric arcs under do_symm, else every arc not eliminated (multi-arcs
// stay: devclean.py:276-279).  A group sum and min give the row's live
// count and first live slot, whose target and overlap the row keeps
// (fl_v for K15; first_ol for the masks).  The weak-overlap masks at every
// ratio of the schedule (asg.c:90): part = f32(first_ol) * f32(ratio), the
// threshold floor(part) + [part - floor(part) >= frac_cut], all in float32
// with no contraction, and a live arc other than the first, in a row of
// at least two live arcs, is weak below it.  Every arc gets one word: bit 0
// eliminated, 1 multi, 2 asymmetric, 3 + k weak at ratio k; the counters
// are the words' bit counts, summed per block in shared memory, one
// atomic per block and counter.
//
// K15 clean_ends: stage B's vertex half (devclean.py:276-308, asg.c:199-
// 236), one thread a vertex v, after K14 because it reads other rows'
// live counts.  code(r) (what asg_is_utg_end returns when it inspects row
// r) is computed where it is read: 1 (tip) for no live arc, 2 (multi-out)
// for more than one, else 3 (multi-in) unless the unique target's
// complement row holds exactly one live arc (0, mergeable).  The
// asg_extend walk follows fl_v from v while the code is 0, max_ext codes
// at most; the start code is code(v^1).  Out: one byte a vertex, bit 0
// tip, 1 internal, 2 bi-loop, 3 bubble source (>= 2 live out-arcs), each
// only on a vertex whose read is not deleted.

constexpr int MAX_RATIOS = 29;  // bits 3..31 of an arc's word

struct Ratios {
    float r[MAX_RATIOS];
};

template <int L>
__global__ void __launch_bounds__(THREADS)
clean_arcs_kernel(const int64_t* __restrict__ first,
                  const int32_t* __restrict__ av,
                  const int32_t* __restrict__ aol,
                  const uint8_t* __restrict__ bits, int64_t V, Ratios rs,
                  int R, float frac_cut, int do_symm,
                  int32_t* __restrict__ res, int32_t* __restrict__ nlive,
                  int32_t* __restrict__ flv) {
    __shared__ int32_t csh[3 + MAX_RATIOS];
    for (int k = threadIdx.x; k < 3 + R; k += blockDim.x) csh[k] = 0;
    __syncthreads();
    const int grp = threadIdx.x / L;
    const int t = threadIdx.x % L;
    const unsigned gm = (0xffffffffu >> (32 - L))
                        << ((threadIdx.x & 31) & ~(L - 1));
    const int64_t r = static_cast<int64_t>(blockIdx.x) * (blockDim.x / L) +
                      grp;
    int32_t* words = res + 3 + R;
    if (r < V) {  // the whole group
        const int64_t s = first[r];
        const int nv = static_cast<int>(first[r + 1] - s);
        const int32_t back = static_cast<int32_t>(r ^ 1);
        int n_live = 0, first_live = 0x7fffffff;
        for (int j = t; j < nv; j += L) {
            const int b = bits[s + j];
            const bool elim = b & 1, multi = b & 2;
            bool asymm = false;
            if (!elim && !multi) {
                const int32_t w = av[s + j] ^ 1;
                const int64_t we = first[w + 1];
                asymm = true;
                for (int64_t k = first[w]; k < we; ++k)
                    if (av[k] == back && !(bits[k] & 3)) {
                        asymm = false;
                        break;
                    }
            }
            const bool live = do_symm ? !(elim || multi || asymm) : !elim;
            words[s + j] = (elim ? 1 : 0) | (multi ? 2 : 0) | (asymm ? 4 : 0);
            if (elim) atomicAdd(&csh[0], 1);
            if (multi) atomicAdd(&csh[1], 1);
            if (asymm) atomicAdd(&csh[2], 1);
            if (live) {
                ++n_live;
                first_live = min(first_live, j);
            }
        }
#pragma unroll
        for (int o = L / 2; o > 0; o >>= 1) {
            n_live += __shfl_xor_sync(gm, n_live, o, L);
            first_live = min(first_live,
                             __shfl_xor_sync(gm, first_live, o, L));
        }
        if (t == 0) {
            nlive[r] = n_live;
            flv[r] = n_live > 0 ? av[s + first_live] : 0;
        }
        if (n_live >= 2) {
            const float fol = __int2float_rn(aol[s + first_live]);
            const int live_mask = do_symm ? 7 : 1;
            for (int j = t; j < nv; j += L) {
                const int32_t w = words[s + j];
                if ((w & live_mask) || j == first_live) continue;
                const int64_t o = aol[s + j];
                int32_t add = 0;
                for (int k = 0; k < R; ++k) {
                    const float part = __fmul_rn(fol, rs.r[k]);
                    const float base = floorf(part);
                    const float th = __fadd_rn(
                        base, __fsub_rn(part, base) >= frac_cut ? 1.0f : 0.0f);
                    if (o < static_cast<int64_t>(th)) {
                        add |= 1 << (3 + k);
                        atomicAdd(&csh[3 + k], 1);
                    }
                }
                if (add) words[s + j] = w | add;
            }
        }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < 3 + R; k += blockDim.x)
        if (csh[k]) atomicAdd(&res[k], csh[k]);
}

__device__ __forceinline__ int end_code(const int32_t* __restrict__ nlive,
                                        const int32_t* __restrict__ flv,
                                        int64_t r) {
    const int32_t nl = nlive[r];
    if (nl == 0) return 1;
    if (nl > 1) return 2;
    return nlive[flv[r] ^ 1] != 1 ? 3 : 0;
}

__global__ void clean_ends_kernel(const int32_t* __restrict__ nlive,
                                  const int32_t* __restrict__ flv,
                                  const uint8_t* __restrict__ sdel_v,
                                  int64_t V, int max_ext,
                                  uint8_t* __restrict__ out) {
    const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
    if (v >= V) return;
    int ext = 0;
    int64_t cur = v;
    for (int step = 0; step < max_ext; ++step) {
        const int c = end_code(nlive, flv, cur);
        if (c) {
            ext = c;
            break;
        }
        cur = flv[cur];
    }
    const bool keep = !sdel_v[v];
    const int start = end_code(nlive, flv, v ^ 1);
    const bool mn = keep && start == 3;
    out[v] = static_cast<uint8_t>((keep && start == 1 && ext != 0 ? 1 : 0) |
                                  (mn && ext == 3 ? 2 : 0) |
                                  (mn && ext == 2 ? 4 : 0) |
                                  (keep && nlive[v] >= 2 ? 8 : 0));
}

template <int L>
int launch_arcs(const int64_t* first, const int32_t* av, const int32_t* aol,
                const uint8_t* bits, int64_t V, const Ratios& rs, int R,
                float frac_cut, int do_symm, int32_t* res, int32_t* rows,
                cudaStream_t stream) {
    const int64_t per_block = THREADS / L;
    clean_arcs_kernel<L><<<static_cast<unsigned int>(
                               (V + per_block - 1) / per_block),
                           THREADS, 0, stream>>>(
        first, av, aol, bits, V, rs, R, frac_cut, do_symm, res, rows,
        rows + V);
    return static_cast<int>(cudaGetLastError());
}
}  // namespace

// L, the lanes per row, is the longest row max_deg rounded up to a power of
// two, at most 32
extern "C" int ma_trans_multi(const int64_t* first, const int32_t* av,
                              const int32_t* al, const uint8_t* sdel_v,
                              int64_t row0, int64_t n_rows, int max_deg,
                              int fuzz, int do_trans, uint8_t* bits,
                              cudaStream_t stream) {
    int lanes = 1;
    while (lanes < max_deg && lanes < 32) lanes *= 2;
    switch (lanes) {
#define MA_CASE(n)                                                          \
    case n:                                                                 \
        return launch<n>(first, av, al, sdel_v, row0, n_rows, max_deg, fuzz, \
                         do_trans, bits, stream);
        MA_CASE(1) MA_CASE(2) MA_CASE(4) MA_CASE(8) MA_CASE(16) MA_CASE(32)
#undef MA_CASE
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// K14.  first: V + 1 int64 CSR offsets; av, aol: A int32 targets and
// overlaps; bits: K3's A bytes; ratios: R host floats (R <= 29);
// res: 3 + R + A int32, the counters [elim, multi, asymm, weak at each
// ratio] (zeroed here) then one word an arc; rows: (2, V) int32, each row's
// live arcs and first live target.  L as K3's, from max_deg.
extern "C" int ma_clean_arcs(const int64_t* first, const int32_t* av,
                             const int32_t* aol, const uint8_t* bits,
                             int64_t V, int max_deg, const float* ratios,
                             int R, float frac_cut, int do_symm,
                             int32_t* res, int32_t* rows,
                             cudaStream_t stream) {
    if (R < 0 || R > MAX_RATIOS || V < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    Ratios rs = {};
    for (int k = 0; k < R; ++k) rs.r[k] = ratios[k];
    cudaError_t e = cudaMemsetAsync(res, 0, (3 + R) * sizeof(int32_t), stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (V == 0) return static_cast<int>(cudaGetLastError());
    int lanes = 1;
    while (lanes < max_deg && lanes < 32) lanes *= 2;
    switch (lanes) {
#define MA_CASE(n)                                                        \
    case n:                                                               \
        return launch_arcs<n>(first, av, aol, bits, V, rs, R, frac_cut,   \
                              do_symm, res, rows, stream);
        MA_CASE(1) MA_CASE(2) MA_CASE(4) MA_CASE(8) MA_CASE(16) MA_CASE(32)
#undef MA_CASE
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// K15.  nlive, flv: K14's rows; sdel_v: V bytes; out: V bytes of
// candidate bits.
extern "C" int ma_clean_ends(const int32_t* nlive, const int32_t* flv,
                             const uint8_t* sdel_v, int64_t V, int max_ext,
                             uint8_t* out, cudaStream_t stream) {
    if (V > 0) {
        const int threads = 256;
        clean_ends_kernel<<<n_blocks(V, threads), threads, 0, stream>>>(
            nlive, flv, sdel_v, V, max_ext, out);
    }
    return static_cast<int>(cudaGetLastError());
}
