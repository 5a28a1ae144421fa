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

#include <cooperative_groups.h>

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
// K14 clean_stage_b: stage B of the program (devclean.py:236-308,
// asg.c:83-138 and 199-236) in one cooperative launch: its arc half, a
// grid-wide sync, its vertex half.
//
// Phase 1, the arcs (devclean.py:236-275).  A group of L lanes a vertex
// row, as K3, the groups striding over the rows; lane t takes the row's
// slots t, t + L, ...  Per arc u -> v that K3 left live (neither
// eliminated nor multi), the lane looks in row v^1 for a live arc to u^1:
// none makes the arc asymmetric.  The live set downstream is live1 minus
// the asymmetric arcs under do_symm, else every arc not eliminated
// (multi-arcs stay: devclean.py:276-279).  A group sum and min give the
// row's live count and first live slot, whose target and overlap the
// row keeps (the target for phase 2; the overlap for the masks).  The
// weak-overlap masks at every ratio of the schedule (asg.c:90): part =
// f32(first_ol) * f32(ratio), the threshold floor(part) + [part -
// floor(part) >= frac_cut], all in float32 with no contraction, and a
// live arc other than the first, in a row of at least two live arcs, is
// weak below it.  Every arc gets one word: bit 0 eliminated, 1 multi, 2
// asymmetric, 3 + k weak at ratio k; the counters are the words' bit
// counts, by warp ballots into the block's shared memory, one atomic per
// block and counter.
//
// Phase 2, the vertices (devclean.py:276-308), a thread a vertex v,
// striding, after the sync because it reads other rows' live counts.
// code(r) (what asg_is_utg_end returns when it inspects row r) is 1 (tip)
// for no live arc, 2 (multi-out) for more than one, else 3 (multi-in)
// unless the unique target's complement row holds exactly one live arc
// (0, mergeable).  The asg_extend walk follows the first live target
// from v while the code is 0, max_ext codes at most; the start code is
// code(v^1).  Out: one byte a vertex, bit 0 tip, 1 internal, 2 bi-loop,
// 3 bubble source (>= 2 live out-arcs), each only on a vertex whose read
// is not deleted.
//
// What bounds it on the card: latency, not bytes.  At the graphs' sizes
// (V 12,556 on the noisy E. coli set) both halves move under 2 MB, less
// than one launch's time at the memory rate, so the time is the launch
// and the chain of dependent loads each lane waits on.  The design:
//   - one launch where there were two: the vertex half runs behind
//     cooperative_groups' grid sync, the grid no larger than the blocks
//     the card holds at once (the occupancy limit times the SMs);
//   - the arc half's chain is first[r] -> the row's bits, targets and
//     overlaps (one coalesced round, kept in registers) -> first[w] and
//     first[w + 1] of every live1 slot at once -> the complement row,
//     SCAN_CHUNK arcs loaded together before any is compared, the scan
//     stopping only between chunks: a row of up to 16 arcs is one round,
//     where a loop that breaks on its first match waits on every load;
//   - the first live arc's target and overlap come from the lane that
//     holds them by a shuffle, and the weak-overlap bits are built on the
//     word in registers, so a word is written once (a row longer than L
//     writes the words of its later slots and reads them back);
//   - a walk step of phase 2 loads the (live count, first target) pair of
//     the current row's successor and of its complement together, so a
//     step is one round.  Phase 1 writes the pairs, phase 2 reads them
//     in the same launch: plain pointers and __ldcg (the L2), never the
//     read-only path, which is not coherent within a kernel.

constexpr int MAX_RATIOS = 29;  // bits 3..31 of an arc's word
constexpr int SCAN_CHUNK = 16;  // complement-row arcs loaded together

struct Ratios {
    float r[MAX_RATIOS];
};

struct StageB {
    const int64_t* first;
    const int32_t* av;
    const int32_t* aol;
    const uint8_t* bits;
    const uint8_t* sdel_v;
    int64_t V;
    int R;
    float frac_cut;
    int do_symm;
    int max_ext;
    int32_t* res;  // counters (3 + R), then one word an arc
    int2* rows;    // per row: (live arcs, first live target)
    uint8_t* out;  // one byte a vertex
};

// add each bit k0..k0+n-1 of the warp's words to its counter
__device__ __forceinline__ void count_bits(int32_t* csh, uint32_t word,
                                           int k0, int n) {
    if (!__any_sync(FULL, word)) return;
    for (int k = k0; k < k0 + n; ++k) {
        const unsigned m = __ballot_sync(FULL, (word >> k) & 1u);
        if ((threadIdx.x & 31) == 0 && m) atomicAdd(&csh[k], __popc(m));
    }
}

// the weak-overlap bits of an arc of overlap o in a row whose first live
// arc has overlap fol (asg.c:90)
__device__ __forceinline__ uint32_t weak_bits(float fol, int32_t o,
                                              const Ratios& rs, int R,
                                              float frac_cut) {
    uint32_t add = 0;
#pragma unroll  // constant indices: the ratios stay in the parameter bank
    for (int k = 0; k < MAX_RATIOS; ++k) {
        if (k >= R) break;
        const float part = __fmul_rn(fol, rs.r[k]);
        const float base = floorf(part);
        const float th = __fadd_rn(
            base, __fsub_rn(part, base) >= frac_cut ? 1.0f : 0.0f);
        if (static_cast<int64_t>(o) < static_cast<int64_t>(th))
            add |= 1u << (3 + k);
    }
    return add;
}

// code(r) from row r's pair and the live count of row (first target ^ 1)
__device__ __forceinline__ int end_code(int2 row, int32_t back_live) {
    if (row.x == 0) return 1;
    if (row.x > 1) return 2;
    return back_live != 1 ? 3 : 0;
}

template <int L>
__global__ void __launch_bounds__(THREADS)
clean_stage_b_kernel(StageB p, Ratios rs) {
    constexpr int RPB = THREADS / L;  // rows a block takes at a time
    __shared__ int32_t csh[3 + MAX_RATIOS];
    const int R = p.R;
    for (int k = threadIdx.x; k < 3 + R; k += blockDim.x) csh[k] = 0;
    __syncthreads();
    const int grp = threadIdx.x / L;
    const int t = threadIdx.x % L;
    const int live_mask = p.do_symm ? 7 : 1;
    int32_t* words = p.res + 3 + R;

    // ---- phase 1: the arcs.  Every loop below runs the same trips on
    // the whole warp (rows by block, slots by the warp's longest row), so
    // the shuffles and ballots see all 32 lanes. ----
    for (int64_t r0 = static_cast<int64_t>(blockIdx.x) * RPB; r0 < p.V;
         r0 += static_cast<int64_t>(gridDim.x) * RPB) {
        const int64_t r = r0 + grp;
        int64_t s = 0;
        int nv = 0;
        if (r < p.V) {
            s = __ldg(p.first + r);
            nv = static_cast<int>(__ldg(p.first + r + 1) - s);
        }
        const int32_t back = static_cast<int32_t>(r ^ 1);
        const int n_chunks = __reduce_max_sync(FULL, (nv + L - 1) / L);
        int n_live = 0, fl = 0x7fffffff;
        int32_t my_fol = 0, my_fav = 0;  // of this lane's first live slot
        uint32_t w0 = 0;  // the word of slot t, kept for the weak bits
        int32_t ol0 = 0;
        bool live0 = false;
        for (int c = 0; c < n_chunks; ++c) {
            const int j = c * L + t;
            const bool in = j < nv;
            int b = 0;
            int32_t v = 0, ol = 0;
            if (in) {
                b = __ldg(p.bits + s + j);
                v = __ldg(p.av + s + j);
                ol = __ldg(p.aol + s + j);
            }
            const bool elim = b & 1, multi = b & 2;
            bool asymm = false;
            if (in && !elim && !multi) {
                const int32_t w = v ^ 1;
                const int64_t ke = __ldg(p.first + w + 1);
                asymm = true;
                for (int64_t k = __ldg(p.first + w); k < ke;
                     k += SCAN_CHUNK) {
                    int32_t cv[SCAN_CHUNK];
                    int cb[SCAN_CHUNK];
#pragma unroll
                    for (int i = 0; i < SCAN_CHUNK; ++i) {
                        const bool ok = k + i < ke;
                        cv[i] = ok ? __ldg(p.av + k + i) : -1;
                        cb[i] = ok ? __ldg(p.bits + k + i) : 3;
                    }
                    bool hit = false;
#pragma unroll
                    for (int i = 0; i < SCAN_CHUNK; ++i)
                        hit |= cv[i] == back && !(cb[i] & 3);
                    if (hit) {
                        asymm = false;
                        break;
                    }
                }
            }
            const bool live =
                in && (p.do_symm ? !(elim || multi || asymm) : !elim);
            const uint32_t word =
                (elim ? 1u : 0u) | (multi ? 2u : 0u) | (asymm ? 4u : 0u);
            if (live) {
                if (n_live == 0) {  // slots rise with c: the lane's first
                    fl = j;
                    my_fol = ol;
                    my_fav = v;
                }
                ++n_live;
            }
            if (c == 0) {
                w0 = word;
                ol0 = ol;
                live0 = live;
            } else if (in) {
                words[s + j] = static_cast<int32_t>(word);
            }
            count_bits(csh, word, 0, 3);
        }
#pragma unroll
        for (int o = L / 2; o > 0; o >>= 1) {
            n_live += __shfl_xor_sync(FULL, n_live, o, L);
            fl = min(fl, __shfl_xor_sync(FULL, fl, o, L));
        }
        const int owner = (n_live > 0 ? fl : 0) & (L - 1);
        const int32_t f_ol = __shfl_sync(FULL, my_fol, owner, L);
        const int32_t f_v = __shfl_sync(FULL, my_fav, owner, L);
        if (r < p.V && t == 0)
            p.rows[r] = make_int2(n_live, n_live > 0 ? f_v : 0);
        // the weak-overlap masks: slot t from registers, later slots of a
        // row longer than L from the words written above
        const bool weak = n_live >= 2;
        const float fol = __int2float_rn(f_ol);
        uint32_t add = 0;
        if (weak && live0 && t != fl)
            add = weak_bits(fol, ol0, rs, R, p.frac_cut);
        if (t < nv) words[s + t] = static_cast<int32_t>(w0 | add);
        count_bits(csh, add, 3, R);
        for (int c = 1; c < n_chunks; ++c) {
            const int j = c * L + t;
            add = 0;
            if (weak && j < nv) {
                const int32_t w = words[s + j];
                if (!(w & live_mask) && j != fl) {
                    add = weak_bits(fol, __ldg(p.aol + s + j), rs, R,
                                    p.frac_cut);
                    if (add) words[s + j] = w | static_cast<int32_t>(add);
                }
            }
            count_bits(csh, add, 3, R);
        }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < 3 + R; k += blockDim.x)
        if (csh[k]) atomicAdd(&p.res[k], csh[k]);

    cooperative_groups::this_grid().sync();

    // ---- phase 2: the vertices, and the zero bytes that pad them to a
    // word ----
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
         v < ((p.V + 3) & ~int64_t{3}); v += stride) {
        if (v >= p.V) {
            p.out[v] = 0;
            continue;
        }
        const int2 row = __ldcg(p.rows + v);
        const int2 brow = __ldcg(p.rows + (v ^ 1));
        const bool keep = !__ldg(p.sdel_v + v);
        const int32_t bback = __ldcg(p.rows + (brow.y ^ 1)).x;
        int ext = 0;
        int2 cur = row;
        for (int step = 0; step < p.max_ext; ++step) {
            // the successor's pair is loaded with the code's, before the
            // code decides whether the walk goes on
            const int32_t back_live = __ldcg(p.rows + (cur.y ^ 1)).x;
            const int2 next = __ldcg(p.rows + cur.y);
            const int c = end_code(cur, back_live);
            if (c) {
                ext = c;
                break;
            }
            cur = next;
        }
        const int start = end_code(brow, bback);
        const bool mn = keep && start == 3;
        p.out[v] = static_cast<uint8_t>(
            (keep && start == 1 && ext != 0 ? 1 : 0) |
            (mn && ext == 3 ? 2 : 0) | (mn && ext == 2 ? 4 : 0) |
            (keep && row.x >= 2 ? 8 : 0));
    }
}

// the latency floor of a cooperative design: a launch of `blocks` blocks
// of THREADS threads that does nothing but `syncs` grid syncs
__global__ void __launch_bounds__(THREADS) coop_floor_kernel(int syncs) {
    for (int k = 0; k < syncs; ++k) cooperative_groups::this_grid().sync();
}

template <int L>
int launch_stage_b(StageB p, Ratios rs, int* grid, cudaStream_t stream) {
    const void* kernel = reinterpret_cast<const void*>(
        clean_stage_b_kernel<L>);
    constexpr int64_t RPB = THREADS / L;
    cudaError_t e = coop_blocks(kernel, THREADS, 0, (p.V + RPB - 1) / RPB,
                                grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    grid[1] = L;
    void* args[] = {&p, &rs};
    e = cudaLaunchCooperativeKernel(kernel, dim3(grid[0]), dim3(THREADS),
                                    args, 0, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
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

// K14.  first: V + 1 int64 CSR offsets (V even: a vertex and its
// complement); av, aol: A int32 targets and overlaps; bits: K3's A bytes;
// sdel_v: V bytes; ratios: R host floats (R <= 29); res: 3 + R + A int32,
// the counters [elim, multi, asymm, weak at each ratio] (zeroed here) then
// one word an arc; out: V bytes of candidate bits, then zero bytes to a
// multiple of 4; rows: 2 V int32 of scratch.  L as K3's, from max_deg.
// grid: 2 host ints, the blocks launched and L (0, 0 without a launch:
// V == 0).  Fails where the card cannot launch a cooperative kernel.
extern "C" int ma_clean_stage_b(const int64_t* first, const int32_t* av,
                                const int32_t* aol, const uint8_t* bits,
                                const uint8_t* sdel_v, int64_t V,
                                int max_deg, const float* ratios, int R,
                                float frac_cut, int do_symm, int max_ext,
                                int32_t* res, uint8_t* out, int32_t* rows,
                                int* grid, cudaStream_t stream) {
    grid[0] = grid[1] = 0;
    if (R < 0 || R > MAX_RATIOS || V < 0 || (V & 1))
        return static_cast<int>(cudaErrorInvalidValue);
    Ratios rs = {};
    for (int k = 0; k < R; ++k) rs.r[k] = ratios[k];
    cudaError_t e = cudaMemsetAsync(res, 0, (3 + R) * sizeof(int32_t), stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (V == 0) return static_cast<int>(cudaGetLastError());
    const StageB p = {first, av, aol, bits, sdel_v, V, R, frac_cut, do_symm,
                      max_ext, res, reinterpret_cast<int2*>(rows), out};
    int lanes = 1;
    while (lanes < max_deg && lanes < 32) lanes *= 2;
    switch (lanes) {
#define MA_CASE(n) \
    case n:        \
        return launch_stage_b<n>(p, rs, grid, stream);
        MA_CASE(1) MA_CASE(2) MA_CASE(4) MA_CASE(8) MA_CASE(16) MA_CASE(32)
#undef MA_CASE
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// The latency floor beside a cooperative kernel (K13, K14, K16, K19): an
// empty cooperative launch of `blocks` blocks of 256 threads (the
// kernel's grid) that makes `syncs` grid syncs.
extern "C" int ma_coop_floor(int blocks, int syncs, cudaStream_t stream) {
    if (blocks < 1 || syncs < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    void* args[] = {&syncs};
    cudaError_t e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(coop_floor_kernel), dim3(blocks),
        dim3(THREADS), args, 0, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}
