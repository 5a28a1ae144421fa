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
