// K3 trans_multi: stage A of the graph-cleaning detection program (port of
// miniasm_tpu/graph/devclean.py:_clean_kernel, stage A, l.179-225):
// Myers transitive-reduction marks (asg.c:148-193) and multi-arc marks
// (asg.c:104-121) over the CSR arc list of a compacted string graph.
//
// One block per vertex row.  The row's (target, length, mark) slots sit in
// shared memory.  The slots i = 0..nv-1 run in order, because whether slot
// i is scanned depends on demotions made by earlier slots (devclean.py:200,
// 211); within one slot the block's threads run over the arc row of the
// neighbour w = v[i] and demote every slot of this row whose target is
// reachable through w within the fuzz bound.  Arc rows are sorted by
// length, so the `<= bound` mask equals the reference's break on the first
// violation (asg.c:169).  Then each thread marks its slots that repeat the
// target of an earlier live slot (the first live slot per target stays).
//
// Bound on the card: the work is O(sum over slots of deg(w)) scattered
// reads of arc rows (L2-resident at these graph sizes) plus O(deg^2) shared
// compares per row; with ~40 K rows of ~10-60 slots it is a few MB of reads
// and is bound by latency and the serial slot loop, not by bytes.
//
// A launch covers the rows [row0, row0 + n_rows) and writes the bits of
// their arcs, from arc first[row0] on, into out[0..]: the sharded clean
// gives each rank one block of rows (the JAX kernel's row-sharded tables,
// devclean.py:167-172); the neighbour rows are read from the whole table.
#include "common.cuh"

namespace {

__global__ void trans_multi_kernel(const int64_t* __restrict__ first,
                                   const int32_t* __restrict__ av,
                                   const int32_t* __restrict__ al,
                                   const uint8_t* __restrict__ sdel_v,
                                   int64_t row0, int32_t fuzz, int do_trans,
                                   uint8_t* __restrict__ out) {
    extern __shared__ int32_t smem[];
    const int64_t r = row0 + blockIdx.x;
    const int64_t s = first[r];
    const int64_t base = first[row0];
    const int nv = static_cast<int>(first[r + 1] - s);
    if (nv == 0) return;
    int32_t* v = smem;
    int32_t* l = smem + nv;
    int32_t* mark = smem + 2 * nv;
    const bool active = do_trans && !sdel_v[r];
    for (int j = threadIdx.x; j < nv; j += blockDim.x) {
        v[j] = av[s + j];
        l[j] = al[s + j];
        mark[j] = active ? 1 : 0;  // 1 in play, 2 eliminated
    }
    __syncthreads();
    if (active) {
        const int32_t bound = wadd(l[nv - 1], fuzz);
        for (int i = 0; i < nv; ++i) {
            const int32_t mi = mark[i];
            const int32_t w = v[i];
            const int32_t li = l[i];
            __syncthreads();  // everyone has read mark[i] before demotions
            if (mi == 1) {
                const int64_t ws = first[w];
                const int nw = static_cast<int>(first[w + 1] - ws);
                for (int k = threadIdx.x; k < nw; k += blockDim.x) {
                    if (wadd(al[ws + k], li) > bound) continue;
                    const int32_t wv = av[ws + k];
                    // duplicate targets demote together
                    for (int j = 0; j < nv; ++j)
                        if (v[j] == wv && mark[j] != 0) mark[j] = 2;
                }
            }
            __syncthreads();
        }
    }
    for (int j = threadIdx.x; j < nv; j += blockDim.x) {
        const bool elim = mark[j] == 2;
        bool multi = false;
        if (!elim)
            for (int j2 = 0; j2 < j; ++j2)
                if (mark[j2] != 2 && v[j2] == v[j]) {
                    multi = true;
                    break;
                }
        out[s - base + j] = (elim ? 1 : 0) | (multi ? 2 : 0);
    }
}

}  // namespace

extern "C" int ma_trans_multi(const int64_t* first, const int32_t* av,
                              const int32_t* al, const uint8_t* sdel_v,
                              int64_t row0, int64_t n_rows, int max_deg,
                              int fuzz, int do_trans, uint8_t* bits,
                              cudaStream_t stream) {
    const size_t smem = static_cast<size_t>(max_deg) * 3 * sizeof(int32_t);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            trans_multi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    trans_multi_kernel<<<static_cast<unsigned int>(n_rows), 128, smem,
                         stream>>>(first, av, al, sdel_v, row0, fuzz,
                                   do_trans, bits);
    return static_cast<int>(cudaGetLastError());
}
