// K7 key_member and K8 dup_mark: the device halves of the symmetrisation
// passes of the oracle clean modes (MINIASM_TPU_CLEAN=native|py).
//
// K7 key_member (port of miniasm_tpu/utils/arrays.py:81 member_multi, the
// core of graph/clean.py:45 del_asymm_mask): is each needle key among the
// hay keys?  The key tuples arrive packed into one int64 each
// (utils/arrays.py), the hay sorted by torch.sort.  One thread per needle
// runs a lower-bound binary search over the sorted hay and writes `found`
// at the needle's own index; needles at or past needle_n are not found.
//
// K8 dup_mark (port of graph/clean.py:32 del_multi_mask): given the stable
// torch.sort of the packed (u, v) arc keys and its permutation, mark every
// arc whose key repeats the key just before it in sorted order:
// mask[perm[i]] = i > 0 && key[i] == key[i-1].  The stable sort keeps
// equal keys in index order, so the first arc of each (u, v) stays, as the
// JAX function's stable multi-key sort keeps it (clean.py:36-42).
//
// Bound on the card: both are bytes-bound.  K8 reads 16 B (key, perm) and
// one neighbour key per arc and writes 1 B.  K7 reads 8 B and writes 1 B
// per needle, plus log2(hay) probes of the sorted hay, which stay in L2 at
// these sizes (10^4-10^5 arcs: under 1 MB of keys); a launch lasts
// microseconds, so launch latency, not bandwidth, is what the card sees.
#include "common.cuh"

namespace {

__global__ void key_member_kernel(const int64_t* __restrict__ hay,
                                  int64_t mh,
                                  const int64_t* __restrict__ needles,
                                  int64_t mq, int64_t needle_n,
                                  uint8_t* __restrict__ found) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
    if (i >= mq) return;
    uint8_t f = 0;
    if (i < needle_n) {
        const int64_t k = needles[i];
        int64_t lo = 0, hi = mh;
        while (lo < hi) {
            const int64_t mid = lo + ((hi - lo) >> 1);
            if (hay[mid] < k)
                lo = mid + 1;
            else
                hi = mid;
        }
        f = lo < mh && hay[lo] == k;
    }
    found[i] = f;
}

__global__ void dup_mark_kernel(const int64_t* __restrict__ key,
                                const int64_t* __restrict__ perm, int64_t n,
                                uint8_t* __restrict__ mask) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
    if (i >= n) return;
    mask[perm[i]] = i > 0 && key[i] == key[i - 1];
}

}  // namespace

extern "C" int ma_key_member(const int64_t* hay, int64_t mh,
                             const int64_t* needles, int64_t mq,
                             int64_t needle_n, uint8_t* found,
                             cudaStream_t stream) {
    key_member_kernel<<<n_blocks(mq, 256), 256, 0, stream>>>(
        hay, mh, needles, mq, needle_n, found);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int ma_dup_mark(const int64_t* key, const int64_t* perm,
                           int64_t n, uint8_t* mask, cudaStream_t stream) {
    dup_mark_kernel<<<n_blocks(n, 256), 256, 0, stream>>>(key, perm, n,
                                                          mask);
    return static_cast<int>(cudaGetLastError());
}
