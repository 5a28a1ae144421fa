// K7 key_member and K8 dup_mark: the symmetrisation passes of the oracle
// clean modes (MINIASM_TPU_CLEAN=native|py), each the whole function from
// the int32 key columns on the card to the bool mask.
//
// K7 key_member (port of miniasm_tpu/utils/arrays.py:81 member_multi, the
// core of graph/clean.py:45 del_asymm_mask): is each needle key among the
// hay keys?  Hay rows at or past hay_n take INT32_MAX in every column, and
// needles at or past needle_n are not found, as in the JAX function.
// K8 dup_mark (port of graph/clean.py:32 del_multi_mask): mark every arc
// i for which an arc j < i has the same (u, v); the first arc of each key
// in arc order stays (asg.c:108-115).
//
// The JAX programs sort hay and needles (or the arcs) with a stable
// multi-key sort and compare neighbours.  Here a key of 1 or 2 int32
// columns is packed in registers into 64 bits (one column sign-extended,
// two as hi << 32 | lo) and hashed into an open-addressing table in device
// memory whose slots hold row indices, not keys:
//   - capacity a power of two of at least SLOTS_PER_KEY (8, in
//     utils/arrays.py) times the keys, sized from n on every call: load
//     factor at most 1/8, as a pass lasts as long as its longest probe
//     chain.  At the E. coli noisy size (about 31,000 arcs) the table is
//     1 MB, inside the 50 MB L2 where the atomics resolve; millions of
//     arcs spill to device memory, which only costs time;
//   - slot = fmix64(key) & (capacity - 1), then linear probing (+1 slot);
//   - a slot holds 0xFFFFFFFF (the wrapper's one memset of 0xFF bytes)
//     until a row claims it with a 32-bit atomicCAS.  A row index is below
//     2^31, so the empty marker is never an index, and no key value needs
//     a marker: (-1, -1), which packs to all ones, is a key like any other.
//     A probe compares keys by reading the claimed row's columns again.
// K8: a build pass claims a slot for each arc's key with its index, or
// finds the slot that holds an arc of the same key and does
// atomicMin(slot, i); a slot only ever holds indices of one key, so it
// ends at the least.  A mark pass finds the slot again and writes
// mask[i] = slot != i.  The minimum is the same whatever order the
// atomics run in, so the mask is deterministic and equals the stable
// sort's.  K7: a build pass inserts the hay rows (row hay_n stands for
// all the pads) and a probe pass looks each needle up; an empty slot ends
// the probe.  Each is one memset and two launches, with no grid-wide sync
// inside a launch.
//
// Bound on the card: bytes.  The columns are read once (4 bytes a column
// a key) and the mask written once; the table adds one slot access a key
// in each pass and a read of the claimed row's columns on a hit, from L2
// at these sizes.  At tens of thousands of keys the passes last a few
// microseconds: launch latency and a few dependent L2 round trips, not
// bandwidth, are what the card sees.  Distinct keys (the E. coli graphs
// have no multi-arc) cost K8 one CAS in the build and one load in the
// mark pass, which finds its own index.
#include "common.cuh"

namespace {

constexpr unsigned int NONE = 0xFFFFFFFFu;  // an empty slot
constexpr int THREADS = 256;

// the key of row i: one column sign-extended, two as c0 << 32 | c1, each
// column xor xr
__device__ __forceinline__ unsigned long long key_at(const int32_t* c0,
                                                     const int32_t* c1,
                                                     int64_t i, int32_t xr) {
    const int32_t a = c0[i] ^ xr;
    if (c1 == nullptr)
        return static_cast<unsigned long long>(static_cast<int64_t>(a));
    const uint32_t b = static_cast<uint32_t>(c1[i] ^ xr);
    return (static_cast<unsigned long long>(static_cast<uint32_t>(a)) << 32) |
           b;
}

// the key of hay row i: rows at or past hay_n are INT32_MAX in every column
__device__ __forceinline__ unsigned long long hay_key(const int32_t* h0,
                                                      const int32_t* h1,
                                                      int64_t i,
                                                      int64_t hay_n) {
    if (i < hay_n) return key_at(h0, h1, i, 0);
    return h1 ? 0x7FFFFFFF7FFFFFFFull : 0x7FFFFFFFull;
}

// MurmurHash3's 64-bit finaliser: every key bit reaches the low bits
__device__ __forceinline__ unsigned long long fmix64(unsigned long long k) {
    k ^= k >> 33;
    k *= 0xff51afd7ed558ccdull;
    k ^= k >> 33;
    k *= 0xc4ceb9fe1a85ec53ull;
    k ^= k >> 33;
    return k;
}

__global__ void dup_build_kernel(const int32_t* __restrict__ u,
                                 const int32_t* __restrict__ v, int64_t n,
                                 unsigned int* __restrict__ tab,
                                 unsigned long long cap_mask) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
    if (i >= n) return;
    const unsigned long long k = key_at(u, v, i, 0);
    const unsigned int idx = static_cast<unsigned int>(i);
    for (unsigned long long s = fmix64(k) & cap_mask;;
         s = (s + 1) & cap_mask) {
        const unsigned int prev = atomicCAS(&tab[s], NONE, idx);
        if (prev == NONE) return;
        if (key_at(u, v, prev, 0) == k) {
            atomicMin(&tab[s], idx);
            return;
        }
    }
}

__global__ void dup_mark_kernel(const int32_t* __restrict__ u,
                                const int32_t* __restrict__ v, int64_t n,
                                const unsigned int* __restrict__ tab,
                                unsigned long long cap_mask,
                                uint8_t* __restrict__ mask) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
    if (i >= n) return;
    const unsigned long long k = key_at(u, v, i, 0);
    const unsigned int idx = static_cast<unsigned int>(i);
    // the build pass left k's least index in a slot on this path
    for (unsigned long long s = fmix64(k) & cap_mask;;
         s = (s + 1) & cap_mask) {
        const unsigned int p = tab[s];
        if (p == idx || key_at(u, v, p, 0) == k) {
            mask[i] = p != idx;
            return;
        }
    }
}

__global__ void member_build_kernel(const int32_t* __restrict__ h0,
                                    const int32_t* __restrict__ h1,
                                    int64_t rows, int64_t hay_n,
                                    unsigned int* __restrict__ tab,
                                    unsigned long long cap_mask) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
    if (i >= rows) return;
    const unsigned long long k = hay_key(h0, h1, i, hay_n);
    for (unsigned long long s = fmix64(k) & cap_mask;;
         s = (s + 1) & cap_mask) {
        const unsigned int prev =
            atomicCAS(&tab[s], NONE, static_cast<unsigned int>(i));
        if (prev == NONE || hay_key(h0, h1, prev, hay_n) == k) return;
    }
}

__global__ void member_probe_kernel(const int32_t* __restrict__ h0,
                                    const int32_t* __restrict__ h1,
                                    int64_t hay_n,
                                    const int32_t* __restrict__ q0,
                                    const int32_t* __restrict__ q1,
                                    int64_t mq, int64_t needle_n,
                                    int32_t xr,
                                    const unsigned int* __restrict__ tab,
                                    unsigned long long cap_mask,
                                    uint8_t* __restrict__ found) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
    if (i >= mq) return;
    if (i >= needle_n) {
        found[i] = 0;
        return;
    }
    const unsigned long long k = key_at(q0, q1, i, xr);
    for (unsigned long long s = fmix64(k) & cap_mask;;
         s = (s + 1) & cap_mask) {
        const unsigned int p = tab[s];
        if (p == NONE || hay_key(h0, h1, p, hay_n) == k) {
            found[i] = p != NONE;
            return;
        }
    }
}

}  // namespace

// table: cap 4-byte slots, cap a power of two above n.  1 <= n < 2^31.
extern "C" int ma_dup_mark(const int32_t* u, const int32_t* v, int64_t n,
                           unsigned int* table, int64_t cap, uint8_t* mask,
                           cudaStream_t stream) {
    cudaError_t err = cudaMemsetAsync(table, 0xFF, cap * sizeof(unsigned int),
                                      stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned long long cm = static_cast<unsigned long long>(cap - 1);
    dup_build_kernel<<<n_blocks(n, THREADS), THREADS, 0, stream>>>(
        u, v, n, table, cm);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dup_mark_kernel<<<n_blocks(n, THREADS), THREADS, 0, stream>>>(
        u, v, n, table, cm, mask);
    return static_cast<int>(cudaGetLastError());
}

// h1 and q1 null for one column.  rows: the hay rows inserted (hay_n, and
// one more for the pads when hay_n is below the hay's length); table: cap
// 4-byte slots, cap a power of two above rows.  1 <= mq < 2^31.
extern "C" int ma_key_member(const int32_t* h0, const int32_t* h1,
                             int64_t rows, int64_t hay_n, const int32_t* q0,
                             const int32_t* q1, int64_t mq, int64_t needle_n,
                             int32_t xr, unsigned int* table, int64_t cap,
                             uint8_t* found, cudaStream_t stream) {
    cudaError_t err = cudaMemsetAsync(table, 0xFF, cap * sizeof(unsigned int),
                                      stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned long long cm = static_cast<unsigned long long>(cap - 1);
    if (rows > 0) {
        member_build_kernel<<<n_blocks(rows, THREADS), THREADS, 0, stream>>>(
            h0, h1, rows, hay_n, table, cm);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    member_probe_kernel<<<n_blocks(mq, THREADS), THREADS, 0, stream>>>(
        h0, h1, hay_n, q0, q1, mq, needle_n, xr, table, cm, found);
    return static_cast<int>(cudaGetLastError());
}
