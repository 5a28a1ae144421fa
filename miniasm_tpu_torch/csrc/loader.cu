// Kernels of the main path's streamed loader (io/native/pafload.py).
//
// The host parser (io/native/pafmt.cpp) fills pinned staging pieces in
// the flat FMT3 layout (13.5 B a record) while the stream stays
// query-grouped with 16-bit coordinates, else in the 4-row packed layout
// (16 B); each piece is copied to the card on a side stream and decoded
// there at once, and at stream end every piece is unpacked into the
// exact-size (7, n) colmat [qid qs qe tid ts te flags] that the select
// step takes.
//
// K9 decode3 replaces miniasm_tpu/io/native/pafload.py:267 _decode3_body
// (run per piece by _decode3_jit l.249, or over the whole stream by
// _decode3_concat_jit l.292).  Input: one flat piece of n records (n a
// multiple of 16), int32 words [3n coordinate words (tid, qs<<16|qe,
// ts<<16|te) | n/8 flag-nibble words | n/8 run starts, -1 padded | n/8
// run qids].  Output: the (4, n) packed layout [qid|flags<<28, tid,
// qs<<16|qe, ts<<16|te].  One thread per record; its qid is the qid of
// the last run start at or before it (0 before the first), found by a
// binary search over the run starts: their valid prefix is ascending and
// their tail is -1, so "start valid and <= i" holds on a prefix.  (The
// JAX program scatters run deltas and takes a cumsum; on such input the
// two agree.)  Bound by bytes: 13.5 B read and 16 B written a record,
// about 1.2 us for a 2^17-record piece at 3.35 TB/s; the n/8-word run
// table a record searches (at most 64 KB a piece) stays in L1/L2.
//
// K10 unpack4 replaces pafload.py:344 _unpack4_jit (the same function
// runs inline in _select2_kernel, select/fused2.py:316-326) and the
// piece concatenation of _concat_jit (l.239) and _decode3_concat_jit:
// it writes its piece's n columns straight into the colmat at the
// piece's column offset, so no concatenation copy is needed.  One thread
// per record, elementwise on unsigned words.  Bound by bytes: 16 B read
// and 28 B written a record.
#include "common.cuh"

namespace {

__global__ void decode3_kernel(const int32_t* __restrict__ flat, int64_t n,
                               int32_t* __restrict__ out) {
    int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int64_t m = n / 8;
    const uint32_t* nibw = reinterpret_cast<const uint32_t*>(flat + 3 * n);
    const int32_t* bpos = flat + 3 * n + m;
    const int32_t* bqid = bpos + m;
    // lo = the number of run starts at or before record i
    int64_t lo = 0, hi = m;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        int32_t p = bpos[mid];
        if (p >= 0 && p <= i)
            lo = mid + 1;
        else
            hi = mid;
    }
    uint32_t qid = lo ? static_cast<uint32_t>(bqid[lo - 1]) : 0u;
    uint32_t nib = (nibw[i >> 3] >> (4 * (i & 7))) & 0xFu;
    out[i] = static_cast<int32_t>(qid | (nib << 28));
    out[n + i] = flat[i];
    out[2 * n + i] = flat[n + i];
    out[3 * n + i] = flat[2 * n + i];
}

__global__ void unpack4_kernel(const int32_t* __restrict__ src,
                               int64_t src_cols, int64_t n,
                               int32_t* __restrict__ dst, int64_t dst_cols,
                               int64_t col) {
    int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (j >= n) return;
    uint32_t w0 = static_cast<uint32_t>(src[j]);
    int32_t tid = src[src_cols + j];
    uint32_t qsqe = static_cast<uint32_t>(src[2 * src_cols + j]);
    uint32_t tste = static_cast<uint32_t>(src[3 * src_cols + j]);
    int32_t* d = dst + col + j;
    d[0] = static_cast<int32_t>(w0 & 0x0FFFFFFFu);
    d[dst_cols] = static_cast<int32_t>(qsqe >> 16);
    d[2 * dst_cols] = static_cast<int32_t>(qsqe & 0xFFFFu);
    d[3 * dst_cols] = tid;
    d[4 * dst_cols] = static_cast<int32_t>(tste >> 16);
    d[5 * dst_cols] = static_cast<int32_t>(tste & 0xFFFFu);
    d[6 * dst_cols] = static_cast<int32_t>(w0 >> 28);
}

}  // namespace

extern "C" int ma_decode3(const int32_t* flat, int64_t n, int32_t* out,
                          cudaStream_t stream) {
    const int threads = 256;
    decode3_kernel<<<n_blocks(n, threads), threads, 0, stream>>>(flat, n,
                                                                 out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int ma_unpack4(const int32_t* src, int64_t src_cols, int64_t n,
                          int32_t* dst, int64_t dst_cols, int64_t col,
                          cudaStream_t stream) {
    const int threads = 256;
    unpack4_kernel<<<n_blocks(n, threads), threads, 0, stream>>>(
        src, src_cols, n, dst, dst_cols, col);
    return static_cast<int>(cudaGetLastError());
}
