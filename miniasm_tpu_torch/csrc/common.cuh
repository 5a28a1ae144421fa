// Shared helpers for the miniasm_tpu_torch kernels.
//
// The JAX programs these kernels port compute in int32 with two's-
// complement wraparound (XLA semantics); signed overflow is undefined in
// C++, so every add/sub/shift that can wrap goes through uint32_t.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) +
                                static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) -
                                static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wshl1(int32_t a) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) << 1);
}

// number of blocks of `threads` covering n items
static inline unsigned int n_blocks(int64_t n, int threads) {
    return static_cast<unsigned int>((n + threads - 1) / threads);
}
