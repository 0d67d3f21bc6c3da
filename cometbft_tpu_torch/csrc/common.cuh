// Shared macros for the port's CUDA sources.
//
// The per-lane arithmetic lives in headers as DEV functions: __device__
// under nvcc, plain inline C++ otherwise, so the same code can also be
// compiled by a host C++ compiler for a desk check of the arithmetic.
// LDG is a load through the read-only data cache on the card.
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define DEV __device__ __forceinline__
#define DCONST __constant__
#define UNROLL _Pragma("unroll")
#define NOUNROLL _Pragma("unroll 1")
#define LDG(p) __ldg(p)
#else
#define DEV static inline
#define DCONST
#define UNROLL
#define NOUNROLL
#define LDG(p) (*(p))
#endif

// 256-bit little-endian values as 8 x u32 words.
DEV void load_le256_bytes(uint32_t w[8], const uint8_t* b) {
  UNROLL
  for (int i = 0; i < 8; i++) {
    w[i] = (uint32_t)b[4 * i] | ((uint32_t)b[4 * i + 1] << 8) |
           ((uint32_t)b[4 * i + 2] << 16) | ((uint32_t)b[4 * i + 3] << 24);
  }
}
