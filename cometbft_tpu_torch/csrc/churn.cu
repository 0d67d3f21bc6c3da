// K6: the comb-table assembly of an incremental (churn) rebuild.
//
// K6 k6_assemble_churn replaces cometbft_tpu/models/comb_verifier.py:391
// _assemble_churn: after a validator-set change, every row of the new
// set's A tables is either a reused row of the previous set's entry or a
// row of the freshly built bucket (K3 on the new keys only).  One block
// per output validator row copies that row's COMB_A_WORDS words (48 KiB)
// as 16-byte vector loads and stores and writes its valid flag.
//
// src[v] picks row v's source: src >= 0 is row src of the base tables,
// -nf <= src <= -1 is row -1 - src of the fresh bucket, and INT32_MIN
// leaves the row zero and invalid (the JAX version zero-fills rows that
// neither index names).
//
// Bound on this card: bytes — it reads and writes each 48 KiB row once
// with no arithmetic.  Consecutive threads move consecutive 16-byte
// vectors of one row, so every access is a full coalesced line.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().
#include <cuda_runtime.h>

#include "comb.cuh"

#define CHURN_ROW_VECS (COMB_A_WORDS / 4)
#define CHURN_NO_SOURCE (-2147483647 - 1)

__global__ void k6_kernel(const int4* __restrict__ base,
                          const uint8_t* __restrict__ base_valid,
                          const int4* __restrict__ fresh,
                          const uint8_t* __restrict__ fresh_valid,
                          const int* __restrict__ src, int4* __restrict__ out,
                          uint8_t* __restrict__ valid) {
  int v = blockIdx.x;
  int s = src[v];
  int4* dst = out + (size_t)v * CHURN_ROW_VECS;
  if (s == CHURN_NO_SOURCE) {
    int4 z = make_int4(0, 0, 0, 0);
    for (int i = threadIdx.x; i < CHURN_ROW_VECS; i += blockDim.x) dst[i] = z;
    if (threadIdx.x == 0) valid[v] = 0;
    return;
  }
  const int4* from = s >= 0 ? base + (size_t)s * CHURN_ROW_VECS
                            : fresh + (size_t)(-1 - s) * CHURN_ROW_VECS;
  for (int i = threadIdx.x; i < CHURN_ROW_VECS; i += blockDim.x) dst[i] = LDG(from + i);
  if (threadIdx.x == 0) valid[v] = s >= 0 ? base_valid[s] : fresh_valid[-1 - s];
}

// base (Vb rows), fresh (nf rows) and out (V rows): COMB_A_WORDS int32
// words per row, 16-byte aligned; base_valid, fresh_valid, valid: one
// byte per row; src: V int32.
extern "C" int k6_assemble_churn(const void* base, const void* base_valid,
                                 const void* fresh, const void* fresh_valid,
                                 const void* src, void* out, void* valid,
                                 int V, void* stream) {
  if (V > 0) {
    k6_kernel<<<V, 256, 0, (cudaStream_t)stream>>>(
        (const int4*)base, (const uint8_t*)base_valid, (const int4*)fresh,
        (const uint8_t*)fresh_valid, (const int*)src, (int4*)out,
        (uint8_t*)valid);
  }
  return (int)cudaGetLastError();
}
