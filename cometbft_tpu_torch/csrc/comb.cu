// K3 and K4: the comb half of the verify path.
//
// K3 k3_build_a_tables replaces cometbft_tpu/ops/comb.py:74
// build_a_tables: per validator, ZIP-215 decompression of the pubkey
// (invalid keys build from the identity with valid = 0), negation, the
// 64-position x 8-entry chain of (j * 16^i) * (-A), and normalisation to
// canonical affine Niels with ONE batch inversion per validator.  One
// thread per validator; the table slots double as the chain's scratch
// and `scratch` (V x 512 x 8 words) holds the running Z products.
// Bound on this card: operations — about 10,000 field multiplies (1M
// 32x32->64 products) per validator against 49 KB written.
//
// K4 k4_verify_cached replaces cometbft_tpu/ops/comb.py:484
// verify_cached (both accumulation orders, :572 and :527) and the
// packbits / all-ok epilogue of cometbft_tpu/models/comb_verifier.py:767
// _device_verify.  One thread per signature lane: k = digest mod L,
// signed radix-16 digits, s < L, R decompression, 64 A-entry and 22
// B-entry mixed additions, -R, three doublings, identity test.  The
// TPU's f32 one-hot MXU select becomes a direct indexed load.  Bound:
// operations — about 1,000 field multiplies per lane against ~3 KB of
// table reads.  The epilogue packs (ok & live) by warp ballot in
// numpy.packbits order (lane 0 is bit 7 of byte 0) and counts rows with
// !(ok | !live) by atomics; the last block to finish writes the all-ok
// byte.
#include <cuda_runtime.h>

#include "comb.cuh"

__global__ void k3_kernel(const uint8_t* __restrict__ pubs,
                          uint32_t* __restrict__ tables,
                          uint8_t* __restrict__ valid,
                          uint32_t* __restrict__ scratch, int V) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  bool ok = comb_build_lane(pubs + (size_t)v * 32,
                            tables + (size_t)v * COMB_A_WORDS,
                            scratch + (size_t)v * COMB_NPOS_A * COMB_NENT_A * 8);
  valid[v] = ok ? 1 : 0;
}

__global__ void k4_kernel(const uint32_t* __restrict__ tables,
                          const uint8_t* __restrict__ valid,
                          const uint8_t* __restrict__ payload, int width,
                          const uint8_t* __restrict__ digest,
                          const uint32_t* __restrict__ btab,
                          int* __restrict__ counters, uint8_t* __restrict__ out,
                          int V) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  bool in_range = v < V;
  bool ok = false, live = false;
  if (in_range) {
    const uint8_t* row = payload + (size_t)v * width;
    live = row[67] == 1;
    ok = comb_verify_lane(tables + (size_t)v * COMB_A_WORDS, valid[v] != 0,
                          row, row + 32, digest + (size_t)v * 64, btab);
  }
  unsigned lane = threadIdx.x & 31;
  unsigned okmask = __ballot_sync(0xffffffffu, ok && live);
  unsigned badmask = __ballot_sync(0xffffffffu, in_range && !(ok || !live));
  int nbytes = (V + 7) / 8;
  if (lane == 0) {
    int first_byte = (v - (int)lane) / 8;  // warps start on byte boundaries
    for (int b = 0; b < 4; b++) {
      if (first_byte + b < nbytes) {
        unsigned bits = (okmask >> (8 * b)) & 0xffu;
        // bit k of `bits` is lane 8b + k; packbits puts it at bit 7 - k
        unsigned byte = __brev(bits) >> 24;
        out[first_byte + b] = (uint8_t)byte;
      }
    }
    if (badmask) {
      atomicAdd(&counters[0], __popc(badmask));
      __threadfence();
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    int done = atomicAdd(&counters[1], 1);
    if (done == (int)gridDim.x - 1) {
      int bad = atomicAdd(&counters[0], 0);
      out[nbytes] = bad == 0 ? 1 : 0;
    }
  }
}

extern "C" int k3_build_a_tables(const void* pubs, void* tables, void* valid,
                                 void* scratch, int V, void* stream) {
  if (V > 0) {
    int threads = 64;
    k3_kernel<<<(V + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)pubs, (uint32_t*)tables, (uint8_t*)valid,
        (uint32_t*)scratch, V);
  }
  return (int)cudaGetLastError();
}

// counters: 2 x int32 device scratch, zeroed here on the stream.
extern "C" int k4_verify_cached(const void* tables, const void* valid,
                                const void* payload, int width,
                                const void* digest, const void* btab,
                                void* counters, void* out, int V,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counters, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (V > 0) {
    int threads = 64;
    k4_kernel<<<(V + threads - 1) / threads, threads, 0, s>>>(
        (const uint32_t*)tables, (const uint8_t*)valid,
        (const uint8_t*)payload, width, (const uint8_t*)digest,
        (const uint32_t*)btab, (int*)counters, (uint8_t*)out, V);
  }
  return (int)cudaGetLastError();
}
