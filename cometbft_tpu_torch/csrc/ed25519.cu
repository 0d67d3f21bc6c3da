// K5: the uncached (Straus) ed25519 verify.
//
// K5 k5_verify_batch replaces cometbft_tpu/ops/ed25519.py:339-410
// (verify_prepared and the verify half of verify_batch; the challenge
// hash of verify_batch is K2 in sha2.cu, launched first by the wrapper).
// Per signature lane: k = digest mod L and its signed radix-16 digits,
// s < L, ZIP-215 decompression of A and R, the 8-entry window table of
// -A, 64 window steps of 4 doublings + one table add + one B-window
// mixed add, then -R, three doublings and the identity test, ANDed with
// A valid, R decodable and s < L.  The TPU's one-hot multiply-reduce
// lookups become direct indexed loads.  See straus.cuh for the tables
// and the limb contract.
//
// Bound on this card: operations — about 3,700 field multiplies (370k
// 32x32->64 products) per lane against 160 bytes of input and 1 byte of
// output.  What this first version does about that bound is only this:
// one thread per lane, with the lane's -A table in local memory and the
// 1.5 KB B-window table shared by all lanes through the read-only cache.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().
#include <cuda_runtime.h>

#include "straus.cuh"

__global__ void k5_kernel(const uint8_t* __restrict__ a_enc,
                          const uint8_t* __restrict__ r_enc,
                          const uint8_t* __restrict__ s_enc,
                          const uint8_t* __restrict__ digest,
                          const uint32_t* __restrict__ bwin,
                          uint8_t* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  size_t o = (size_t)i * 32;
  bool ok = straus_verify_lane(a_enc + o, r_enc + o, s_enc + o,
                               digest + (size_t)i * 64, bwin);
  out[i] = ok ? 1 : 0;
}

// a_enc, r_enc, s_enc: n x 32 bytes; digest: n x 64 bytes; bwin: the
// 16 x 3 x 8-word B-window table; out: n bytes (1 = valid).
extern "C" int k5_verify_batch(const void* a_enc, const void* r_enc,
                               const void* s_enc, const void* digest,
                               const void* bwin, void* out, int n,
                               void* stream) {
  if (n > 0) {
    int threads = 64;
    k5_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)a_enc, (const uint8_t*)r_enc, (const uint8_t*)s_enc,
        (const uint8_t*)digest, (const uint32_t*)bwin, (uint8_t*)out, n);
  }
  return (int)cudaGetLastError();
}
