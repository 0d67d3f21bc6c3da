// K5: the uncached (Straus) ed25519 verify.
//
// K5 k5_verify_batch replaces cometbft_tpu/ops/ed25519.py:339-410
// (verify_prepared and the verify half of verify_batch; the challenge
// hash of verify_batch is K2 in sha2.cu, launched first by the wrapper).
// Per signature lane: k = digest mod L and its signed radix-16 digits,
// s < L, ZIP-215 decompression of A and R, the 8-entry window table of
// -A, 64 window steps of 4 doublings + one table add + one B-window
// add, then -R, three doublings and the identity test, ANDed with A
// valid, R decodable and s < L.  The TPU's one-hot multiply-reduce
// lookups become direct indexed loads.  See straus.cuh for the tables
// and the limb contract.
//
// Bound on this card: operations — about 3,650 field multiplies (365k
// 32x32->64 products) per lane against 160 bytes of input and 1 byte of
// output.  The first design ran one thread a lane through all of them as
// one dependent chain (~1,440 cycles a multiply): 256 lanes took 92% of
// the time of 16,384.  This design gives a lane a group of G neighbouring
// threads of one warp that share each point operation's independent
// multiplies (ge25519_group.cuh; the -A table in shared memory), and
// picks G by batch size:
//   - G = 4 up to STRAUS_G4_MAX_LANES = 12,288 lanes: the shortest chain,
//     ~1,070 multiply phases a lane (A's square root, the table, 64
//     windows of 12), for batches that leave the schedulers short of
//     warps (the light client's 256 lanes: 16 blocks on 16 SMs).  At 156
//     registers an SM holds 6 blocks of 16 lanes, so 12,672 lanes fill
//     one wave of 132 SMs;
//   - G = 2 above: a lane issues ~3,720 multiplies instead of ~4,280 (A
//     and R decode on one thread each, not two, and a phase's shuffles
//     and selections serve two multiplies), and at 254 registers 16,384
//     lanes still run in one wave, so the instructions issued set the
//     time.  At 256 lanes it is 2.4x slower than G = 4, at 16,384 1.3x
//     faster (PERF.md, run 10c).
// Both instantiations spend more multiplies than the function (a cached
// conversion's 2d T on every thread, the B-window add as a cached one).
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().
#include <cuda_runtime.h>

#include "straus.cuh"

template <int G>
__global__ void __launch_bounds__(STRAUS_LANES * G, STRAUS_MIN_BLOCKS)
    k5_kernel(const uint8_t* __restrict__ a_enc, const uint8_t* __restrict__ r_enc,
              const uint8_t* __restrict__ s_enc, const uint8_t* __restrict__ digest,
              const uint32_t* __restrict__ bwin, uint8_t* __restrict__ out, int n) {
  __shared__ StrausShared sm;
  grp_t g;
  g.t = threadIdx.x % G;
  const int j = threadIdx.x / G;
  const int lane = blockIdx.x * STRAUS_LANES + j;
  const int v = lane < n ? lane : n - 1;  // every thread runs: the group's shuffles need it
  const size_t o = (size_t)v * 32;
  const bool ok = straus_group_verify<G>(a_enc + o, r_enc + o, s_enc + o, digest + (size_t)v * 64, bwin, sm, j, g);
  if (lane < n && g.t == 0) out[lane] = ok ? 1 : 0;
}

// a_enc, r_enc, s_enc: n x 32 bytes; digest: n x 64 bytes; bwin: the
// 16 x 3 x 8-word B-window table; out: n bytes (1 = valid).
extern "C" int k5_verify_batch(const void* a_enc, const void* r_enc,
                               const void* s_enc, const void* digest,
                               const void* bwin, void* out, int n,
                               void* stream) {
  if (n > 0) {
    const int blocks = (n + STRAUS_LANES - 1) / STRAUS_LANES;
    cudaStream_t s = (cudaStream_t)stream;
    if (n <= STRAUS_G4_MAX_LANES) {
      k5_kernel<4><<<blocks, STRAUS_LANES * 4, 0, s>>>((const uint8_t*)a_enc, (const uint8_t*)r_enc,
                                                       (const uint8_t*)s_enc, (const uint8_t*)digest,
                                                       (const uint32_t*)bwin, (uint8_t*)out, n);
    } else {
      k5_kernel<2><<<blocks, STRAUS_LANES * 2, 0, s>>>((const uint8_t*)a_enc, (const uint8_t*)r_enc,
                                                       (const uint8_t*)s_enc, (const uint8_t*)digest,
                                                       (const uint32_t*)bwin, (uint8_t*)out, n);
    }
  }
  return (int)cudaGetLastError();
}
