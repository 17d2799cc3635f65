// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11), the counter-based generator behind every dropout mask of the
// port. It stands where the TPU kernels call pltpu.prng_seed /
// prng_random_bits (news_recommendation_mind_tpu/ops/pallas_ln.py:40-46,
// pallas_mhsa.py:74-81): forward and backward kernels regenerate the same
// mask from (seed, coordinates) instead of storing it in device memory.
//
// The key is the wrapper's 64-bit seed; the counter is made of the
// element's own coordinates, never of block or thread ids, so the mask does
// not depend on the launch geometry:
//   residual stream [N, H]:        (col / 4, row low, row high, 0)
//   attention probs [U, nh, S, S]: (key col / 4, query row, head, article)
// One call yields four 32-bit words; element col takes word col % 4. An
// element is kept when its word <= round((1 - p) * (2^32 - 1)), the JAX
// kernels' threshold. ops/dropout_bits.py holds the same function in
// integer tensor ops, so a CPU run and a card run draw the same mask.
#pragma once

#include <stdint.h>

namespace nrmt {

struct Philox4 {
  uint32_t w[4];
};

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint64_t seed) {
  uint32_t k0 = static_cast<uint32_t>(seed);
  uint32_t k1 = static_cast<uint32_t>(seed >> 32);
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  Philox4 out;
  out.w[0] = c0;
  out.w[1] = c1;
  out.w[2] = c2;
  out.w[3] = c3;
  return out;
}

// the four words that decide columns 4*group .. 4*group+3 of one row of
// the [N, H] residual stream
__device__ __forceinline__ Philox4 ln_bits(uint64_t seed, long long row,
                                           int group) {
  return philox4x32_10(static_cast<uint32_t>(group),
                       static_cast<uint32_t>(row),
                       static_cast<uint32_t>(static_cast<uint64_t>(row) >> 32),
                       0u, seed);
}

// the four words that decide key columns 4*group .. 4*group+3 of one query
// row of one (article, head) probability matrix
__device__ __forceinline__ Philox4 attn_bits(uint64_t seed, long long article,
                                             int head, int qrow, int group) {
  return philox4x32_10(static_cast<uint32_t>(group),
                       static_cast<uint32_t>(qrow),
                       static_cast<uint32_t>(head),
                       static_cast<uint32_t>(article), seed);
}

// inverted dropout of one value by its Philox word: kept values are
// divided by keep_prob = 1 - p (pallas_ln.py:57, pallas_mhsa.py:121), the
// rest become 0
__device__ __forceinline__ float drop_value(float v, uint32_t word,
                                            uint32_t thresh,
                                            float keep_prob) {
  return word <= thresh ? v / keep_prob : 0.f;
}

}  // namespace nrmt
