// dropout_bits: the keep masks that the training kernels draw, written out
// as bytes (0 or 1) so a test can rebuild what fused_add_ln and short_mhsa
// dropped.
//
// Replaces the TPU probes news_recommendation_mind_tpu/ops/pallas_ln.py
// ln_dropout_keep_bits (pl.pallas_call at :211) and pallas_mhsa.py
// dropout_keep_bits (pl.pallas_call at :247). Those return the TPU
// hardware generator's bits per grid block; these return the Philox bits
// of csrc/philox.cuh per element coordinate, for a whole [N, H] stream and
// a whole [U, heads, S, S] probability tensor. The TPU's own bits cannot
// be matched and are not tried.
//
// Bound: one byte written per element and one Philox call (about 100
// 32-bit integer operations) per four elements; at N = 61,440, H = 768
// that is 47 MB, 14 us at 3.35 TB/s, and 1.2 G integer operations.
//
// Design: one thread per group of four columns, so no word of a Philox
// call is wasted; consecutive threads write consecutive 4-byte groups.
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ln_keep_mask(uint8_t* __restrict__ out, long long n, int h, uint64_t seed,
             uint32_t thresh) {
  const int groups = (h + 3) >> 2;
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= n * groups) return;
  const long long row = idx / groups;
  const int g = static_cast<int>(idx - row * groups);
  const nrmt::Philox4 bits = nrmt::ln_bits(seed, row, g);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = 4 * g + j;
    if (c < h) out[row * h + c] = bits.w[j] <= thresh ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
attn_keep_mask(uint8_t* __restrict__ out, long long u, int n_heads, int seq,
               uint64_t seed, uint32_t thresh) {
  const int groups = (seq + 3) >> 2;
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= u * n_heads * seq * groups) return;
  const int g = static_cast<int>(idx % groups);
  const long long rest = idx / groups;
  const int r = static_cast<int>(rest % seq);
  const long long cell = rest / seq;            // article * n_heads + head
  const int head = static_cast<int>(cell % n_heads);
  const long long article = cell / n_heads;
  const nrmt::Philox4 bits = nrmt::attn_bits(seed, article, head, r, g);
  uint8_t* row = out + (cell * seq + r) * seq;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = 4 * g + j;
    if (c < seq) row[c] = bits.w[j] <= thresh ? 1 : 0;
  }
}

}  // namespace

extern "C" int nrmt_ln_keep_mask(void* out, long long n, int h,
                                 unsigned long long seed, unsigned int thresh,
                                 void* stream) {
  if (n < 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const long long work = n * ((h + 3) >> 2);
  const long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  ln_keep_mask<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), n, h, seed, thresh);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nrmt_attn_keep_mask(void* out, long long u, int n_heads,
                                   int seq, unsigned long long seed,
                                   unsigned int thresh, void* stream) {
  if (u < 0 || n_heads <= 0 || seq <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (u == 0) return static_cast<int>(cudaGetLastError());
  const long long work = u * n_heads * seq * ((seq + 3) >> 2);
  const long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  attn_keep_mask<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), u, n_heads, seq, seed, thresh);
  return static_cast<int>(cudaGetLastError());
}
