// short_mhsa: full multi-head self-attention over short articles (S <= 64)
// on the unsplit [U*S, H] layout, with the masked fp32 softmax of
// models/attention.py::masked_softmax (masked keys get exactly 0, and a
// fully-masked article comes out all-zero, never NaN).
//
// Replaces the TPU kernel news_recommendation_mind_tpu/ops/pallas_mhsa.py
// _mhsa_fwd_impl (pl.pallas_call at :195, entry short_mhsa :303), the
// forward without prob dropout: serving is deterministic, and the backward
// and the dropout bits come with the training slice.
//
// Bound: bytes. Per (article, head) it reads S x hd of q, k and v and
// writes S x hd of output, and does 4*S*S*hd flops: at S = 30, hd = 64
// that is 7.5 flops per bf16 byte, far under the card's ~295. At the
// serving shape U = 500, S = 30, H = 768 in bf16 the 92 MB of q/k/v/out
// take about 27 us at 3.35 TB/s.
//
// Design: one block per (article, head); the block stages that head's
// q, k and v columns in shared memory as fp32 (row stride hd + 1, so
// walking a column touches 32 different banks), computes the S x S scores
// and P*V in its own fp32 loops, and writes back at column head*hd. So the
// head split needs no transpose in device memory, and the [U, heads, S, S]
// probabilities never leave the SM. The Pallas kernel's block-diagonal
// packing of several articles and the lane stacking of head groups exist
// for the TPU's 128-lane tiles and are not carried over. The products run
// on the CUDA cores, not the tensor cores, and every multiply-add loads
// both operands from shared memory: on an H100 this form takes the same
// time in bf16 and fp32 (0.24 ms at the serving shape), bound by those
// shared-memory loads rather than by device memory. Register tiles or
// mma/wgmma are the next step.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSeq = 64;
constexpr float kNegInf = -1e9f;

size_t smem_bytes(int seq, int hd) {
  const size_t ld = hd + 1;
  return sizeof(float) * (3 * seq * ld + seq * (seq + 1) + seq);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mhsa_fwd(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const float* __restrict__ key_mask,
         T* __restrict__ out, int seq, int hidden, int hd, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  const int pld = seq + 1;
  float* qs = smem;              // [seq][ld]
  float* ks = qs + seq * ld;     // [seq][ld]
  float* vs = ks + seq * ld;     // [seq][ld]
  float* ps = vs + seq * ld;     // [seq][pld] scores, then probabilities
  float* ms = ps + seq * pld;    // [seq] key mask

  const long long u = blockIdx.x;
  const int head = blockIdx.y;
  const long long base =
      u * seq * static_cast<long long>(hidden) +
      static_cast<long long>(head) * hd;

  for (int i = threadIdx.x; i < seq * hd; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    const long long g = base + static_cast<long long>(r) * hidden + c;
    qs[r * ld + c] = nrmt::to_float(q[g]);
    ks[r * ld + c] = nrmt::to_float(k[g]);
    vs[r * ld + c] = nrmt::to_float(v[g]);
  }
  for (int j = threadIdx.x; j < seq; j += kThreads) {
    ms[j] = key_mask[u * seq + j];
  }
  __syncthreads();

  // scores = q k^T * scale, with masked keys set to -1e9
  for (int i = threadIdx.x; i < seq * seq; i += kThreads) {
    const int r = i / seq, c = i - r * seq;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d) {
      acc = fmaf(qs[r * ld + d], ks[c * ld + d], acc);
    }
    ps[r * pld + c] = ms[c] > 0.f ? acc * scale : kNegInf;
  }
  __syncthreads();

  // softmax over each row, one warp per row, then times the key mask
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < seq; r += kThreads / 32) {
    float* row = ps + r * pld;
    float mx = -INFINITY;
    for (int c = lane; c < seq; c += 32) mx = fmaxf(mx, row[c]);
    mx = nrmt::warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < seq; c += 32) {
      const float e = expf(row[c] - mx);
      row[c] = e;
      sum += e;
    }
    sum = nrmt::warp_sum(sum);
    for (int c = lane; c < seq; c += 32) row[c] = row[c] / sum * ms[c];
  }
  __syncthreads();

  // out = P v, written at column head*hd of the [U*S, H] output
  for (int i = threadIdx.x; i < seq * hd; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    float acc = 0.f;
    for (int j = 0; j < seq; ++j) {
      acc = fmaf(ps[r * pld + j], vs[j * ld + c], acc);
    }
    out[base + static_cast<long long>(r) * hidden + c] =
        nrmt::from_float<T>(acc);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
            void* out, int u, int seq, int hidden, int n_heads,
            cudaStream_t stream) {
  const int hd = hidden / n_heads;
  const size_t smem = smem_bytes(seq, hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mhsa_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(u, n_heads);
  mhsa_fwd<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<T*>(out), seq, hidden, hd,
      1.0f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nrmt_short_mhsa(const void* q, const void* k, const void* v,
                               const void* key_mask, void* out, int u,
                               int seq, int hidden, int n_heads, int dtype,
                               void* stream) {
  if (u < 0 || seq <= 0 || seq > kMaxSeq || n_heads <= 0 ||
      n_heads > 65535 || hidden % n_heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (u == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == nrmt::kFloat32) {
    return launch<float>(q, k, v, key_mask, out, u, seq, hidden, n_heads, st);
  }
  if (dtype == nrmt::kBFloat16) {
    return launch<__nv_bfloat16>(q, k, v, key_mask, out, u, seq, hidden,
                                 n_heads, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
