// short_mhsa_bwd: the backward of short_mhsa (csrc/short_mhsa.cu) on the
// unsplit [U*S, H] layout: dq, dk, dv from q, k, v, the key mask and the
// output gradient do.
//
// Replaces the TPU kernel news_recommendation_mind_tpu/ops/pallas_mhsa.py
// _mhsa_bwd (pl.pallas_call at :221, body _bwd_kernel :126-166). Per
// (article, head), in fp32, with m the key mask, kp = 1 - p and keep the
// Philox mask the forward drew:
//   s = q k^T * scale; sig = softmax(where(m, s, -1e9)); pd = keep ? sig*m/kp : 0
//   dv = pd^T do;  dpd = do v^T;  dp = keep ? dpd/kp : 0;  dsig = dp * m
//   ds = sig * (dsig - sum_keys(sig * dsig))
//   dq = ds k * scale;  dk = ds^T q * scale
// A fully-masked article gives exact zeros: m = 0 zeroes dsig (so ds, dq
// and dk) and pd (so dv), while sig stays finite (uniform).
//
// Bound: bytes. Per (article, head) it reads S x hd of q, k, v and do and
// writes S x hd of dq, dk and dv, and does 10*S*S*hd flops (five
// products): at S = 30, hd = 64 that is 11 flops per bf16 byte, far under
// the card's ~295. At the training shape U = 2,048, S = 30, H = 768 in
// bf16 the 660 MB take about 0.20 ms at 3.35 TB/s.
//
// Design: one block per (article, head), as the forward. The block stages
// that head's q, k, v and do columns in shared memory as fp32 (row stride
// hd + 1), recomputes scores and softmax exactly as the forward does, and
// runs the five products in its own fp32 loops on the CUDA cores; the
// [U, heads, S, S] probabilities and their gradients never leave the SM.
// Each block owns a disjoint [S, hd] slice of dq, dk and dv, so nothing
// accumulates across blocks and the result is the same from run to run.
// At S = 64, hd = 128 the staging takes 178 KB of shared memory, which
// the entry point requests per launch; what would exceed a block's 227 KB
// is refused (the wrapper raises before it launches).
#include <math.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSeq = 64;
constexpr float kNegInf = -1e9f;
constexpr size_t kMaxSmem = 227 * 1024;

size_t smem_bytes(int seq, int hd) {
  const size_t ld = hd + 1;
  return sizeof(float) * (4 * seq * ld + 3 * seq * (seq + 1) + seq);
}

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
mhsa_bwd(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const float* __restrict__ key_mask,
         const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dk,
         T* __restrict__ dv, int seq, int hidden, int hd, float scale,
         uint64_t seed, uint32_t thresh, float keep_prob) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  const int pld = seq + 1;
  float* qs = smem;               // [seq][ld]
  float* ks = qs + seq * ld;      // [seq][ld]
  float* vs = ks + seq * ld;      // [seq][ld]
  float* gs = vs + seq * ld;      // [seq][ld] do
  float* sg = gs + seq * ld;      // [seq][pld] scores, then sig
  float* pd = sg + seq * pld;     // [seq][pld] dropped masked probabilities
  float* ds = pd + seq * pld;     // [seq][pld] dpd, then dp, then ds
  float* ms = ds + seq * pld;     // [seq] key mask

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
    gs[r * ld + c] = nrmt::to_float(dout[g]);
  }
  for (int j = threadIdx.x; j < seq; j += kThreads) {
    ms[j] = key_mask[u * seq + j];
  }
  __syncthreads();

  // scores as the forward computes them, and dpd = do v^T
  for (int i = threadIdx.x; i < seq * seq; i += kThreads) {
    const int r = i / seq, c = i - r * seq;
    float acc = 0.f, dacc = 0.f;
    for (int d = 0; d < hd; ++d) {
      acc = fmaf(qs[r * ld + d], ks[c * ld + d], acc);
      dacc = fmaf(gs[r * ld + d], vs[c * ld + d], dacc);
    }
    sg[r * pld + c] = ms[c] > 0.f ? acc * scale : kNegInf;
    ds[r * pld + c] = dacc;
  }
  __syncthreads();

  // sig = softmax over each row, one warp per row; pd = sig * mask
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < seq; r += kThreads / 32) {
    float* row = sg + r * pld;
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
    for (int c = lane; c < seq; c += 32) {
      const float sig = row[c] / sum;
      row[c] = sig;
      pd[r * pld + c] = sig * ms[c];
    }
  }
  __syncthreads();

  if constexpr (kDrop) {
    // the forward's mask again: pd and dpd are dropped alike
    const int groups = (seq + 3) >> 2;
    for (int i = threadIdx.x; i < seq * groups; i += kThreads) {
      const int r = i / groups, g = i - r * groups;
      const nrmt::Philox4 bits = nrmt::attn_bits(seed, u, head, r, g);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * g + j;
        if (c < seq) {
          pd[r * pld + c] = nrmt::drop_value(pd[r * pld + c], bits.w[j],
                                             thresh, keep_prob);
          ds[r * pld + c] = nrmt::drop_value(ds[r * pld + c], bits.w[j],
                                             thresh, keep_prob);
        }
      }
    }
    __syncthreads();
  }

  // ds = sig * (dsig - sum(sig * dsig)) with dsig = dp * mask
  for (int r = warp; r < seq; r += kThreads / 32) {
    float dot = 0.f;
    for (int c = lane; c < seq; c += 32) {
      const float dsig = ds[r * pld + c] * ms[c];
      ds[r * pld + c] = dsig;
      dot += sg[r * pld + c] * dsig;
    }
    dot = nrmt::warp_sum(dot);
    for (int c = lane; c < seq; c += 32) {
      ds[r * pld + c] = sg[r * pld + c] * (ds[r * pld + c] - dot);
    }
  }
  __syncthreads();

  // dq = ds k * scale, dk = ds^T q * scale, dv = pd^T do, written at
  // column head*hd of the [U*S, H] gradients
  for (int i = threadIdx.x; i < seq * hd; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    float aq = 0.f, ak = 0.f, av = 0.f;
    for (int j = 0; j < seq; ++j) {
      aq = fmaf(ds[r * pld + j], ks[j * ld + c], aq);
      ak = fmaf(ds[j * pld + r], qs[j * ld + c], ak);
      av = fmaf(pd[j * pld + r], gs[j * ld + c], av);
    }
    const long long g = base + static_cast<long long>(r) * hidden + c;
    dq[g] = nrmt::from_float<T>(aq * scale);
    dk[g] = nrmt::from_float<T>(ak * scale);
    dv[g] = nrmt::from_float<T>(av);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* dout, void* dq, void* dk, void* dv, int u, int seq,
           int hidden, int n_heads, int drop, uint64_t seed, uint32_t thresh,
           float keep_prob, cudaStream_t stream) {
  const int hd = hidden / n_heads;
  const size_t smem = smem_bytes(seq, hd);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = drop ? mhsa_bwd<T, true> : mhsa_bwd<T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(u, n_heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), seq, hidden, hd,
      1.0f / sqrtf(static_cast<float>(hd)), seed, thresh, keep_prob);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nrmt_short_mhsa_bwd(const void* q, const void* k,
                                   const void* v, const void* key_mask,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, int u, int seq, int hidden,
                                   int n_heads, int drop,
                                   unsigned long long seed,
                                   unsigned int thresh, float keep_prob,
                                   int dtype, void* stream) {
  if (u < 0 || seq <= 0 || seq > kMaxSeq || n_heads <= 0 ||
      n_heads > 65535 || hidden % n_heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (u == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == nrmt::kFloat32) {
    return launch<float>(q, k, v, key_mask, dout, dq, dk, dv, u, seq, hidden,
                         n_heads, drop, seed, thresh, keep_prob, st);
  }
  if (dtype == nrmt::kBFloat16) {
    return launch<__nv_bfloat16>(q, k, v, key_mask, dout, dq, dk, dv, u, seq,
                                 hidden, n_heads, drop, seed, thresh,
                                 keep_prob, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
