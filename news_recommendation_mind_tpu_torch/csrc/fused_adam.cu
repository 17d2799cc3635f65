// fused_adam: one in-place Adam step over every parameter leaf of a model
// in a single launch.
//
// Replaces the TPU kernel news_recommendation_mind_tpu/ops/pallas_adam.py
// adam_leaf_update (pl.pallas_call at :93), which updates one leaf per
// call. Per element, in fp32, with the scalars bc1, bc2 and the leaf's
// learning rate passed in (train/state.py:130-137):
//   mu = b1*mu + (1-b1)*g;  nu = b2*nu + (1-b2)*(g*g)
//   p += ((mu / bc1) / (sqrt(nu / bc2) + eps)) * (-lr)
// The Pallas eligibility rule (pallas_adam.py:45-56: last dim a multiple
// of 128, rows divisible by 8, at least 1,024 elements) is TPU tiling and
// is not carried over: every fp32 leaf goes through this kernel.
//
// Bound: bytes. Seven fp32 streams per element (p, mu, nu and g read; p,
// mu and nu written) and about 12 flops: 28 bytes per element. The
// newsbert PLM's 52.8 M parameters move 1.48 GB, 0.44 ms at 3.35 TB/s.
//
// Design: a multi-tensor launch. The wrapper keeps a table on the card:
// per leaf the addresses of p, mu, nu and g, its size and its
// learning-rate group; per chunk of 32,768 elements the leaf it belongs to
// and its offset there. One block takes one chunk, so a 23 M-element
// embedding and a 768-element bias go through the same launch, and the
// two learning rates (the "bert" group and the rest) are two kernel
// arguments selected by the leaf's group. Consecutive threads take
// consecutive elements. Every operation is written with an explicit
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn): -O3 would otherwise contract b1*mu + (1-b1)*g into fused
// multiply-adds, which round once where the reference rounds twice, and
// the parameters would drift from the plain version in the last bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
adam_chunks(const long long* __restrict__ leaves,   // [5][n_leaves]
            const int* __restrict__ leaf_group,      // [n_leaves]
            const int* __restrict__ chunk_leaf,      // [n_chunks]
            const long long* __restrict__ chunk_start,
            int n_leaves, int chunk, float b1, float b2, float one_minus_b1,
            float one_minus_b2, float eps, float bc1, float bc2, float lr0,
            float lr1) {
  const int leaf = chunk_leaf[blockIdx.x];
  const long long start = chunk_start[blockIdx.x];
  float* p = reinterpret_cast<float*>(leaves[leaf]) + start;
  float* mu = reinterpret_cast<float*>(leaves[n_leaves + leaf]) + start;
  float* nu = reinterpret_cast<float*>(leaves[2 * n_leaves + leaf]) + start;
  const float* g =
      reinterpret_cast<const float*>(leaves[3 * n_leaves + leaf]) + start;
  const long long left = leaves[4 * n_leaves + leaf] - start;
  const int n = left < chunk ? static_cast<int>(left) : chunk;
  const float neg_lr = -(leaf_group[leaf] ? lr1 : lr0);

  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float gi = g[i];
    const float m = __fadd_rn(__fmul_rn(b1, mu[i]),
                              __fmul_rn(one_minus_b1, gi));
    const float s = __fadd_rn(__fmul_rn(b2, nu[i]),
                              __fmul_rn(one_minus_b2, __fmul_rn(gi, gi)));
    const float m_hat = __fdiv_rn(m, bc1);
    const float s_hat = __fdiv_rn(s, bc2);
    const float upd = __fmul_rn(
        __fdiv_rn(m_hat, __fadd_rn(__fsqrt_rn(s_hat), eps)), neg_lr);
    p[i] = __fadd_rn(p[i], upd);
    mu[i] = m;
    nu[i] = s;
  }
}

}  // namespace

// leaves: int64 [5, n_leaves] on the card, rows p, mu, nu, g (addresses)
// and size (elements); leaf_group: int32 [n_leaves], 0 takes lr0 and any
// other value lr1; chunk_leaf / chunk_start: the leaf and the element
// offset of each chunk of at most `chunk` elements.
extern "C" int nrmt_fused_adam(const void* leaves, const void* leaf_group,
                               const void* chunk_leaf,
                               const void* chunk_start, int n_leaves,
                               int n_chunks, int chunk, float b1, float b2,
                               float one_minus_b1, float one_minus_b2,
                               float eps, float bc1, float bc2, float lr0,
                               float lr1, void* stream) {
  if (n_leaves < 0 || n_chunks < 0 || chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_chunks == 0) return static_cast<int>(cudaGetLastError());
  adam_chunks<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(leaves),
      static_cast<const int*>(leaf_group),
      static_cast<const int*>(chunk_leaf),
      static_cast<const long long*>(chunk_start), n_leaves, chunk, b1, b2,
      one_minus_b1, one_minus_b2, eps, bc1, bc2, lr0, lr1);
  return static_cast<int>(cudaGetLastError());
}
