// fused_add_ln_bwd: the backward of y = LayerNorm(x + dropout(res)) * scale
// + bias over the rows of an [N, H] residual stream.
//
// Replaces the TPU kernel news_recommendation_mind_tpu/ops/pallas_ln.py
// _add_ln_bwd (pl.pallas_call at :182, body _bwd_kernel :77-109). Per row,
// in fp32, from the saved mean and rstd:
//   s = x + dropout(res); xhat = (s - mean) * rstd; dxhat = dy * scale;
//   dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat));
//   dres = keep ? dx / (1 - p) : 0   (written only with dropout: without
//                                     it dres is dx and the wrapper
//                                     returns dx for both);
//   dscale = sum over rows of dy * xhat; dbias = sum over rows of dy.
// The keep mask is drawn again from the Philox bits of csrc/philox.cuh,
// the same words the forward drew.
//
// Bound: bytes. It reads dy, x and res and writes dx (and dres): 8 bytes
// per element in bf16 without dropout, 10 with. At N = 61,440, H = 768
// that is 377 MB, 0.11 ms at 3.35 TB/s, and 472 MB, 0.14 ms with dropout.
//
// Design: one warp per row, four rows in flight per 128-thread block, and
// a block walks over many rows. A lane takes groups of four consecutive
// columns (one Philox call each). The Pallas kernel adds dscale and dbias
// up across its sequential grid in one revisited block; blocks here run in
// no order, so each warp adds its rows' terms into its own [H] slice of
// shared memory, the block sums its warps' slices in a fixed order into a
// partial row [blocks, H] in device memory, and a second small kernel sums
// the partials, again in a fixed order. No float atomics: the result is
// the same from run to run. The two row means need a first pass over the
// row; the second pass reads it again from L1/L2.
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kTile = 32;

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32)
add_ln_bwd(const T* __restrict__ dy, const T* __restrict__ x,
           const T* __restrict__ res, const float* __restrict__ mean_in,
           const float* __restrict__ rstd_in, const float* __restrict__ scale,
           T* __restrict__ dx, T* __restrict__ dres,
           float* __restrict__ partials, int n, int h, uint64_t seed,
           uint32_t thresh, float keep_prob) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = (h + 3) >> 2;
  const int hpad = groups * 4;
  float* dsc = smem + static_cast<size_t>(warp) * 2 * hpad;  // [hpad]
  float* dbi = dsc + hpad;                                   // [hpad]
  for (int c = lane; c < hpad; c += 32) {
    dsc[c] = 0.f;
    dbi[c] = 0.f;
  }
  __syncwarp();

  const float inv_h = 1.0f / static_cast<float>(h);
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
       row < n; row += static_cast<long long>(gridDim.x) * kWarps) {
    const T* dyr = dy + row * h;
    const T* xr = x + row * h;
    const T* rr = res + row * h;
    const float mean = mean_in[row];
    const float rstd = rstd_in[row];

    float m1 = 0.f, m2 = 0.f;
    for (int g = lane; g < groups; g += 32) {
      nrmt::Philox4 bits;
      if constexpr (kDrop) bits = nrmt::ln_bits(seed, row, g);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * g + j;
        if (c < h) {
          float r = nrmt::to_float(rr[c]);
          if constexpr (kDrop) {
            r = nrmt::drop_value(r, bits.w[j], thresh, keep_prob);
          }
          const float xhat = (nrmt::to_float(xr[c]) + r - mean) * rstd;
          const float dxhat = nrmt::to_float(dyr[c]) * scale[c];
          m1 += dxhat;
          m2 += dxhat * xhat;
        }
      }
    }
    m1 = nrmt::warp_sum(m1) * inv_h;
    m2 = nrmt::warp_sum(m2) * inv_h;

    for (int g = lane; g < groups; g += 32) {
      nrmt::Philox4 bits;
      if constexpr (kDrop) bits = nrmt::ln_bits(seed, row, g);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * g + j;
        if (c < h) {
          float r = nrmt::to_float(rr[c]);
          if constexpr (kDrop) {
            r = nrmt::drop_value(r, bits.w[j], thresh, keep_prob);
          }
          const float xhat = (nrmt::to_float(xr[c]) + r - mean) * rstd;
          const float g_out = nrmt::to_float(dyr[c]);
          const float dxhat = g_out * scale[c];
          const float d = rstd * (dxhat - m1 - xhat * m2);
          dx[row * h + c] = nrmt::from_float<T>(d);
          if constexpr (kDrop) {
            dres[row * h + c] = nrmt::from_float<T>(
                nrmt::drop_value(d, bits.w[j], thresh, keep_prob));
          }
          dsc[c] += g_out * xhat;
          dbi[c] += g_out;
        }
      }
    }
  }
  __syncthreads();

  // the block's partial sums: its warps' slices, in warp order
  float* p_scale = partials + static_cast<size_t>(blockIdx.x) * h;
  float* p_bias = partials + (static_cast<size_t>(gridDim.x) + blockIdx.x) * h;
  for (int c = threadIdx.x; c < h; c += kWarps * 32) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += smem[static_cast<size_t>(w) * 2 * hpad + c];
      b += smem[static_cast<size_t>(w) * 2 * hpad + hpad + c];
    }
    p_scale[c] = a;
    p_bias[c] = b;
  }
}

// out[which][c] = sum over blocks of partials[which][block][c]; a tile of
// 32 columns per block, 32 threads per column, each adding every 32nd
// partial row, then one thread adds the 32 sums in order
__global__ void __launch_bounds__(kTile * kTile)
reduce_partials(const float* __restrict__ partials, float* __restrict__ out,
                int blocks, int h) {
  __shared__ float tile[kTile][kTile + 1];
  const int c = blockIdx.x * kTile + threadIdx.x;
  const float* src = partials + static_cast<size_t>(blockIdx.y) * blocks * h;
  float acc = 0.f;
  if (c < h) {
    for (int b = threadIdx.y; b < blocks; b += kTile) {
      acc += src[static_cast<size_t>(b) * h + c];
    }
  }
  tile[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < h) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kTile; ++i) total += tile[i][threadIdx.x];
    out[static_cast<size_t>(blockIdx.y) * h + c] = total;
  }
}

template <typename T>
int launch(const void* dy, const void* x, const void* res, const void* mean,
           const void* rstd, const void* scale, void* dx, void* dres,
           void* partials, void* dscale_dbias, int n, int h, int blocks,
           int drop, uint64_t seed, uint32_t thresh, float keep_prob,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * kWarps * 2 * static_cast<size_t>(((h + 3) >> 2) * 4);
  auto kernel = drop ? add_ln_bwd<T, true> : add_ln_bwd<T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x),
      static_cast<const T*>(res), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float*>(scale),
      static_cast<T*>(dx), static_cast<T*>(dres),
      static_cast<float*>(partials), n, h, seed, thresh, keep_prob);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((h + kTile - 1) / kTile, 2);
  reduce_partials<<<grid, dim3(kTile, kTile), 0, stream>>>(
      static_cast<const float*>(partials),
      static_cast<float*>(dscale_dbias), blocks, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// partials: fp32 scratch [2, blocks, h]; dscale_dbias: fp32 [2, h], row 0
// dscale and row 1 dbias; dres is written only when drop != 0. The rows
// are spread over `blocks` thread blocks, which the caller chooses.
extern "C" int nrmt_fused_add_ln_bwd(
    const void* dy, const void* x, const void* res, const void* mean,
    const void* rstd, const void* scale, void* dx, void* dres, void* partials,
    void* dscale_dbias, int n, int h, int blocks, int drop,
    unsigned long long seed, unsigned int thresh, float keep_prob, int dtype,
    void* stream) {
  if (n <= 0 || h <= 0 || blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == nrmt::kFloat32) {
    return launch<float>(dy, x, res, mean, rstd, scale, dx, dres, partials,
                         dscale_dbias, n, h, blocks, drop, seed, thresh,
                         keep_prob, st);
  }
  if (dtype == nrmt::kBFloat16) {
    return launch<__nv_bfloat16>(dy, x, res, mean, rstd, scale, dx, dres,
                                 partials, dscale_dbias, n, h, blocks, drop,
                                 seed, thresh, keep_prob, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
