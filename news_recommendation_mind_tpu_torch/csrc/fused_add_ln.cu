// fused_add_ln: y = LayerNorm(x + res) * scale + bias over the rows of an
// [N, H] residual stream, with the fp32 row mean and rstd as side outputs.
//
// Replaces the TPU kernel news_recommendation_mind_tpu/ops/pallas_ln.py
// _add_ln_fwd_impl (pl.pallas_call at :136, entry fused_add_ln :240), the
// forward without dropout: serving is deterministic, and the backward and
// the dropout bits come with the training slice.
//
// Bound: bytes. Per row it reads x and res and writes y (6 bytes per
// element in bf16) and does about 8 flops per element, far under the
// card's ~295 flops per byte. At the serving shape N = 15,000, H = 768 in
// bf16 that is 69 MB, about 21 us at 3.35 TB/s.
//
// Design: one warp per row, eight rows per 256-thread block, so no
// shared memory and no block-wide barrier; the two sums (s and s*s) are
// reduced in fp32 with warp shuffles. The second pass reads the row again,
// which the first pass has just brought into L1/L2. The math is the JAX
// kernel's exactly: var = E[s^2] - mean^2 (pallas_ln.py:66-68),
// rstd = rsqrt(var + eps). Unlike the Pallas dispatcher there is no
// H % 128 or N % 8 rule: lanes stride over any H.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

template <typename T>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
add_ln_fwd(const T* __restrict__ x, const T* __restrict__ res,
           const float* __restrict__ scale, const float* __restrict__ bias,
           T* __restrict__ y, float* __restrict__ mean_out,
           float* __restrict__ rstd_out, int n, int h, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const T* xr = x + row * h;
  const T* rr = res + row * h;

  float sum = 0.f, sumsq = 0.f;
  for (int c = lane; c < h; c += 32) {
    const float s = nrmt::to_float(xr[c]) + nrmt::to_float(rr[c]);
    sum += s;
    sumsq += s * s;
  }
  sum = nrmt::warp_sum(sum);
  sumsq = nrmt::warp_sum(sumsq);
  const float mean = sum / static_cast<float>(h);
  const float var = sumsq / static_cast<float>(h) - mean * mean;
  const float rstd = rsqrtf(var + eps);

  T* yr = y + row * h;
  for (int c = lane; c < h; c += 32) {
    const float s = nrmt::to_float(xr[c]) + nrmt::to_float(rr[c]);
    yr[c] = nrmt::from_float<T>((s - mean) * rstd * scale[c] + bias[c]);
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T>
void launch(const void* x, const void* res, const void* scale,
            const void* bias, void* y, void* mean, void* rstd, int n, int h,
            float eps, cudaStream_t stream) {
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock);
  add_ln_fwd<T><<<grid, kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(y), static_cast<float*>(mean),
      static_cast<float*>(rstd), n, h, eps);
}

}  // namespace

extern "C" int nrmt_fused_add_ln(const void* x, const void* res,
                                 const void* scale, const void* bias,
                                 void* y, void* mean, void* rstd, int n,
                                 int h, float eps, int dtype, void* stream) {
  if (n < 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == nrmt::kFloat32) {
    launch<float>(x, res, scale, bias, y, mean, rstd, n, h, eps, st);
  } else if (dtype == nrmt::kBFloat16) {
    launch<__nv_bfloat16>(x, res, scale, bias, y, mean, rstd, n, h, eps, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nrmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
