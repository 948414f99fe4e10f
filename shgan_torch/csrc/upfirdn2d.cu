// upfirdn2d in one pass: zero-insert by `up`, signed pad/crop, 2-D FIR with up
// to 8x8 taps (flip and gain folded in on the host), decimate by `down`, for
// up, down in {1, 2}; NCHW float32 or bfloat16 in and out, float32 sums.
//
// Replaces the TPU kernel shgan_tpu/ops/fir_pallas.py:100-123 (_pallas_fir),
// which ran only the stride-1 separable FIR over an input padded by XLA; here
// the padding, the zero insertion and the decimation are index arithmetic in
// the same kernel, so the padded or upsampled tensor is never written.
//
// Bound on the card: bytes.  A 4x4 filter does 16 multiply-adds per output
// (4 where up=2), far below the card's ratio of operations to bytes; the
// least traffic is one read of the input and one write of the output.
// Design:
// * up = down = 1 (every FIR of the main path but the 3-channel image
//   upsample): a block stages a 39x39 input tile (a 32x32 output tile and
//   its halo, zero-filled where the padding falls outside the input) in
//   shared memory with row-coalesced loads, then each thread computes 4
//   outputs of a column from it; 4x4 taps are unrolled.
// * other factors: one thread per output element; the taps that meet a
//   sample are found with shifts and masks (up is 1 or 2).
// The taps ride in the kernel's parameter space.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "upfirdn2d.cuh"

namespace {

struct Taps {
  float v[shgan::kMaxTaps * shgan::kMaxTaps];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// K = 4: 4x4 taps, unrolled; K = 0: any fh, fw <= kMaxTaps.
template <typename T, int K>
__global__ void __launch_bounds__(shgan::kBlockW * shgan::kBlockH)
    upfirdn2d_tile_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t planes, int h,
                          int w, int out_h, int out_w, int padx0, int pady0, Taps taps,
                          int fh, int fw) {
  using namespace shgan;
  __shared__ float tile[kTileInH][kTileInW];
  const int ox0 = blockIdx.x * kTileW;
  const int oy0 = blockIdx.y * kTileH;
  const int th = kTileH + fh - 1;
  const int tw = kTileW + fw - 1;
  const int64_t in_plane = static_cast<int64_t>(h) * w;
  const int64_t out_plane = static_cast<int64_t>(out_h) * out_w;
  // `tile` has static storage: the lambda reads it without a capture
  auto at = [](int r, int c) { return tile[r][c]; };
  for (int64_t p = blockIdx.z; p < planes; p += gridDim.z) {
    const T* src = x + p * in_plane;
    for (int iy = threadIdx.y; iy < th; iy += kBlockH) {
      const int sy = tile_src(oy0, pady0, iy);
      const bool row_in = sy >= 0 && sy < h;
      for (int ix = threadIdx.x; ix < tw; ix += kBlockW) {
        const int sx = tile_src(ox0, padx0, ix);
        tile[iy][ix] = (row_in && sx >= 0 && sx < w)
                           ? to_float(__ldg(src + static_cast<int64_t>(sy) * w + sx))
                           : 0.0f;
      }
    }
    __syncthreads();
    const int ox = ox0 + threadIdx.x;
#pragma unroll
    for (int r = 0; r < kTileH / kBlockH; ++r) {
      const int ty = threadIdx.y + r * kBlockH;
      const int oy = oy0 + ty;
      if (oy < out_h && ox < out_w) {
        float v;
        if constexpr (K > 0) {
          v = tile_point_fixed<K, K>(at, taps.v, ty, threadIdx.x);
        } else {
          v = tile_point(at, taps.v, fh, fw, ty, threadIdx.x);
        }
        store(y + p * out_plane + static_cast<int64_t>(oy) * out_w + ox, v);
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t planes,
                                 int h, int w, int out_h, int out_w, int lupx, int lupy,
                                 int downx, int downy, int padx0, int pady0, Taps taps,
                                 int fh, int fw) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ox >= out_w || oy >= out_h) return;
  const int64_t in_plane = static_cast<int64_t>(h) * w;
  const int64_t out_plane = static_cast<int64_t>(out_h) * out_w;
  for (int64_t p = blockIdx.z; p < planes; p += gridDim.z) {
    const T* src = x + p * in_plane;
    auto load = [src, w](int sy, int sx) { return to_float(__ldg(src + sy * w + sx)); };
    const float v = shgan::upfirdn2d_point(load, h, w, lupx, lupy, downx, downy, padx0,
                                           pady0, taps.v, fh, fw, ox, oy);
    store(y + p * out_plane + static_cast<int64_t>(oy) * out_w + ox, v);
  }
}

template <typename T>
void launch(const void* x, void* y, long long planes, int h, int w, int out_h, int out_w,
            int upx, int upy, int downx, int downy, int padx0, int pady0, const Taps& t,
            int fh, int fw, cudaStream_t s) {
  const T* xin = static_cast<const T*>(x);
  T* yout = static_cast<T*>(y);
  const unsigned int gz = static_cast<unsigned int>(planes < 65535 ? planes : 65535);
  const dim3 block(shgan::kBlockW, shgan::kBlockH);
  if (upx == 1 && upy == 1 && downx == 1 && downy == 1) {
    const dim3 grid((out_w + shgan::kTileW - 1) / shgan::kTileW,
                    (out_h + shgan::kTileH - 1) / shgan::kTileH, gz);
    if (fh == 4 && fw == 4) {
      upfirdn2d_tile_kernel<T, 4><<<grid, block, 0, s>>>(xin, yout, planes, h, w, out_h,
                                                         out_w, padx0, pady0, t, fh, fw);
    } else {
      upfirdn2d_tile_kernel<T, 0><<<grid, block, 0, s>>>(xin, yout, planes, h, w, out_h,
                                                         out_w, padx0, pady0, t, fh, fw);
    }
    return;
  }
  const dim3 grid((out_w + shgan::kBlockW - 1) / shgan::kBlockW,
                  (out_h + shgan::kBlockH - 1) / shgan::kBlockH, gz);
  upfirdn2d_kernel<T><<<grid, block, 0, s>>>(
      xin, yout, planes, h, w, out_h, out_w, shgan::log2_factor(upx), shgan::log2_factor(upy),
      downx, downy, padx0, pady0, t, fh, fw);
}

bool factor_ok(int f) { return f == 1 || f == 2; }

}  // namespace

// x: contiguous [planes, h, w]; y: contiguous [planes, out_h, out_w]; dtype 0 =
// float32, 1 = bfloat16.  taps: host pointer to fh*fw row-major float32
// correlation taps.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments outside the kernels' range.
extern "C" int shgan_upfirdn2d(const void* x, void* y, int dtype, long long planes, int h,
                               int w, int out_h, int out_w, int upx, int upy, int downx,
                               int downy, int padx0, int pady0, const float* taps, int fh,
                               int fw, void* stream) {
  if (fh < 1 || fw < 1 || fh > shgan::kMaxTaps || fw > shgan::kMaxTaps || !factor_ok(upx) ||
      !factor_ok(upy) || !factor_ok(downx) || !factor_ok(downy) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (planes == 0 || out_h <= 0 || out_w <= 0) return static_cast<int>(cudaSuccess);
  Taps t = {};
  for (int i = 0; i < fh * fw; ++i) t.v[i] = taps[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, y, planes, h, w, out_h, out_w, upx, upy, downx, downy, padx0, pady0, t,
                  fh, fw, s);
  } else {
    launch<__nv_bfloat16>(x, y, planes, h, w, out_h, out_w, upx, upy, downx, downy, padx0,
                          pady0, t, fh, fw, s);
  }
  return static_cast<int>(cudaGetLastError());
}
