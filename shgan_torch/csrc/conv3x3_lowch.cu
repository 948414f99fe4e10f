// 3x3, stride-1, pad-1 convolution for C_in, C_out <= 32 (kernel K3): NCHW
// float32 or bfloat16 in and out, float32 weights (OIHW correlation kernel),
// float32 sums.
//
// Replaces the TPU kernel shgan_tpu/ops/conv1024.py::conv3x3_lowch (body
// `_kernel`), which ran the conv as three dy-shifted [O,3C] x [3C,BH*W]
// contractions over three row-shifted copies of the padded input, because
// blocked BlockSpecs cannot express overlapping windows.  Here a block stages
// its input tile with the 1-pixel halo in shared memory, so the input is read
// from device memory once (plus the halo) and no shifted copy is written.
//
// Bound on the card: operations.  Each output does 9*C multiply-adds per
// output channel (288 at C = 32) against 8 bytes moved per pixel and channel,
// far above the card's float32 ratio of operations to bytes; the least time
// is 2*N*H*W*9*C*O flops at the float32 rate outside the tensor cores.
// Design: every thread keeps 8 output channels x 8 consecutive pixels (64
// sums) in registers; per staged input channel and kernel row it reads a
// 10-pixel window once and 8 weights per tap (the same address for the whole
// warp: a broadcast), then issues 8x8 FMAs per tap, so the shared-memory
// reads are ~1/12 of the FMAs.  Staging per 8-channel chunk takes 30 KB of
// static shared memory (inputs 21 KB, weights 9 KB), under the 48 KB limit.
// Tensor cores (TF32/bf16 wgmma), TMA and a fused bias/activation epilogue
// are left for a later version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv3x3_lowch.cuh"

namespace {

using namespace shgan::conv3;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 8 consecutive outputs to a 16- (bf16) or 32-byte (f32) aligned address.
__device__ __forceinline__ void store8(float* p, const float (&v)[kPix]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kPix]) {
  __nv_bfloat162 h[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_lowch_kernel(const T* __restrict__ x, const float* __restrict__ w,
                         T* __restrict__ y, int C, int O, int H, int W) {
  __shared__ float xs[kInElems];
  __shared__ __align__(16) float ws[kWElems];
  const int n = blockIdx.z;
  const int x0 = tile_x0(blockIdx.x);
  const int y0 = tile_y0(blockIdx.y);
  const int t = threadIdx.x;
  int og, ty, tx0;
  thread_role(t, &og, &ty, &tx0);
  const int64_t plane = static_cast<int64_t>(H) * W;
  const T* xn = x + static_cast<int64_t>(n) * C * plane;

  float acc[kOGroup][kPix];
#pragma unroll
  for (int o = 0; o < kOGroup; ++o)
#pragma unroll
    for (int p = 0; p < kPix; ++p) acc[o][p] = 0.0f;

  auto in = [](int i) { return xs[i]; };  // static storage: no capture
  auto wt = [](int i) { return ws[i]; };
  for (int c0 = 0; c0 < C; c0 += kCChunk) {
    for (int i = t; i < kInElems; i += kThreads) {
      int ci, sy, sx;
      halo_coords(i, y0, x0, &ci, &sy, &sx);
      const int c = c0 + ci;
      xs[i] = halo_inside(c, sy, sx, C, H, W)
                  ? to_float(__ldg(xn + c * plane + static_cast<int64_t>(sy) * W + sx))
                  : 0.0f;
    }
    for (int i = t; i < kWElems; i += kThreads) {
      int ci, dy, dx, o;
      weight_coords(i, &ci, &dy, &dx, &o);
      const int c = c0 + ci;
      ws[i] = (c < C && o < O) ? __ldg(w + weight_offset(o, c, dy, dx, C)) : 0.0f;
    }
    __syncthreads();
    accumulate_chunk(in, wt, og, ty, tx0, acc);
    __syncthreads();
  }

  const int oy = y0 + ty;
  const int ox = x0 + tx0;
  if (oy >= H || ox >= W) return;
  const bool whole = ox + kPix <= W && (W % kPix) == 0;
#pragma unroll
  for (int o = 0; o < kOGroup; ++o) {
    const int oc = og * kOGroup + o;
    if (oc >= O) break;
    T* dst = y + (static_cast<int64_t>(n) * O + oc) * plane + static_cast<int64_t>(oy) * W + ox;
    if (whole) {
      store8(dst, acc[o]);
    } else {
#pragma unroll
      for (int p = 0; p < kPix; ++p)
        if (ox + p < W) store(dst + p, acc[o][p]);
    }
  }
}

}  // namespace

// x: contiguous NCHW [n, c, h, w] (dtype 0 = float32, 1 = bfloat16);
// w: contiguous float32 OIHW [o, c, 3, 3]; y: contiguous [n, o, h, w] of x's
// dtype.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments outside the kernel's range.
extern "C" int shgan_conv3x3_lowch(const void* x, const float* w, void* y, int dtype, int n,
                                   int c, int o, int h, int wd, void* stream) {
  if (c < 1 || c > kMaxC || o < 1 || o > kMaxO || h < 1 || wd < 1 || n < 0 ||
      n > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((wd + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    conv3x3_lowch_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), w, static_cast<float*>(y), c, o, h, wd);
  } else {
    conv3x3_lowch_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), w, static_cast<__nv_bfloat16*>(y), c, o, h, wd);
  }
  return static_cast<int>(cudaGetLastError());
}
