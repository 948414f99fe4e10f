// Per-layer N(0,1) noise for the synthesis layers: Philox4x32-10 + Box-Muller.
//
// Replaces the TPU kernel shgan_tpu/ops/noise.py:68-110 (_pallas_normal),
// which seeded the TPU's hardware PRNG per batch row.  Here every output
// element is a pure function of (key, row, element index): counter
// (call, row0 + row, 0, 0), so the result does not depend on the launch
// shape, and a launch over rows row0... of a batch draws what those rows of
// the whole batch draw.  It does not reproduce the TPU's bits (no Philox
// can).
//
// Bound on the card: bytes.  The kernel reads nothing and writes 4 bytes per
// normal; about 25 integer and 12 float operations per normal sit far below
// the card's ratio of operations to bytes.  Design: one thread per Philox
// call (4 normals), each writing two float2 stores, so a warp writes 256
// contiguous bytes to each half of the plane.
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

__global__ void philox_normal_kernel(float* __restrict__ out, int64_t calls_per_row,
                                     int64_t total_calls, int64_t plane, int64_t row0,
                                     uint32_t k0, uint32_t k1) {
  const int64_t half = plane / 2;
  for (int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       t < total_calls; t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = t / calls_per_row;
    const int64_t call = t - row * calls_per_row;
    float c[2], s[2];
    shgan::noise_quad(static_cast<uint32_t>(call), shgan::noise_row(row0, row), k0, k1, c, s);
    float* base = out + row * plane + 2 * call;
    *reinterpret_cast<float2*>(base) = make_float2(c[0], c[1]);
    *reinterpret_cast<float2*>(base + half) = make_float2(s[0], s[1]);
  }
}

}  // namespace

// out: contiguous float32 [batch, res, res] on the current device; res is even
// and res*res/4 is a whole number of Philox calls per row (res >= 2, even).
// Row n draws the counter row row0 + n.  Returns cudaGetLastError() after the
// launch.
extern "C" int shgan_philox_normal(float* out, int batch, int res, long long row0,
                                   unsigned int k0, unsigned int k1, void* stream) {
  const int64_t plane = static_cast<int64_t>(res) * res;
  const int64_t calls_per_row = plane / 4;
  const int64_t total = calls_per_row * batch;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  philox_normal_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(out, calls_per_row, total,
                                                              plane, row0, k0, k1);
  return static_cast<int>(cudaGetLastError());
}
