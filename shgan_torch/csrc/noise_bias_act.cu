// The fused epilogue of every synthesis layer: per-layer noise, demodulation,
// bias and lrelu_agc in one pass over the conv output, in place.
//
// Replaces, on the main path, the TPU kernel shgan_tpu/ops/noise.py:68-110
// (_pallas_normal) together with the chain that consumed its output: the
// noise tensor [N, 1, R, R] existed only to be scaled, broadcast over C
// channels and added by the PyTorch ops after the conv (addcmul, + bias, the
// leaky ReLU's compare/multiply/select, gain, clamp: ~9 launches and ~58
// bytes of traffic per float32 element).  Here each thread draws its Philox
// normals in registers, with K1's key, counter and layout (shgan::noise_quad,
// bit for bit), and applies them to every channel it walks.  The noise never
// reaches device memory.  noise.cu stays as the noise-only entry point.
//
// Bound on the card: bytes.  x is read once and written once (8 bytes per
// float32 element, 4 in bf16); dcoef, bias and a const noise plane are small
// beside it.  Philox-10 plus precise logf/sqrtf/sincosf cost ~65 operations
// a normal, drawn once per pixel and chunk; at 512^2 with 64 channels that is
// ~1 operation per element, against the card's ~20 float32 operations per
// byte.  Design: 16-byte float32 (8-byte bf16) accesses in both halves of a
// plane, neighbouring threads on neighbouring addresses, channel chunks
// chosen so the grid fills the card at every resolution (noise_bias_act.cuh),
// one launch per layer.  All arithmetic in float32, one rounding at a bf16
// store.
#include <cuda_runtime.h>
#include <stdint.h>

#include "noise_bias_act.cuh"

namespace {

using shgan::nba::Act;
using shgan::nba::Launch;

template <int V>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// bfloat16 as its 16-bit pattern; element 0 is the low half of the word
template <int V>
__device__ __forceinline__ void load(const uint16_t* p, float* v) {
  using shgan::nba::from_bf16;
  if constexpr (V == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    v[0] = from_bf16(t.x & 0xFFFFu); v[1] = from_bf16(t.x >> 16);
    v[2] = from_bf16(t.y & 0xFFFFu); v[3] = from_bf16(t.y >> 16);
  } else {
    const uint32_t t = *reinterpret_cast<const uint32_t*>(p);
    v[0] = from_bf16(t & 0xFFFFu); v[1] = from_bf16(t >> 16);
  }
}

template <int V>
__device__ __forceinline__ void store(uint16_t* p, const float* v) {
  using shgan::nba::to_bf16;
  const uint32_t w0 = to_bf16(v[0]) | (static_cast<uint32_t>(to_bf16(v[1])) << 16);
  if constexpr (V == 4) {
    const uint32_t w1 = to_bf16(v[2]) | (static_cast<uint32_t>(to_bf16(v[3])) << 16);
    *reinterpret_cast<uint2*>(p) = make_uint2(w0, w1);
  } else {
    *reinterpret_cast<uint32_t*>(p) = w0;
  }
}

template <typename T, int CPT>
__global__ void __launch_bounds__(shgan::nba::kThreads)
    noise_bias_act_kernel(T* __restrict__ x, int c, long long plane, long long calls,
                          const float* __restrict__ dcoef, const float* __restrict__ bias,
                          const float* __restrict__ strength,
                          const float* __restrict__ noise_const, int mode, uint32_t k0,
                          uint32_t k1, Act act, Launch L) {
  constexpr int V = 2 * CPT;  // elements of each half a thread owns
  const long long q0 = shgan::nba::first_call(L, blockIdx.x, threadIdx.x, calls);
  if (q0 < 0) return;
  const int row = blockIdx.y;
  const long long half = plane / 2;

  float nz[2][V];  // noise * strength: [0] the cos half, [1] the sin half
  if (mode == shgan::nba::kNoiseNone) {
#pragma unroll
    for (int e = 0; e < V; ++e) nz[0][e] = nz[1][e] = -0.0f;
  } else {
    const float s = *strength;
    if (mode == shgan::nba::kNoiseRandom) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        shgan::noise_quad(static_cast<uint32_t>(q0 + j), static_cast<uint32_t>(row), k0, k1,
                          &nz[0][2 * j], &nz[1][2 * j]);
      }
    } else {
      load<V>(noise_const + 2 * q0, nz[0]);
      load<V>(noise_const + half + 2 * q0, nz[1]);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      nz[0][e] = shgan::nba::mul_rn(nz[0][e], s);
      nz[1][e] = shgan::nba::mul_rn(nz[1][e], s);
    }
  }

  for (int k = 0; k < L.per; ++k) {
    const int ch = shgan::nba::channel(L, blockIdx.z, threadIdx.y, k, c);
    if (ch < 0) break;
    const long long p = static_cast<long long>(row) * c + ch;
    const float d = dcoef != nullptr ? dcoef[p] : 1.0f;
    const float b = bias != nullptr ? bias[ch] : -0.0f;
    T* base = x + p * plane + 2 * q0;
    float v[2][V];
    load<V>(base, v[0]);
    load<V>(base + half, v[1]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < V; ++e) v[h][e] = shgan::nba::apply(v[h][e], d, nz[h][e], b, act);
    store<V>(base, v[0]);
    store<V>(base + half, v[1]);
  }
}

template <typename T, int CPT>
void launch(void* x, int n, int c, int res, const float* dcoef, const float* bias,
            const float* strength, const float* noise_const, int mode, uint32_t k0,
            uint32_t k1, Act act, cudaStream_t stream) {
  const Launch L = shgan::nba::plan(n, c, res, CPT, 0);
  const long long plane = static_cast<long long>(res) * res;
  const dim3 grid(static_cast<unsigned int>(L.tiles), static_cast<unsigned int>(n),
                  static_cast<unsigned int>(L.chunks));
  const dim3 block(L.bt, L.bc);
  noise_bias_act_kernel<T, CPT><<<grid, block, 0, stream>>>(
      static_cast<T*>(x), c, plane, plane / 4, dcoef, bias, strength, noise_const, mode, k0,
      k1, act, L);
}

}  // namespace

// x: contiguous [n, c, res, res] float32 (bf16 == 0) or bfloat16 (bf16 == 1)
// on the current device, updated in place; res even, x 2-element aligned (and
// noise_const 8-byte aligned).  dcoef float32 [n, c] or null (no
// demodulation); bias float32 [c] or null; mode 0 none, 1 random (Philox key
// k0, k1), 2 const (noise_const float32 [res, res]); strength: a float32 on
// the device, read for modes 1 and 2.  clamp +inf for none; alpha 1 for a
// linear activation.  Returns cudaGetLastError() after the launch.
extern "C" int shgan_noise_bias_act(void* x, int bf16, int n, int c, int res,
                                    const float* dcoef, const float* bias,
                                    const float* strength, const float* noise_const, int mode,
                                    unsigned int k0, unsigned int k1, float alpha, float gain,
                                    float clamp, void* stream) {
  if (n == 0 || c == 0) return static_cast<int>(cudaSuccess);
  const Act act{alpha, gain, clamp};
  const uintptr_t vec_bytes = bf16 ? 8 : 16;
  const bool vec = res % 4 == 0 && reinterpret_cast<uintptr_t>(x) % vec_bytes == 0 &&
                   reinterpret_cast<uintptr_t>(noise_const) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (vec) {
      launch<uint16_t, 2>(x, n, c, res, dcoef, bias, strength, noise_const, mode, k0, k1, act, s);
    } else {
      launch<uint16_t, 1>(x, n, c, res, dcoef, bias, strength, noise_const, mode, k0, k1, act, s);
    }
  } else if (vec) {
    launch<float, 2>(x, n, c, res, dcoef, bias, strength, noise_const, mode, k0, k1, act, s);
  } else {
    launch<float, 1>(x, n, c, res, dcoef, bias, strength, noise_const, mode, k0, k1, act, s);
  }
  return static_cast<int>(cudaGetLastError());
}
