// The fused epilogue of every synthesis layer: per-layer noise, demodulation,
// bias and lrelu_agc in one pass over the conv output, in place (serving,
// eval) or into a new tensor (training, which keeps x for the backward); and
// its gradient kernel (below).
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
  if constexpr (V == 8) {   // two 16-byte loads (the bf16 grad kernel's const plane)
    load<4>(p, v);
    load<4>(p + 4, v + 4);
  } else if constexpr (V == 4) {
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
  if constexpr (V == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = from_bf16(w[i] & 0xFFFFu);
      v[2 * i + 1] = from_bf16(w[i] >> 16);
    }
  } else if constexpr (V == 4) {
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
  if constexpr (V == 8) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = to_bf16(v[2 * i]) | (static_cast<uint32_t>(to_bf16(v[2 * i + 1])) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (V == 4) {
    const uint32_t w1 = to_bf16(v[2]) | (static_cast<uint32_t>(to_bf16(v[3])) << 16);
    *reinterpret_cast<uint2*>(p) = make_uint2(w0, w1);
  } else {
    *reinterpret_cast<uint32_t*>(p) = w0;
  }
}

// x and y may be the same tensor: each thread reads its elements before it
// writes them, so neither pointer is __restrict__.
template <typename T, int CPT>
__global__ void __launch_bounds__(shgan::nba::kThreads)
    noise_bias_act_kernel(const T* x, T* y, int c, long long plane, long long calls,
                          const float* __restrict__ dcoef, const float* __restrict__ bias,
                          const float* __restrict__ strength,
                          const float* __restrict__ noise_const, int mode, uint32_t k0,
                          uint32_t k1, long long row0, Act act, Launch L) {
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
        shgan::noise_quad(static_cast<uint32_t>(q0 + j), shgan::noise_row(row0, row), k0, k1,
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
    const long long off = p * plane + 2 * q0;
    float v[2][V];
    load<V>(x + off, v[0]);
    load<V>(x + off + half, v[1]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < V; ++e) v[h][e] = shgan::nba::apply(v[h][e], d, nz[h][e], b, act);
    store<V>(y + off, v[0]);
    store<V>(y + off + half, v[1]);
  }
}

template <typename T, int CPT>
void launch(const void* x, void* y, int n, int c, int res, const float* dcoef,
            const float* bias, const float* strength, const float* noise_const, int mode,
            uint32_t k0, uint32_t k1, long long row0, Act act, cudaStream_t stream) {
  const Launch L = shgan::nba::plan(n, c, res, CPT, 0);
  const long long plane = static_cast<long long>(res) * res;
  const dim3 grid(static_cast<unsigned int>(L.tiles), static_cast<unsigned int>(n),
                  static_cast<unsigned int>(L.chunks));
  const dim3 block(L.bt, L.bc);
  noise_bias_act_kernel<T, CPT><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), c, plane, plane / 4, dcoef, bias,
      strength, noise_const, mode, k0, k1, row0, act, L);
}

}  // namespace

// x: contiguous [n, c, res, res] float32 (bf16 == 0) or bfloat16 (bf16 == 1)
// on the current device; the result goes to y, of the same layout (y == x
// updates x in place); res even, x and y 2-element aligned (and noise_const
// 8-byte aligned).  dcoef float32 [n, c] or null (no
// demodulation); bias float32 [c] or null; mode 0 none, 1 random (Philox key
// k0, k1), 2 const (noise_const float32 [res, res]); strength: a float32 on
// the device, read for modes 1 and 2; row n of x draws the noise of counter
// row row0 + n.  clamp +inf for none; alpha 1 for a linear activation.
// Returns cudaGetLastError() after the launch.
extern "C" int shgan_noise_bias_act(const void* x, void* y, int bf16, int n, int c, int res,
                                    const float* dcoef, const float* bias,
                                    const float* strength, const float* noise_const, int mode,
                                    unsigned int k0, unsigned int k1, long long row0,
                                    float alpha, float gain, float clamp, void* stream) {
  if (n == 0 || c == 0) return static_cast<int>(cudaSuccess);
  const Act act{alpha, gain, clamp};
  const uintptr_t vec_bytes = bf16 ? 8 : 16;
  const bool vec = res % 4 == 0 && reinterpret_cast<uintptr_t>(x) % vec_bytes == 0 &&
                   reinterpret_cast<uintptr_t>(y) % vec_bytes == 0 &&
                   reinterpret_cast<uintptr_t>(noise_const) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (vec) {
      launch<uint16_t, 2>(x, y, n, c, res, dcoef, bias, strength, noise_const, mode, k0, k1, row0,
                          act, s);
    } else {
      launch<uint16_t, 1>(x, y, n, c, res, dcoef, bias, strength, noise_const, mode, k0, k1, row0,
                          act, s);
    }
  } else if (vec) {
    launch<float, 2>(x, y, n, c, res, dcoef, bias, strength, noise_const, mode, k0, k1, row0, act,
                     s);
  } else {
    launch<float, 1>(x, y, n, c, res, dcoef, bias, strength, noise_const, mode, k0, k1, row0, act,
                     s);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- the gradient --------------------------------------------------------
//
// noise_bias_act_grad: the backward of the epilogue, which kernel K1's TPU
// original never had (its noise carries no gradient, nor does it here).  Per
// element, with pre = x * dcoef + nu * strength + bias recomputed with the
// forward's roundings and nu regenerated in registers (shgan::noise_quad,
// bit for bit K1's), g = dy * act'(pre) (noise_bias_act.cuh: act_grad).  The
// full mode writes dx = g * dcoef and reduces dd[n, c] = sum_hw g * x,
// db[c] = sum_{n,hw} g and ds = sum g * nu; the mask-only mode (the double
// backward) writes act'(pre) * (v + vs * nu) and reduces nothing.
//
// float32 or bfloat16 I/O (the bf16 blocks of a training run): dy, x and
// the output in the block's type, everything else float32.  A bf16 element
// is widened to float32 on load, the arithmetic is the float32 kernel's to
// the bit, and dx is rounded once at the store (noise_bias_act.cuh:
// to_bf16); the three sums stay float32, in the same fixed order.
//
// Bound on the card: bytes.  dy and x are read once and dx written once (12
// bytes an element in float32, 6 in bf16; mask-only the same), the sums are
// small beside them, the normals ~65 operations a pixel as in the forward:
// drawn once for each group of up to 8 channels (noise_bias_act.cuh).
// Design: 16-byte accesses in both plane halves (a thread owns 2 Philox
// calls in float32, 4 in bf16); a block per chunk of a group of up to 8
// planes' Philox calls (enough blocks to fill the card at every
// resolution), its threads drawing each pixel's normals once and walking
// the group's planes, the normals in registers, the group's dcoefs and
// biases and each plane's sums in shared memory (drawn once per plane, the normals
// held both dtypes below the byte bound: on an H100 the bf16 kernel reached
// 31-47 % of the HBM rate, no faster than float32 per element); the sums
// reduced in a fixed order (noise_bias_act.cuh), never with float atomics.
namespace {

using shgan::nba::GradLaunch;

template <typename T, int CPT, bool MASK_ONLY>
__global__ void __launch_bounds__(shgan::nba::kThreads)
    noise_bias_act_grad_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                               T* __restrict__ out, int c, long long plane, long long calls,
                               const float* __restrict__ dcoef, const float* __restrict__ bias,
                               const float* __restrict__ strength,
                               const float* __restrict__ noise_const, int mode, uint32_t k0,
                               uint32_t k1, long long row0, Act act, const float* __restrict__ vs,
                               GradLaunch G, float* __restrict__ work) {
  constexpr int V = 2 * CPT;
  constexpr int K = shgan::nba::kGradGroup;
  constexpr int NT = shgan::nba::kThreads;
  // each thread's three sums for each channel of the group, in its own
  // column (no bank conflicts, no synchronisation until the trees)
  __shared__ float sums[K][3][NT];
  __shared__ float sd[K], sb[K];
  const int row = static_cast<int>(blockIdx.x / G.groups);
  const int ch0 = static_cast<int>(blockIdx.x % G.groups) * G.group;
  const int kn = c - ch0 < G.group ? c - ch0 : G.group;  // channels of this group
  const long long p0 = static_cast<long long>(row) * c + ch0;  // its first plane
  const int t = threadIdx.x;
  const long long half = plane / 2;
  const long long qa = static_cast<long long>(blockIdx.y) * G.calls_per_block;
  const long long qb = qa + G.calls_per_block < calls ? qa + G.calls_per_block : calls;
  const bool has_d = dcoef != nullptr;
  const float s = mode != shgan::nba::kNoiseNone ? *strength : 0.0f;
  const bool has_vs = vs != nullptr;
  const float vsv = has_vs ? *vs : 0.0f;
  if (t < kn) {
    sd[t] = has_d ? dcoef[p0 + t] : 1.0f;
    sb[t] = bias != nullptr ? bias[ch0 + t] : -0.0f;
  }
  if (!MASK_ONLY) {
    for (int k = 0; k < kn; ++k) sums[k][0][t] = sums[k][1][t] = sums[k][2][t] = 0.0f;
  }
  __syncthreads();
  for (long long q = qa + static_cast<long long>(t) * CPT; q < qb;
       q += static_cast<long long>(blockDim.x) * CPT) {
    float nu[2][V];
    if (mode == shgan::nba::kNoiseRandom) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        shgan::noise_quad(static_cast<uint32_t>(q + j), shgan::noise_row(row0, row), k0, k1,
                          &nu[0][2 * j], &nu[1][2 * j]);
      }
    } else if (mode == shgan::nba::kNoiseConst) {
      load<V>(noise_const + 2 * q, nu[0]);
      load<V>(noise_const + half + 2 * q, nu[1]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) nu[0][e] = nu[1][e] = 0.0f;
    }
#pragma unroll 1
    for (int k = 0; k < kn; ++k) {
      const long long off = (p0 + k) * plane + 2 * q;
      const float d = sd[k], b = sb[k];
      float gv[2][V], xv[2][V], acc[3];
      load<V>(dy + off, gv[0]);
      load<V>(dy + off + half, gv[1]);
      load<V>(x + off, xv[0]);
      load<V>(x + off + half, xv[1]);
      if (!MASK_ONLY) {
        acc[0] = sums[k][0][t];
        acc[1] = sums[k][1][t];
        acc[2] = sums[k][2][t];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float nz = mode != shgan::nba::kNoiseNone ? shgan::nba::mul_rn(nu[h][e], s)
                                                          : -0.0f;
          gv[h][e] = MASK_ONLY ? shgan::nba::mask_element(gv[h][e], vsv, has_vs, xv[h][e], d,
                                                          nu[h][e], nz, b, act)
                               : shgan::nba::grad_element(gv[h][e], xv[h][e], d, has_d,
                                                          nu[h][e], nz, b, act, acc);
        }
      if (!MASK_ONLY) {
        sums[k][0][t] = acc[0];
        sums[k][1][t] = acc[1];
        sums[k][2][t] = acc[2];
      }
      store<V>(out + off, gv[0]);
      store<V>(out + off + half, gv[1]);
    }
  }
  if (MASK_ONLY) return;
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h /= 2) {
    for (int k = 0; k < kn; ++k)
#pragma unroll
      for (int j = 0; j < 3; ++j) shgan::nba::tree_add(sums[k][j], t, h);
    __syncthreads();
  }
  if (t < kn) {
    const long long planes = static_cast<long long>(gridDim.x / G.groups) * c;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      work[(j * planes + p0 + t) * G.chunks + blockIdx.y] = sums[t][j][0];
  }
}

// Each plane's partials over its chunks, in chunk order: dd[p] final, the
// plane's db and ds sums into pw[p] and pw[planes + p].
__global__ void grad_finish_planes(const float* __restrict__ work, long long planes, int chunks,
                                   float* __restrict__ dd, float* __restrict__ pw) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= planes) return;
  float acc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    acc[k] = 0.0f;
    for (int j = 0; j < chunks; ++j)
      acc[k] = shgan::nba::add_rn(acc[k], work[(k * planes + p) * chunks + j]);
  }
  dd[p] = acc[0];
  pw[p] = acc[1];
  pw[planes + p] = acc[2];
}

// db[ch] over the batch rows in order (blocks before the last); ds over the
// planes (the last block: strided sums, then the fixed tree).
__global__ void grad_finish_sums(const float* __restrict__ pw, int n, int c,
                                 float* __restrict__ db, float* __restrict__ ds) {
  const int t = threadIdx.x;
  const long long planes = static_cast<long long>(n) * c;
  if (blockIdx.x + 1 < gridDim.x) {
    const int ch = blockIdx.x * blockDim.x + t;
    if (ch >= c) return;
    float acc = 0.0f;
    for (int r = 0; r < n; ++r) acc = shgan::nba::add_rn(acc, pw[static_cast<long long>(r) * c + ch]);
    db[ch] = acc;
    return;
  }
  __shared__ float sums[shgan::nba::kThreads];
  float acc = 0.0f;
  for (long long p = t; p < planes; p += blockDim.x) acc = shgan::nba::add_rn(acc, pw[planes + p]);
  sums[t] = acc;
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h /= 2) {
    shgan::nba::tree_add(sums, t, h);
    __syncthreads();
  }
  if (t == 0) ds[0] = sums[0];
}

template <typename T, int CPT>
void launch_grad(const void* dy, const void* x, void* out, int n, int c, int res,
                 const float* dcoef, const float* bias, const float* strength,
                 const float* noise_const, int mode, uint32_t k0, uint32_t k1, long long row0,
                 Act act, bool mask_only, const float* vs, float* work, cudaStream_t stream) {
  const GradLaunch G = shgan::nba::grad_plan(n, c, res, CPT);
  const long long plane = static_cast<long long>(res) * res;
  const dim3 grid(static_cast<unsigned int>(static_cast<long long>(n) * G.groups),
                  static_cast<unsigned int>(G.chunks));
  const T* dyp = static_cast<const T*>(dy);
  const T* xp = static_cast<const T*>(x);
  T* outp = static_cast<T*>(out);
  if (mask_only) {
    noise_bias_act_grad_kernel<T, CPT, true><<<grid, G.threads, 0, stream>>>(
        dyp, xp, outp, c, plane, plane / 4, dcoef, bias, strength, noise_const, mode, k0, k1,
        row0, act, vs, G, work);
  } else {
    noise_bias_act_grad_kernel<T, CPT, false><<<grid, G.threads, 0, stream>>>(
        dyp, xp, outp, c, plane, plane / 4, dcoef, bias, strength, noise_const, mode, k0, k1,
        row0, act, vs, G, work);
  }
}

}  // namespace

// The epilogue's gradient at the conv output x [n, c, res, res] (the
// forward's input), float32 (bf16 == 0) or bfloat16 (bf16 == 1), for the
// forward's dcoef, bias, strength, noise_const, mode, key, row0 and
// activation (as in shgan_noise_bias_act).  Full mode (mask_only == 0): dy is the cotangent
// of y; writes out = dx, dd [n, c], db [c] and ds [1] (every pointer set; vs
// unused).  Mask-only mode: dy is v; writes out = act'(pre) * (v + vs * nu)
// (vs a float32 on the device, or null for none), nothing else.  dy, x and
// out of x's type; dd, db, ds and work float32, work of grad_work_floats(n,
// c, res) elements (full mode).  dy, x, out contiguous, res even, 8-byte
// aligned (float32) or 4-byte aligned (bf16); 16-byte aligned pointers and res
// % 4 == 0 take the vectorized path.  Returns cudaGetLastError()
// after the launches.
extern "C" int shgan_noise_bias_act_grad(const void* dy, const void* x, void* out, int bf16,
                                         int n, int c, int res, const float* dcoef,
                                         const float* bias, const float* strength,
                                         const float* noise_const, int mode, unsigned int k0,
                                         unsigned int k1, long long row0, float alpha, float gain,
                                         float clamp,
                                         int mask_only, const float* vs, float* dd, float* db,
                                         float* ds, float* work, void* stream) {
  if (n == 0 || c == 0) return static_cast<int>(cudaSuccess);
  const Act act{alpha, gain, clamp};
  const bool vec = res % 4 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(noise_const) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mo = mask_only != 0;
  if (bf16) {
    if (vec) {
      launch_grad<uint16_t, 4>(dy, x, out, n, c, res, dcoef, bias, strength, noise_const, mode,
                               k0, k1, row0, act, mo, vs, work, s);
    } else {
      launch_grad<uint16_t, 1>(dy, x, out, n, c, res, dcoef, bias, strength, noise_const, mode,
                               k0, k1, row0, act, mo, vs, work, s);
    }
  } else if (vec) {
    launch_grad<float, 2>(dy, x, out, n, c, res, dcoef, bias, strength, noise_const, mode, k0,
                          k1, row0, act, mo, vs, work, s);
  } else {
    launch_grad<float, 1>(dy, x, out, n, c, res, dcoef, bias, strength, noise_const, mode, k0,
                          k1, row0, act, mo, vs, work, s);
  }
  if (!mo) {
    const long long planes = static_cast<long long>(n) * c;
    const int chunks = shgan::nba::grad_chunks(n, c, res);
    float* pw = work + 3 * planes * chunks;
    const int threads = shgan::nba::kThreads;
    grad_finish_planes<<<static_cast<unsigned int>(shgan::nba::cdiv(planes, threads)), threads,
                         0, s>>>(work, planes, chunks, dd, pw);
    grad_finish_sums<<<static_cast<unsigned int>(shgan::nba::cdiv(c, threads) + 1), threads, 0,
                       s>>>(pw, n, c, db, ds);
  }
  return static_cast<int>(cudaGetLastError());
}
