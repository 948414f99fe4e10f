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
//
// The fold (noise_bias_act_fold_kernel, its NHWC map): on a forward that
// records no gradient the launch also adds the encoder skip and writes each
// consumer's x * styles (noise_bias_act.cuh: the fold), so the PyTorch
// kernels that did it, each a full pass over a plane read straight back,
// drop out: ~8 GB a 512^2 batch of 8 for ~1.5 GB more here.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// The fold's operands (noise_bias_act.cuh: the fold): the addend (ADD) and
// the scales of the outputs (OUTS of them: output 1 into y, output 2 into
// y2), each scale float32 [n, c] as the dcoefs are.  The plain epilogue has
// none (Fold<T>{}).
template <typename T>
struct Fold {
  const T* addend = nullptr;
  T* y2 = nullptr;
  const float* scale1 = nullptr;
  const float* scale2 = nullptr;
};

template <typename T>
constexpr bool kBf16 = sizeof(T) == 2;

// Element e of an access: the epilogue's result r becomes the fold's
// outputs o1 and o2 (r itself where OUTS is 0: the plain epilogue).
template <typename T, bool ADD, int OUTS>
__device__ __forceinline__ void fold(float r, float a, float s1, float s2, float* o1, float* o2) {
  static_assert(!ADD || OUTS == 1, "an addend takes one output");
  if constexpr (OUTS == 0) {
    *o1 = r;
  } else {
    const float v = shgan::nba::fold_sum(r, a, ADD, kBf16<T>);
    *o1 = shgan::nba::mul_rn(v, s1);
    if constexpr (OUTS == 2) *o2 = shgan::nba::mul_rn(v, s2);
  }
}

// One thread's work of the epilogue: its 2 * CPT elements in each half of
// each plane it walks.  x and y may be the same tensor: each thread reads its
// elements before it writes them, so neither pointer is __restrict__.
template <typename T, int CPT, bool ADD = false, int OUTS = 0>
__device__ __forceinline__ void epilogue(const T* x, T* y, int c, const shgan::NoiseWindow& win,
                                         long long calls, const float* __restrict__ dcoef,
                                         const float* __restrict__ bias,
                                         const float* __restrict__ strength,
                                         const float* __restrict__ noise_const,
                                         const long long* __restrict__ key_row, int mode,
                                         uint32_t k0, uint32_t k1, long long row0, Act act,
                                         const Launch& L, Fold<T> f = {}) {
  constexpr int V = 2 * CPT;  // elements of each half a thread owns
  const long long rel = shgan::nba::first_call(L, blockIdx.x, threadIdx.x, calls);
  if (rel < 0) return;
  const long long q0 = win.q0 + rel;
  const int row = blockIdx.y;
  // the window offsets of this thread's cos and sin runs (-1: not in it)
  const long long o[2] = {shgan::noise_offset(win, 0, 2 * q0),
                          shgan::noise_offset(win, 1, 2 * q0)};

  float nz[2][V];  // noise * strength: [0] the cos half, [1] the sin half
  if (mode == shgan::nba::kNoiseNone) {
#pragma unroll
    for (int e = 0; e < V; ++e) nz[0][e] = nz[1][e] = -0.0f;
  } else {
    const float s = *strength;
    if (mode == shgan::nba::kNoiseRandom) {
      const shgan::nba::NoiseKey key = shgan::nba::pick_key(key_row, k0, k1, row0);
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        shgan::noise_quad(static_cast<uint32_t>(q0 + j), shgan::noise_row(key.row0, row), key.k0,
                          key.k1, &nz[0][2 * j], &nz[1][2 * j]);
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (o[h] >= 0) load<V>(noise_const + o[h], nz[h]);
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
    float s1 = 0.0f, s2 = 0.0f;
    if constexpr (OUTS >= 1) s1 = shgan::nba::held(f.scale1[p], kBf16<T>);
    if constexpr (OUTS == 2) s2 = shgan::nba::held(f.scale2[p], kBf16<T>);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (o[h] < 0) continue;
      const long long off = p * win.len + o[h];
      float v[V], a[V], v2[V];
      load<V>(x + off, v);
      if constexpr (ADD) load<V>(f.addend + off, a);
#pragma unroll
      for (int e = 0; e < V; ++e)
        fold<T, ADD, OUTS>(shgan::nba::apply(v[e], d, nz[h][e], b, act), ADD ? a[e] : 0.0f, s1,
                           s2, &v[e], &v2[e]);
      store<V>(y + off, v);
      if constexpr (OUTS == 2) store<V>(f.y2 + off, v2);
    }
  }
}

template <typename T, int CPT>
__global__ void __launch_bounds__(shgan::nba::kThreads)
    noise_bias_act_kernel(const T* x, T* y, int c, shgan::NoiseWindow win, long long calls,
                          const float* __restrict__ dcoef, const float* __restrict__ bias,
                          const float* __restrict__ strength,
                          const float* __restrict__ noise_const,
                          const long long* __restrict__ key_row, int mode, uint32_t k0,
                          uint32_t k1, long long row0, Act act, Launch L) {
  epilogue<T, CPT>(x, y, c, win, calls, dcoef, bias, strength, noise_const, key_row, mode, k0, k1,
                   row0, act, L);
}

// The epilogue with the fold (ADD, OUTS; not both off): a launch that
// writes its consumers' inputs.  The plain epilogue keeps its own kernel.
template <typename T, int CPT, bool ADD, int OUTS>
__global__ void __launch_bounds__(shgan::nba::kThreads)
    noise_bias_act_fold_kernel(const T* x, T* y, int c, shgan::NoiseWindow win, long long calls,
                               const float* __restrict__ dcoef, const float* __restrict__ bias,
                               const float* __restrict__ strength,
                               const float* __restrict__ noise_const,
                               const long long* __restrict__ key_row, int mode, uint32_t k0,
                               uint32_t k1, long long row0, Act act, Launch L, Fold<T> f) {
  epilogue<T, CPT, ADD, OUTS>(x, y, c, win, calls, dcoef, bias, strength, noise_const, key_row,
                              mode, k0, k1, row0, act, L, f);
}

// bias_lrelu_kernel: the conv layers' epilogue.  Every Conv2dLayer of the
// encoder and of D ends in its bias and activation (lrelu_agc with clamp, or
// linear with a gain) and nothing else.  As PyTorch ops that chain was six
// launches (the add, then compare, multiply, select, gain and clamp) and ~50
// bytes of traffic per float32 element.  It replaces no TPU kernel: XLA
// fused the chain in the JAX package.
//
// It is the epilogue above with no dcoef and no noise, fixed at compile time
// (the Philox draw and the dcoef load drop out), under a name of its own so
// that the profiler's trace tells the conv layers' time from the synthesis
// layers'.  Bound on the card: bytes, 8 per float32 element (4 in bf16);
// ~6 operations an element against the card's ~20 float32 operations per
// byte.  The launch is the epilogue's, with one channel a thread (no noise
// to reuse across channels, so the most blocks and the most loads in
// flight).  apply() with dcoef 1 and a noise term of -0 is x + bias and then
// the chain's activation steps, each rounded as PyTorch rounds it: float32
// results equal the chain's bit for bit.
template <typename T, int CPT>
__global__ void __launch_bounds__(shgan::nba::kThreads)
    bias_lrelu_kernel(const T* x, T* y, int c, shgan::NoiseWindow win, long long calls,
                      const float* __restrict__ bias, Act act, Launch L) {
  epilogue<T, CPT>(x, y, c, win, calls, nullptr, bias, nullptr, nullptr, nullptr,
                   shgan::nba::kNoiseNone, 0, 0, 0, act, L);
}

// ---- the channels-last (NHWC) map ------------------------------------------
//
// The same epilogue on x [N, R, R, C] in memory (noise_bias_act.cuh: the
// NHWC map).  The channel is the fastest axis, so a thread cannot keep its
// pixels' normals for many channels in registers as the NCHW map does: a
// block draws each of its Philox calls once into shared memory (noise *
// strength, one value a pixel), then its threads walk the block's two runs
// of pixels, V channels an access, and every element takes its pixel's
// value.  The draws, the dcoef and bias of each element and apply() are the
// NCHW map's, so both maps give the same bits.  Bound on the card: bytes, as
// the NCHW map; the draw is ~65 operations a pixel, shared by its C
// channels.
using shgan::nba::NhwcLaunch;

// V = 4: the 16-byte (float32) or 8-byte (bf16) accesses above; V = 1: one
// element.
template <int V>
__device__ __forceinline__ void load_n(const float* p, float* v) {
  if constexpr (V == 1) {
    v[0] = *p;
  } else {
    load<V>(p, v);
  }
}
template <int V>
__device__ __forceinline__ void load_n(const uint16_t* p, float* v) {
  if constexpr (V == 1) {
    v[0] = shgan::nba::from_bf16(*p);
  } else {
    load<V>(p, v);
  }
}
template <int V>
__device__ __forceinline__ void store_n(float* p, const float* v) {
  if constexpr (V == 1) {
    *p = v[0];
  } else {
    store<V>(p, v);
  }
}
template <int V>
__device__ __forceinline__ void store_n(uint16_t* p, const float* v) {
  if constexpr (V == 1) {
    *p = shgan::nba::to_bf16(v[0]);
  } else {
    store<V>(p, v);
  }
}

template <typename T, int V, bool NOISE, bool ADD = false, int OUTS = 0>
__device__ __forceinline__ void epilogue_nhwc(const T* x, T* y, int c, long long half,
                                              long long calls, const float* __restrict__ dcoef,
                                              const float* __restrict__ bias,
                                              const float* __restrict__ strength,
                                              const float* __restrict__ noise_const,
                                              const long long* __restrict__ key_row, int mode,
                                              uint32_t k0, uint32_t k1, long long row0, Act act,
                                              const NhwcLaunch& L, Fold<T> f = {}) {
  __shared__ float nz[2][NOISE ? 2 * shgan::nba::kNhwcMaxCalls : 1];
  const int row = blockIdx.y;
  const long long qa = static_cast<long long>(blockIdx.x) * L.cpb;
  const long long nq = shgan::nba::nhwc_calls(L, blockIdx.x, calls);
  if constexpr (NOISE) {
    const float s = *strength;
    if (mode == shgan::nba::kNoiseRandom) {
      const shgan::nba::NoiseKey key = shgan::nba::pick_key(key_row, k0, k1, row0);
      for (long long j = threadIdx.x; j < nq; j += blockDim.x) {
        float cs[2], sn[2];
        shgan::noise_quad(static_cast<uint32_t>(qa + j), shgan::noise_row(key.row0, row), key.k0,
                          key.k1, cs, sn);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          nz[0][2 * j + e] = shgan::nba::mul_rn(cs[e], s);
          nz[1][2 * j + e] = shgan::nba::mul_rn(sn[e], s);
        }
      }
    } else {
      for (long long j = threadIdx.x; j < 2 * nq; j += blockDim.x) {
        nz[0][j] = shgan::nba::mul_rn(noise_const[2 * qa + j], s);
        nz[1][j] = shgan::nba::mul_rn(noise_const[half + 2 * qa + j], s);
      }
    }
    __syncthreads();
  }
  const long long img = static_cast<long long>(row) * 2 * half;  // the row's first pixel
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long base = (img + shgan::nba::nhwc_pixel(L, blockIdx.x, h, half, 0)) * c;
    shgan::nba::nhwc_walk(L, nq, c, threadIdx.x, blockDim.x, [&](long long e, long long pl,
                                                                  int ch) {
      float d[V], b[V], v[V];
      if (dcoef != nullptr) {
        load_n<V>(dcoef + static_cast<long long>(row) * c + ch, d);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) d[k] = 1.0f;
      }
      if (bias != nullptr) {
        load_n<V>(bias + ch, b);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) b[k] = -0.0f;
      }
      float s1[V], s2[V], a[V], v2[V];
      if constexpr (OUTS >= 1) load_n<V>(f.scale1 + static_cast<long long>(row) * c + ch, s1);
      if constexpr (OUTS == 2) load_n<V>(f.scale2 + static_cast<long long>(row) * c + ch, s2);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if constexpr (OUTS >= 1) s1[k] = shgan::nba::held(s1[k], kBf16<T>);
        if constexpr (OUTS == 2) s2[k] = shgan::nba::held(s2[k], kBf16<T>);
      }
      float n = -0.0f;
      if constexpr (NOISE) n = nz[h][pl];
      load_n<V>(x + base + e, v);
      if constexpr (ADD) load_n<V>(f.addend + base + e, a);
#pragma unroll
      for (int k = 0; k < V; ++k)
        fold<T, ADD, OUTS>(shgan::nba::apply(v[k], d[k], n, b[k], act), ADD ? a[k] : 0.0f,
                           OUTS >= 1 ? s1[k] : 0.0f, OUTS == 2 ? s2[k] : 0.0f, &v[k], &v2[k]);
      store_n<V>(y + base + e, v);
      if constexpr (OUTS == 2) store_n<V>(f.y2 + base + e, v2);
    });
  }
}

template <typename T, int V, bool NOISE>
__global__ void __launch_bounds__(shgan::nba::kThreads)
    noise_bias_act_nhwc_kernel(const T* x, T* y, int c, long long half, long long calls,
                               const float* __restrict__ dcoef, const float* __restrict__ bias,
                               const float* __restrict__ strength,
                               const float* __restrict__ noise_const,
                               const long long* __restrict__ key_row, int mode, uint32_t k0,
                               uint32_t k1, long long row0, Act act, NhwcLaunch L) {
  epilogue_nhwc<T, V, NOISE>(x, y, c, half, calls, dcoef, bias, strength, noise_const, key_row,
                             mode, k0, k1, row0, act, L);
}

// The NHWC map with the fold, as noise_bias_act_fold_kernel on the NCHW map.
template <typename T, int V, bool NOISE, bool ADD, int OUTS>
__global__ void __launch_bounds__(shgan::nba::kThreads)
    noise_bias_act_fold_nhwc_kernel(const T* x, T* y, int c, long long half, long long calls,
                                    const float* __restrict__ dcoef,
                                    const float* __restrict__ bias,
                                    const float* __restrict__ strength,
                                    const float* __restrict__ noise_const,
                                    const long long* __restrict__ key_row, int mode, uint32_t k0,
                                    uint32_t k1, long long row0, Act act, NhwcLaunch L,
                                    Fold<T> f) {
  epilogue_nhwc<T, V, NOISE, ADD, OUTS>(x, y, c, half, calls, dcoef, bias, strength, noise_const,
                                        key_row, mode, k0, k1, row0, act, L, f);
}

// bias_lrelu_kernel's NHWC map: the epilogue above with no dcoef and no
// noise, under its own name for the profiler, as on the NCHW map.
template <typename T, int V>
__global__ void __launch_bounds__(shgan::nba::kThreads)
    bias_lrelu_nhwc_kernel(const T* x, T* y, int c, long long half, long long calls,
                           const float* __restrict__ bias, Act act, NhwcLaunch L) {
  epilogue_nhwc<T, V, false>(x, y, c, half, calls, nullptr, bias, nullptr, nullptr, nullptr,
                             shgan::nba::kNoiseNone, 0, 0, 0, act, L);
}

// k(ADD, OUTS) with the fold's options as std::integral_constant values, for
// the runtime (add, outs) of a fold launch.  The synthesis runs three: a
// conv0 adds the skip and writes conv1's input (add, 1); a conv1 writes
// torgb's input and the next conv0's (2), or one of them (1).  The entry
// point refuses the others.
template <typename F>
void with_fold(bool add, int outs, F&& k) {
  using std::integral_constant;
  if (add) {
    k(std::true_type{}, integral_constant<int, 1>{});
  } else if (outs == 1) {
    k(std::false_type{}, integral_constant<int, 1>{});
  } else {
    k(std::false_type{}, integral_constant<int, 2>{});
  }
}

template <typename T, int V>
void launch_nhwc(const void* x, void* y, int n, int c, int res, const float* dcoef,
                 const float* bias, const float* strength, const float* noise_const,
                 const long long* key_row, int mode, uint32_t k0, uint32_t k1, long long row0,
                 Act act, const Fold<T>& f, bool add, int outs, cudaStream_t stream) {
  const NhwcLaunch L = shgan::nba::plan_nhwc(n, c, res, V);
  const long long half = static_cast<long long>(res) * res / 2, calls = half / 2;
  const dim3 grid(static_cast<unsigned int>(L.tiles), static_cast<unsigned int>(n));
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (add || outs) {
    with_fold(add, outs, [&](auto a, auto o) {
      constexpr bool A = decltype(a)::value;
      constexpr int O = decltype(o)::value;
      if (mode == shgan::nba::kNoiseNone) {
        noise_bias_act_fold_nhwc_kernel<T, V, false, A, O><<<grid, shgan::nba::kThreads, 0, stream>>>(
            xp, yp, c, half, calls, dcoef, bias, strength, noise_const, key_row, mode, k0, k1,
            row0, act, L, f);
      } else {
        noise_bias_act_fold_nhwc_kernel<T, V, true, A, O><<<grid, shgan::nba::kThreads, 0, stream>>>(
            xp, yp, c, half, calls, dcoef, bias, strength, noise_const, key_row, mode, k0, k1,
            row0, act, L, f);
      }
    });
    return;
  }
  if (dcoef == nullptr && mode == shgan::nba::kNoiseNone) {
    bias_lrelu_nhwc_kernel<T, V><<<grid, shgan::nba::kThreads, 0, stream>>>(xp, yp, c, half,
                                                                            calls, bias, act, L);
  } else if (mode == shgan::nba::kNoiseNone) {
    noise_bias_act_nhwc_kernel<T, V, false><<<grid, shgan::nba::kThreads, 0, stream>>>(
        xp, yp, c, half, calls, dcoef, bias, strength, noise_const, key_row, mode, k0, k1, row0,
        act, L);
  } else {
    noise_bias_act_nhwc_kernel<T, V, true><<<grid, shgan::nba::kThreads, 0, stream>>>(
        xp, yp, c, half, calls, dcoef, bias, strength, noise_const, key_row, mode, k0, k1, row0,
        act, L);
  }
}

template <typename T, int CPT>
void launch(const void* x, void* y, int n, int c, const shgan::NoiseWindow& win,
            const float* dcoef, const float* bias, const float* strength,
            const float* noise_const, const long long* key_row, int mode, uint32_t k0, uint32_t k1,
            long long row0, Act act, const Fold<T>& f, bool add, int outs, cudaStream_t stream) {
  const long long calls = win.q1 - win.q0;
  const bool conv = dcoef == nullptr && mode == shgan::nba::kNoiseNone && !add && !outs;
  const Launch L = shgan::nba::plan_calls(n, c, calls, CPT, conv ? 1 : 0);
  const dim3 grid(static_cast<unsigned int>(L.tiles), static_cast<unsigned int>(n),
                  static_cast<unsigned int>(L.chunks));
  const dim3 block(L.bt, L.bc);
  if (add || outs) {
    with_fold(add, outs, [&](auto a, auto o) {
      noise_bias_act_fold_kernel<T, CPT, decltype(a)::value, decltype(o)::value>
          <<<grid, block, 0, stream>>>(static_cast<const T*>(x), static_cast<T*>(y), c, win,
                                       calls, dcoef, bias, strength, noise_const, key_row, mode,
                                       k0, k1, row0, act, L, f);
    });
    return;
  }
  if (conv) {
    bias_lrelu_kernel<T, CPT><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), c, win, calls, bias, act, L);
    return;
  }
  noise_bias_act_kernel<T, CPT><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), c, win, calls, dcoef, bias, strength,
      noise_const, key_row, mode, k0, k1, row0, act, L);
}

}  // namespace

// x: contiguous [n, c, rows, res] float32 (bf16 == 0) or bfloat16 (bf16 ==
// 1) on the current device: rows [h0, h0 + rows) of each res x res plane
// (h0 = 0, rows = res: the whole plane); the result goes to y, of the same
// layout (y == x updates x in place); res even, x and y 2-element aligned
// (and noise_const 8-byte aligned).  dcoef float32 [n, c] or null (no
// demodulation); bias float32 [c] or null; mode 0 none, 1 random (Philox key
// k0, k1), 2 const (noise_const float32 [rows, res], the same rows of the
// layer's plane); strength: a float32 on the device, read for modes 1 and 2;
// row n of x draws the noise of counter row row0 + n.  key_row: null, or an
// 8-byte aligned int64 [3] on the device holding (k0, k1, row0), which mode 1
// then reads in place of the three scalars (noise_bias_act.cuh: pick_key;
// the key of a captured graph's launch, written before each replay).
// clamp +inf for none;
// alpha 1 for a linear activation.  With no dcoef and mode 0 (a conv layer's
// bias and activation alone) the launch is bias_lrelu_kernel.  nhwc = 1: x
// and y are channels-last, [n, res, res, c] in memory, whole planes (h0 = 0,
// rows = res); the NHWC map (noise_bias_act_nhwc_kernel, bias_lrelu_nhwc_kernel)
// takes 16-byte float32 / 8-byte bf16 accesses where c % 4 == 0 and x, y,
// bias and dcoef allow, else one element an access.
//
// The fold (noise_bias_act.cuh; noise_bias_act_fold_kernel and its NHWC
// map): addend, null or a tensor of x's type, shape and layout, added to the
// result (rounded as the block's type rounds); outs, 0-2 outputs (1 with an
// addend), output k the result (with the addend) times scale_k, a float32
// [n, c], output 1 into y and output 2 into y2 (x's type, shape and layout).
// With no addend and outs 0 the launch is the plain epilogue's, as above.
// Returns
// cudaGetLastError() after the launch.
extern "C" int shgan_noise_bias_act(const void* x, void* y, int bf16, int n, int c, int res,
                                    int rows, int h0, const float* dcoef, const float* bias,
                                    const float* strength, const float* noise_const,
                                    const long long* key_row, int mode, unsigned int k0,
                                    unsigned int k1, long long row0, float alpha, float gain,
                                    float clamp, int nhwc, const void* addend, void* y2,
                                    const float* scale1, const float* scale2, int outs,
                                    void* stream) {
  if (res < 2 || res % 2 || h0 < 0 || rows < 0 || h0 + rows > res ||
      (nhwc && (h0 != 0 || rows != res)) || outs < 0 || outs > 2 || (addend && outs != 1) ||
      (outs >= 1 && scale1 == nullptr) || (outs == 2 && (scale2 == nullptr || y2 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || c == 0 || rows == 0) return static_cast<int>(cudaSuccess);
  const Act act{alpha, gain, clamp};
  const bool add = addend != nullptr;
  const Fold<float> f32{static_cast<const float*>(addend), static_cast<float*>(y2), scale1,
                        scale2};
  const Fold<uint16_t> f16{static_cast<const uint16_t*>(addend), static_cast<uint16_t*>(y2),
                           scale1, scale2};
  const auto at = [](const void* p, uintptr_t b) { return reinterpret_cast<uintptr_t>(p) % b == 0; };
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nhwc) {
    const uintptr_t xb = bf16 ? 8 : 16;
    const bool v4 = c % 4 == 0 && at(x, xb) && at(y, xb) && at(bias, 16) && at(dcoef, 16) &&
                    at(addend, xb) && at(y2, xb) && at(scale1, 16) && at(scale2, 16);
    if (bf16) {
      if (v4) {
        launch_nhwc<uint16_t, 4>(x, y, n, c, res, dcoef, bias, strength, noise_const, key_row,
                                 mode, k0, k1, row0, act, f16, add, outs, s);
      } else {
        launch_nhwc<uint16_t, 1>(x, y, n, c, res, dcoef, bias, strength, noise_const, key_row,
                                 mode, k0, k1, row0, act, f16, add, outs, s);
      }
    } else if (v4) {
      launch_nhwc<float, 4>(x, y, n, c, res, dcoef, bias, strength, noise_const, key_row, mode,
                            k0, k1, row0, act, f32, add, outs, s);
    } else {
      launch_nhwc<float, 1>(x, y, n, c, res, dcoef, bias, strength, noise_const, key_row, mode,
                            k0, k1, row0, act, f32, add, outs, s);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const shgan::NoiseWindow win = shgan::noise_window(res, h0, rows);
  const uintptr_t vec_bytes = bf16 ? 8 : 16;
  const bool vec = res % 4 == 0 && at(x, vec_bytes) && at(y, vec_bytes) && at(noise_const, 16) &&
                   at(addend, vec_bytes) && at(y2, vec_bytes);
  if (bf16) {
    if (vec) {
      launch<uint16_t, 2>(x, y, n, c, win, dcoef, bias, strength, noise_const, key_row, mode, k0,
                          k1, row0, act, f16, add, outs, s);
    } else {
      launch<uint16_t, 1>(x, y, n, c, win, dcoef, bias, strength, noise_const, key_row, mode, k0,
                          k1, row0, act, f16, add, outs, s);
    }
  } else if (vec) {
    launch<float, 2>(x, y, n, c, win, dcoef, bias, strength, noise_const, key_row, mode, k0, k1,
                     row0, act, f32, add, outs, s);
  } else {
    launch<float, 1>(x, y, n, c, win, dcoef, bias, strength, noise_const, key_row, mode, k0, k1,
                     row0, act, f32, add, outs, s);
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
                               T* __restrict__ out, int c, shgan::NoiseWindow win,
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
  const long long qa = win.q0 + static_cast<long long>(blockIdx.y) * G.calls_per_block;
  const long long qb = qa + G.calls_per_block < win.q1 ? qa + G.calls_per_block : win.q1;
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
    // the window offsets of the thread's cos and sin runs (-1: not in it)
    const long long o[2] = {shgan::noise_offset(win, 0, 2 * q),
                            shgan::noise_offset(win, 1, 2 * q)};
    float nu[2][V];
    if (mode == shgan::nba::kNoiseRandom) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        shgan::noise_quad(static_cast<uint32_t>(q + j), shgan::noise_row(row0, row), k0, k1,
                          &nu[0][2 * j], &nu[1][2 * j]);
      }
    } else if (mode == shgan::nba::kNoiseConst) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (o[h] >= 0) load<V>(noise_const + o[h], nu[h]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) nu[0][e] = nu[1][e] = 0.0f;
    }
#pragma unroll 1
    for (int k = 0; k < kn; ++k) {
      const long long base = (p0 + k) * win.len;
      const float d = sd[k], b = sb[k];
      float acc[3];
      if (!MASK_ONLY) {
        acc[0] = sums[k][0][t];
        acc[1] = sums[k][1][t];
        acc[2] = sums[k][2][t];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (o[h] < 0) continue;
        float gv[V], xv[V];
        load<V>(dy + base + o[h], gv);
        load<V>(x + base + o[h], xv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float nz = mode != shgan::nba::kNoiseNone ? shgan::nba::mul_rn(nu[h][e], s)
                                                          : -0.0f;
          gv[e] = MASK_ONLY ? shgan::nba::mask_element(gv[e], vsv, has_vs, xv[e], d, nu[h][e],
                                                       nz, b, act)
                            : shgan::nba::grad_element(gv[e], xv[e], d, has_d, nu[h][e], nz, b,
                                                       act, acc);
        }
        store<V>(out + base + o[h], gv);
      }
      if (!MASK_ONLY) {
        sums[k][0][t] = acc[0];
        sums[k][1][t] = acc[1];
        sums[k][2][t] = acc[2];
      }
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
void launch_grad(const void* dy, const void* x, void* out, int n, int c,
                 const shgan::NoiseWindow& win, const float* dcoef, const float* bias,
                 const float* strength, const float* noise_const, int mode, uint32_t k0,
                 uint32_t k1, long long row0, Act act, bool mask_only, const float* vs,
                 float* work, cudaStream_t stream) {
  const GradLaunch G = shgan::nba::grad_plan_calls(n, c, win.q1 - win.q0, CPT);
  const dim3 grid(static_cast<unsigned int>(static_cast<long long>(n) * G.groups),
                  static_cast<unsigned int>(G.chunks));
  const T* dyp = static_cast<const T*>(dy);
  const T* xp = static_cast<const T*>(x);
  T* outp = static_cast<T*>(out);
  if (mask_only) {
    noise_bias_act_grad_kernel<T, CPT, true><<<grid, G.threads, 0, stream>>>(
        dyp, xp, outp, c, win, dcoef, bias, strength, noise_const, mode, k0, k1, row0, act, vs,
        G, work);
  } else {
    noise_bias_act_grad_kernel<T, CPT, false><<<grid, G.threads, 0, stream>>>(
        dyp, xp, outp, c, win, dcoef, bias, strength, noise_const, mode, k0, k1, row0, act, vs,
        G, work);
  }
}

}  // namespace

// The epilogue's gradient at the conv output x [n, c, rows, res] (the
// forward's input: rows [h0, h0 + rows) of each res x res plane, h0 = 0 and
// rows = res for the whole plane), float32 (bf16 == 0) or bfloat16 (bf16 ==
// 1), for the forward's dcoef, bias, strength, noise_const, mode, key, row0
// and activation (as in shgan_noise_bias_act).  Full mode (mask_only == 0):
// dy is the cotangent of y; writes out = dx, dd [n, c], db [c] and ds [1]
// (every pointer set; vs unused), the sums over the window's pixels.
// Mask-only mode: dy is v; writes out = act'(pre) * (v + vs * nu) (vs a
// float32 on the device, or null for none), nothing else.  dy, x and out of
// x's type; dd, db, ds and work float32, work of grad_work_floats_calls(n,
// c, q1 - q0 of the window) elements (full mode).  dy, x, out contiguous,
// res even, 8-byte aligned (float32) or 4-byte aligned (bf16); 16-byte
// aligned pointers and res % 4 == 0 (res % 8 == 0 for a bf16 window) take
// the vectorized path.  Returns
// cudaGetLastError() after the launches.
extern "C" int shgan_noise_bias_act_grad(const void* dy, const void* x, void* out, int bf16,
                                         int n, int c, int res, int rows, int h0,
                                         const float* dcoef, const float* bias,
                                         const float* strength, const float* noise_const,
                                         int mode, unsigned int k0, unsigned int k1,
                                         long long row0, float alpha, float gain, float clamp,
                                         int mask_only, const float* vs, float* dd, float* db,
                                         float* ds, float* work, void* stream) {
  if (res < 2 || res % 2 || h0 < 0 || rows < 1 || h0 + rows > res)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || c == 0) return static_cast<int>(cudaSuccess);
  const Act act{alpha, gain, clamp};
  const shgan::NoiseWindow win = shgan::noise_window(res, h0, rows);
  // a window's bounds are multiples of res: a thread's run of 8 bf16 pairs
  // stays on one side of them when res % 8 == 0
  const bool runs = bf16 == 0 || (h0 == 0 && rows == res) || res % 8 == 0;
  const bool vec = res % 4 == 0 && runs && reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(noise_const) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mo = mask_only != 0;
  if (bf16) {
    if (vec) {
      launch_grad<uint16_t, 4>(dy, x, out, n, c, win, dcoef, bias, strength, noise_const, mode,
                               k0, k1, row0, act, mo, vs, work, s);
    } else {
      launch_grad<uint16_t, 1>(dy, x, out, n, c, win, dcoef, bias, strength, noise_const, mode,
                               k0, k1, row0, act, mo, vs, work, s);
    }
  } else if (vec) {
    launch_grad<float, 2>(dy, x, out, n, c, win, dcoef, bias, strength, noise_const, mode, k0,
                          k1, row0, act, mo, vs, work, s);
  } else {
    launch_grad<float, 1>(dy, x, out, n, c, win, dcoef, bias, strength, noise_const, mode, k0,
                          k1, row0, act, mo, vs, work, s);
  }
  if (!mo) {
    const long long planes = static_cast<long long>(n) * c;
    const int chunks = shgan::nba::grad_chunks_calls(n, c, win.q1 - win.q0);
    float* pw = work + 3 * planes * chunks;
    const int threads = shgan::nba::kThreads;
    grad_finish_planes<<<static_cast<unsigned int>(shgan::nba::cdiv(planes, threads)), threads,
                         0, s>>>(work, planes, chunks, dd, pw);
    grad_finish_sums<<<static_cast<unsigned int>(shgan::nba::cdiv(c, threads) + 1), threads, 0,
                       s>>>(pw, n, c, db, ds);
  }
  return static_cast<int>(cudaGetLastError());
}
