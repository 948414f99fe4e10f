// Per-element arithmetic and index map of the fused synthesis-layer epilogue
// (noise_bias_act.cu).  Every function here is __host__ __device__ so a
// host-only harness (tests/test_torch_kernel_math.py) runs the exact code the
// kernel runs: the element math against numpy, the index map for coverage.
//
// One element of the conv output x [N, C, R, R] becomes
//
//   y = x * dcoef[n,c] + noise[n,h,w] * strength + bias[c]
//   y = (y >= 0 ? y : y * alpha) * gain
//   y = clamp(y, -clamp, clamp)
//
// with every term that a layer leaves out made neutral: dcoef 1, a noise term
// of -0 and a bias of -0 (x + -0 is x for every x, -0 included), alpha 1,
// gain 1, clamp +inf.  The arithmetic is float32 and rounds where the plain
// PyTorch chain (shgan_torch/ops/noise_bias_act.py) rounds: x * dcoef +
// noise once (addcmul's fused multiply-add; a plain product when the noise
// term is -0), then after each later op.  A float32 result differs from the
// plain chain's only where the noise itself does.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include "philox.cuh"

namespace shgan {
namespace nba {

enum NoiseMode : int { kNoiseNone = 0, kNoiseRandom = 1, kNoiseConst = 2 };

constexpr int kThreads = 256;
// The fewest channel chunks that give at least this many blocks: about one
// full wave of the H100 (132 SMs x 8 resident blocks of 256 threads).
constexpr long long kTargetBlocks = 1024;

// One rounding per PyTorch op of the plain chain, and no other contraction
// into an FMA: addcmul is one fused multiply-add, every other op rounds.
SHGAN_HD float fma_rn(float a, float b, float c) {
#if defined(__CUDA_ARCH__)
  return __fmaf_rn(a, b, c);
#else
  return fmaf(a, b, c);
#endif
}

SHGAN_HD float mul_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

SHGAN_HD float add_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

struct Act {
  float alpha;  // leaky-ReLU slope; 1 for a linear activation
  float gain;   // gain * runtime gain
  float clamp;  // clamp * runtime gain; +inf for none
};

SHGAN_HD float apply(float x, float dcoef, float noise_term, float bias, Act a) {
  float y = add_rn(fma_rn(x, dcoef, noise_term), bias);
  y = y >= 0.0f ? y : mul_rn(y, a.alpha);
  y = mul_rn(y, a.gain);
  // comparisons, not fminf/fmaxf, so NaN stays NaN as in torch.clamp
  return y < -a.clamp ? -a.clamp : (y > a.clamp ? a.clamp : y);
}

SHGAN_HD float from_bf16(uint16_t b) {
  const uint32_t u = static_cast<uint32_t>(b) << 16;
#if defined(__CUDA_ARCH__)
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, sizeof(f));
  return f;
#endif
}

// Round to nearest even, every NaN to 0x7FC0: PyTorch's float -> bfloat16.
SHGAN_HD uint16_t to_bf16(float f) {
#if defined(__CUDA_ARCH__)
  const uint32_t u = __float_as_uint(f);
#else
  uint32_t u;
  memcpy(&u, &f, sizeof(u));
#endif
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return 0x7FC0u;
  return static_cast<uint16_t>((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

// The launch.  Philox call q of batch row n yields the normals of flat plane
// indices 2q, 2q+1 (cos half) and R*R/2 + 2q, R*R/2 + 2q + 1 (sin half), as
// in kernel K1 (noise.cu).  A thread owns `cpt` consecutive calls of one row
// (2 when R % 4 == 0 and the pointers allow 16-byte float32 / 8-byte bf16
// accesses, else 1), draws their normals once and walks `per` channels,
// reading and writing its 2*cpt elements in each half of each plane.
//
// A block is bt call threads (x) by bc channel lanes (y), bt * bc = 256, with
// bt the smallest power of two that covers a row's call threads (at most
// 256): small planes fill the block with channels.  At loop step k, lane ty
// of chunk z takes channel (z * per + k) * bc + ty, so a warp's lanes touch
// neighbouring planes.  The grid is (call tiles, batch, channel chunks).
//
// The chunk rule: the fewest channel chunks that give kTargetBlocks blocks.
// At 4^2-32^2 (C = 512, 4-256 calls a row) the blocks come from the channels
// (shgan_g512 at batch 8: 32-1024 blocks, 1-2 channels a thread); at
// 512^2-1024^2 (C <= 64) the call tiles alone give >= 1024 blocks, so one
// chunk covers every channel and Philox runs once per pixel; between them
// (64^2-256^2) a thread draws its normals once for 8-32 channels.
struct Launch {
  int cpt;          // Philox calls per thread
  int bt, bc;       // block: bt call threads x bc channel lanes
  int per;          // channels a thread walks, bc apart
  int chunks;       // channel chunks (grid z)
  long long tiles;  // call tiles of a row (grid x)
};

SHGAN_HD long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// per_override > 0 forces the channels a thread walks (the harness's sweep).
SHGAN_HD Launch plan(int n, int c, int res, int cpt, int per_override) {
  Launch L;
  L.cpt = cpt;
  const long long row_threads = static_cast<long long>(res) * res / 4 / cpt;
  L.bt = 1;
  while (L.bt < kThreads && L.bt < row_threads) L.bt *= 2;
  L.bc = kThreads / L.bt;
  L.tiles = cdiv(row_threads, L.bt);
  const long long steps = cdiv(c, L.bc);  // loop steps of one chunk over all C
  long long chunks = cdiv(kTargetBlocks, L.tiles * n);
  if (chunks > steps) chunks = steps;
  long long per = cdiv(steps, chunks);
  if (per_override > 0) per = per_override < steps ? per_override : steps;
  L.per = static_cast<int>(per);
  L.chunks = static_cast<int>(cdiv(steps, per));
  return L;
}

// The first Philox call of call thread tx in tile bx, or -1 past the row.
SHGAN_HD long long first_call(const Launch& L, long long bx, int tx, long long calls) {
  const long long q = (bx * L.bt + tx) * L.cpt;
  return q < calls ? q : -1;
}

// The channel of loop step k of lane ty in chunk bz, or -1 past C.
SHGAN_HD int channel(const Launch& L, int bz, int ty, int k, int c) {
  const long long ch = (static_cast<long long>(bz) * L.per + k) * L.bc + ty;
  return ch < c ? static_cast<int>(ch) : -1;
}

}  // namespace nba
}  // namespace shgan
