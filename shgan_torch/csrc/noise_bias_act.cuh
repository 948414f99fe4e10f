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

// ---- the fold: the epilogue writes its consumers' inputs -------------------
//
// On a forward that records no gradient the co-modulated synthesis hands a
// layer's epilogue what its consumers would do to its result next
// (models/synthesis.py): add the encoder skip (an addend of x's shape) and
// multiply by each consumer's styles, y_k = v * scale_k[n, c] for up to two
// consumers.  The chain this replaces is PyTorch ops on tensors of the
// block's type T, each rounded to T, so the fold rounds where it rounds: the
// epilogue's result, then the sum, then each product (the store's rounding),
// and a scale is taken as T holds it (styles.to(x.dtype)).  `held` is a value
// as T holds it: a bf16 rounded to nearest even and widened back, a float32
// as it is.  In float32 the outputs are the chain's bit for bit.
SHGAN_HD float held(float f, bool bf16) { return bf16 ? from_bf16(to_bf16(f)) : f; }

// The value the consumers scale: the epilogue's result r, held, plus the
// addend a (already a T value) where there is one, held.
SHGAN_HD float fold_sum(float r, float a, bool add, bool bf16) {
  const float v = held(r, bf16);
  return add ? held(add_rn(v, a), bf16) : v;
}

// The Philox key and first counter row of a random-noise launch.  With a
// device row (k0, k1, row0) of a noise table (int64 [3]: ops/noise.py,
// noise_table) the launch reads them from it and ignores the scalars; with
// none (nullptr) it takes the scalars.  A captured CUDA graph holds its
// launches' scalars fixed: the table row is written before each replay, so
// each batch draws its own noise, as the TPU kernel reads its seed words
// from SMEM (shgan_tpu/ops/noise.py:94-95).  A key word is the low 32 bits
// of its int64.
struct NoiseKey {
  uint32_t k0, k1;
  long long row0;
};

SHGAN_HD NoiseKey pick_key(const long long* row, uint32_t k0, uint32_t k1, long long row0) {
  if (row == nullptr) return NoiseKey{k0, k1, row0};
  return NoiseKey{static_cast<uint32_t>(row[0]), static_cast<uint32_t>(row[1]), row[2]};
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

// A launch over `calls` Philox calls a plane (a whole res x res plane has
// res * res / 4; a window of its rows, the calls of noise_window);
// per_override > 0 forces the channels a thread walks (the harness's sweep).
SHGAN_HD Launch plan_calls(int n, int c, long long calls, int cpt, int per_override) {
  Launch L;
  L.cpt = cpt;
  const long long row_threads = calls / cpt;
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

SHGAN_HD Launch plan(int n, int c, int res, int cpt, int per_override) {
  return plan_calls(n, c, static_cast<long long>(res) * res / 4, cpt, per_override);
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

// ---- the channels-last (NHWC) map --------------------------------------------
//
// x [N, R, R, C] in memory (a channels-last tensor of logical shape
// [N, C, R, R]), whole planes only: the compiled forward's layout.  The
// channel is the fastest axis, so the C channels of pixel p are contiguous
// and share one noise value.  A block takes the Philox calls [qa, qa + cpb)
// of one batch row (qa = bx * cpb): the pixels [2 qa, 2 qa + 2 nq) of the cos
// half and the same pixels + R*R/2 of the sin half (nq = the calls left, at
// most cpb), each half's a contiguous run of 2 nq C elements.  Its threads
// first draw each call once (a thread a call; noise_quad with the NCHW map's
// key, counter and row, so the same draws: call q yields pixels 2q, 2q + 1
// and R*R/2 + 2q, R*R/2 + 2q + 1 on both maps), times the strength, into
// shared memory; then walk each run `vec` elements an access (4: 16-byte
// float32 / 8-byte bf16 accesses where C % 4 == 0 and the pointers allow,
// else 1), neighbouring threads on neighbouring channels (nhwc_walk).
// cpb: the most calls (a power of two up to kNhwcMaxCalls) whose two runs
// hold at most kNhwcElems elements, halved while the grid has fewer than
// kTargetBlocks blocks, and at most a plane's calls.
constexpr int kNhwcMaxCalls = 512;
constexpr long long kNhwcElems = 8192;

struct NhwcLaunch {
  int vec;          // elements an access: 4 or 1
  long long cpb;    // Philox calls a block
  long long tiles;  // blocks a batch row (grid x)
};

SHGAN_HD NhwcLaunch plan_nhwc(int n, int c, int res, int vec) {
  NhwcLaunch L;
  L.vec = vec;
  const long long calls = static_cast<long long>(res) * res / 4;
  long long cpb = 1;
  while (cpb < kNhwcMaxCalls && 4 * (2 * cpb) * c <= kNhwcElems) cpb *= 2;
  while (cpb > 1 && n * cdiv(calls, cpb) < kTargetBlocks) cpb /= 2;
  while (cpb > 1 && cpb > calls) cpb /= 2;
  L.cpb = cpb;
  L.tiles = cdiv(calls, cpb);
  return L;
}

// The calls of tile bx: at most cpb, fewer at a plane's end.
SHGAN_HD long long nhwc_calls(const NhwcLaunch& L, long long bx, long long calls) {
  const long long left = calls - bx * L.cpb;
  return left < L.cpb ? left : L.cpb;
}

// Pixel index (within the plane) of pixel pl of half h's run of tile bx.
SHGAN_HD long long nhwc_pixel(const NhwcLaunch& L, long long bx, int h, long long half,
                              long long pl) {
  return h * half + 2 * bx * L.cpb + pl;
}

// Thread t's walk over one run of nq calls' pixels, C channels each:
// f(e, pl, ch) for each of its accesses, e the run's element of the access's
// first element, pl its pixel in the run and ch its channel (an access of
// vec elements stays in one pixel: vec divides C).
template <typename F>
SHGAN_HD void nhwc_walk(const NhwcLaunch& L, long long nq, int c, int t, int threads, F&& f) {
  const long long run = 2 * nq * c;
  const long long step = static_cast<long long>(threads) * L.vec;
  const long long dpl = step / c;
  const int dch = static_cast<int>(step - dpl * c);
  long long e = static_cast<long long>(t) * L.vec;
  long long pl = e / c;
  int ch = static_cast<int>(e - pl * c);
  for (; e < run; e += step) {
    f(e, pl, ch);
    pl += dpl;
    ch += dch;
    if (ch >= c) {
      ch -= c;
      ++pl;
    }
  }
}

// ---- the gradient (noise_bias_act_grad in noise_bias_act.cu) ---------------
//
// With pre = x * dcoef + noise * strength + bias, the cotangent of pre is
// g = dy * act'(pre): the activation's gain, times alpha where pre < 0, and
// 0 where a finite clamp is active (or y is NaN), in the order autograd of
// the plain chain takes it (clamp's mask, then * gain, then * alpha; a
// linear layer has no clamp and alpha 1).  pre is recomputed with the
// forward's roundings, so the mask is the forward's own.
SHGAN_HD float act_grad(float dy, float x, float dcoef, float noise_term, float bias, Act a) {
  const float pre = add_rn(fma_rn(x, dcoef, noise_term), bias);
  if (a.clamp <= 3.40282347e38f) {
    float y = pre >= 0.0f ? pre : mul_rn(pre, a.alpha);
    y = mul_rn(y, a.gain);
    if (!(y >= -a.clamp && y <= a.clamp)) return 0.0f;
  }
  const float g = mul_rn(dy, a.gain);
  return pre >= 0.0f ? g : mul_rn(g, a.alpha);
}

// One element of the full mode: dx = g * dcoef written, and the three
// sums carried in acc: dd += g * x, db += g, ds += g * nu (nu the raw normal,
// noise_term = nu * strength).  With bf16 I/O, dy and x arrive widened to
// float32 (from_bf16, exact), this arithmetic runs unchanged, and the result
// is rounded once by to_bf16 at the store: dx is the float32 kernel's dx on
// the same values, rounded to nearest even; the sums are the float32
// kernel's sums of the widened inputs, bit for bit.
SHGAN_HD float grad_element(float dy, float x, float dcoef, bool has_dcoef, float nu,
                            float noise_term, float bias, Act a, float* acc) {
  const float g = act_grad(dy, x, dcoef, noise_term, bias, a);
  acc[0] = fma_rn(g, x, acc[0]);
  acc[1] = add_rn(acc[1], g);
  acc[2] = fma_rn(g, nu, acc[2]);
  return has_dcoef ? mul_rn(g, dcoef) : g;
}

// One element of the mask-only mode (the double backward): act'(pre) times
// v + vs * nu, with no sums.
SHGAN_HD float mask_element(float v, float vs, bool has_vs, float x, float dcoef, float nu,
                            float noise_term, float bias, Act a) {
  const float u = has_vs ? add_rn(v, mul_rn(vs, nu)) : v;
  return act_grad(u, x, dcoef, noise_term, bias, a);
}

// The grad launch: a block per (row n, group of `group` consecutive
// channels, chunk of the plane's Philox calls); grid x the N * groups
// channel groups, grid y `chunks` blocks a group.  A thread draws the
// normals of its calls once and walks the group's channels with them, so
// the noise is regenerated once per pixel and group, not once per element
// (Philox and Box-Muller cost ~40 operations an element otherwise, more
// than the element's own work: the kernel was held by them).  `group` is
// the largest power of two up to kGradGroup that leaves kGradTargetBlocks
// blocks at the most chunks a plane takes (one per 2 * kThreads calls);
// `chunks` the fewest that give kGradTargetBlocks blocks.  A chunk is a run
// of calls_per_block calls, a multiple of max(cpt, 2), so a thread that
// owns cpt calls (2 in float32, 4 in bf16: 16-byte accesses either way)
// keeps them together; thread t walks calls first + t * cpt, stepping
// threads * cpt.  A thread carries three sums for each channel of its group
// in the order it meets that channel's elements; the block combines each
// channel's with a fixed tree (tree_add) and writes one partial per (sum,
// plane, chunk).  Two small kernels finish in a fixed order: each plane's
// partials over its chunks (dd[n, c] final), then db[c] over n and ds over
// the planes.  No float atomics: the sums are the same bits on every run.
constexpr long long kGradTargetBlocks = 1024;
constexpr int kGradGroup = 8;

struct GradLaunch {
  int threads;                // block threads: the fewest warps (power of 2) covering a chunk
  int group;                  // channels a block walks
  int groups;                 // channel groups of a row: cdiv(c, group)
  int chunks;                 // blocks a channel group (grid y)
  long long calls_per_block;  // Philox calls a block covers, a multiple of max(cpt, 2)
};

// The grad launch over `calls` Philox calls a plane (res * res / 4 for a
// whole plane, a window's q1 - q0).
SHGAN_HD long long grad_max_chunks_calls(long long calls) {
  const long long kmax = cdiv(calls, 2LL * kThreads);
  return kmax < 1 ? 1 : kmax;
}

SHGAN_HD int grad_group_calls(int n, int c, long long calls) {
  const long long kmax = grad_max_chunks_calls(calls);
  int g = kGradGroup;
  while (g > 1 && static_cast<long long>(n) * cdiv(c, g) * kmax < kGradTargetBlocks) g /= 2;
  return g;
}

SHGAN_HD int grad_chunks_calls(int n, int c, long long calls) {
  const long long blocks = static_cast<long long>(n) * cdiv(c, grad_group_calls(n, c, calls));
  long long k = cdiv(kGradTargetBlocks, blocks);
  const long long kmax = grad_max_chunks_calls(calls);
  if (k > kmax) k = kmax;
  return k < 1 ? 1 : static_cast<int>(k);
}

SHGAN_HD GradLaunch grad_plan_calls(int n, int c, long long calls, int cpt) {
  GradLaunch G;
  G.group = grad_group_calls(n, c, calls);
  G.groups = static_cast<int>(cdiv(c, G.group));
  G.chunks = grad_chunks_calls(n, c, calls);
  const long long mult = cpt > 2 ? cpt : 2;
  const long long cpb = cdiv(cdiv(calls, G.chunks), mult) * mult;
  G.calls_per_block = cpb;
  G.threads = 32;
  while (G.threads < kThreads && static_cast<long long>(G.threads) * cpt < cpb) G.threads *= 2;
  return G;
}

// Floats of the grad kernel's work buffer: the partials (3 x planes x
// chunks) and the per-plane sums of db and ds (2 x planes).
SHGAN_HD long long grad_work_floats_calls(int n, int c, long long calls) {
  const long long planes = static_cast<long long>(n) * c;
  return 3 * planes * grad_chunks_calls(n, c, calls) + 2 * planes;
}

SHGAN_HD long long whole_plane_calls(int res) { return static_cast<long long>(res) * res / 4; }
SHGAN_HD long long grad_max_chunks(int res) { return grad_max_chunks_calls(whole_plane_calls(res)); }
SHGAN_HD int grad_group(int n, int c, int res) {
  return grad_group_calls(n, c, whole_plane_calls(res));
}
SHGAN_HD int grad_chunks(int n, int c, int res) {
  return grad_chunks_calls(n, c, whole_plane_calls(res));
}
SHGAN_HD GradLaunch grad_plan(int n, int c, int res, int cpt) {
  return grad_plan_calls(n, c, whole_plane_calls(res), cpt);
}
SHGAN_HD long long grad_work_floats(int n, int c, int res) {
  return grad_work_floats_calls(n, c, whole_plane_calls(res));
}

// One level of the block's fixed tree: s[t] += s[t + half] for t < half.
SHGAN_HD void tree_add(float* s, int t, int half) {
  if (t < half) s[t] = add_rn(s[t], s[t + half]);
}

}  // namespace nba
}  // namespace shgan
