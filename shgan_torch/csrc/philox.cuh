// Counter-based Philox4x32-10 generator and the Box-Muller conversion used by
// the per-layer noise kernel (noise.cu).  Every function here is
// __host__ __device__ so a host-only harness (tests/test_torch_kernel_math.py)
// can run the exact arithmetic the kernel runs, against the PyTorch plain
// version in shgan_torch/ops/noise.py.
//
// Philox4x32-10 is the generator of Salmon et al., "Parallel random numbers:
// as easy as 1, 2, 3" (SC'11), with the Random123 round constants; its
// known-answer vectors pin both this header and the plain version.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define SHGAN_HD __host__ __device__ __forceinline__
#else
#define SHGAN_HD inline
#endif

namespace shgan {

struct U32x4 {
  uint32_t v[4];
};

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

SHGAN_HD void mulhilo32(uint32_t a, uint32_t b, uint32_t* hi, uint32_t* lo) {
  const uint64_t p = static_cast<uint64_t>(a) * static_cast<uint64_t>(b);
  *hi = static_cast<uint32_t>(p >> 32);
  *lo = static_cast<uint32_t>(p);
}

SHGAN_HD U32x4 philox_round(U32x4 c, uint32_t k0, uint32_t k1) {
  uint32_t hi0, lo0, hi1, lo1;
  mulhilo32(kPhiloxM0, c.v[0], &hi0, &lo0);
  mulhilo32(kPhiloxM1, c.v[2], &hi1, &lo1);
  U32x4 out;
  out.v[0] = hi1 ^ c.v[1] ^ k0;
  out.v[1] = lo1;
  out.v[2] = hi0 ^ c.v[3] ^ k1;
  out.v[3] = lo0;
  return out;
}

// Ten rounds; the key is bumped by the Weyl constants between rounds.
SHGAN_HD U32x4 philox4x32_10(U32x4 ctr, uint32_t k0, uint32_t k1) {
  ctr = philox_round(ctr, k0, k1);
#if defined(__CUDACC__)
#pragma unroll
#endif
  for (int r = 1; r < 10; ++r) {
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
    ctr = philox_round(ctr, k0, k1);
  }
  return ctr;
}

SHGAN_HD float bits_to_float(uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(b);
#else
  float f;
  memcpy(&f, &b, sizeof(f));
  return f;
#endif
}

// 23 random mantissa bits under a 2^0 exponent give [1, 2); the TPU kernel's
// recipe (shgan_tpu/ops/noise.py:86-93): u1 = 2 - f in (0, 1] (log-safe),
// u2 = f - 1 in [0, 1).
SHGAN_HD float uniform_open_low(uint32_t b) {
  return 2.0f - bits_to_float(0x3F800000u | (b >> 9));
}

SHGAN_HD float uniform_open_high(uint32_t b) {
  return bits_to_float(0x3F800000u | (b >> 9)) - 1.0f;
}

// Full Box-Muller: one (u1, u2) pair gives the cos and the sin normal.
// Precise logf/sqrtf/sincosf (no fast-math intrinsics), so the kernel and the
// plain version differ only by the libraries' last-ulp rounding.
SHGAN_HD void box_muller(uint32_t b1, uint32_t b2, float* c, float* s) {
  const float u1 = uniform_open_low(b1);
  const float u2 = uniform_open_high(b2);
  const float r = sqrtf(-2.0f * logf(u1));
  const float theta = 6.28318548202514648f * u2;  // float32(2*pi)
#if defined(__CUDA_ARCH__)
  float sn, cs;
  sincosf(theta, &sn, &cs);
#else
  const float sn = sinf(theta), cs = cosf(theta);
#endif
  *c = r * cs;
  *s = r * sn;
}

// Layout of one noise plane [R, R] (the TPU kernel's): pair p in [0, R*R/2)
// writes its cos normal at flat index p and its sin normal at R*R/2 + p.
// Philox call `call` (counter (call, row, 0, 0)) yields pairs 2*call and
// 2*call + 1.
// The counter row of row n of a launch whose first row is row0 of the
// batch the noise is drawn for: a launch over rows row0... of a batch (a
// rank's block of a global batch) draws what those rows of a launch over the
// whole batch draw.
SHGAN_HD uint32_t noise_row(long long row0, long long n) {
  return static_cast<uint32_t>(row0 + n);
}

// A window of rows [h0, h0 + rows) of an R x R noise plane (a rank's slab of a
// plane sharded along H): the plane's layout above, read through the window.
// The window's flat offset o is the plane's flat index base + o.  It holds
// the cos normals of the pairs [cos_lo, cos_hi) and the sin normals of the
// pairs [sin_lo, sin_hi) (an empty range where it misses that half); the
// Philox calls [q0, q1) cover both.  With R even every bound is a multiple
// of R, so a run of 2k pairs starting at a multiple of 2k (k dividing R/2)
// lies wholly inside or wholly outside each half's range.  The whole plane
// (h0 = 0, rows = R) is calls [0, R*R/4), cos at p, sin at R*R/2 + p.
struct NoiseWindow {
  long long half;            // R * R / 2
  long long base, len;       // the window's first flat index and its length
  long long cos_lo, cos_hi;  // pairs whose cos normal lies in the window
  long long sin_lo, sin_hi;  // pairs whose sin normal lies in the window
  long long q0, q1;          // the Philox calls the window needs
};

SHGAN_HD NoiseWindow noise_window(int res, long long h0, long long rows) {
  NoiseWindow w;
  w.half = static_cast<long long>(res) * res / 2;
  w.base = h0 * res;
  w.len = rows * res;
  const long long end = w.base + w.len;
  w.cos_lo = w.base < w.half ? w.base : w.half;
  w.cos_hi = end < w.half ? end : w.half;
  w.sin_lo = (w.base > w.half ? w.base : w.half) - w.half;
  w.sin_hi = end > w.half ? end - w.half : 0;
  if (w.sin_hi < w.sin_lo) w.sin_hi = w.sin_lo;
  const bool has_cos = w.cos_hi > w.cos_lo, has_sin = w.sin_hi > w.sin_lo;
  const long long lo = has_cos ? (has_sin && w.sin_lo < w.cos_lo ? w.sin_lo : w.cos_lo)
                               : w.sin_lo;
  const long long hi = has_cos ? (has_sin && w.sin_hi > w.cos_hi ? w.sin_hi : w.cos_hi)
                               : w.sin_hi;
  w.q0 = lo / 2;
  w.q1 = (hi + 1) / 2;
  return w;
}

// The window offset of the cos (side 0) or sin (side 1) normal of pair p,
// or -1 where the window does not hold it.
SHGAN_HD long long noise_offset(const NoiseWindow& w, int side, long long p) {
  if (side == 0) return p >= w.cos_lo && p < w.cos_hi ? p - w.base : -1;
  return p >= w.sin_lo && p < w.sin_hi ? w.half + p - w.base : -1;
}

SHGAN_HD void noise_quad(uint32_t call, uint32_t row, uint32_t k0, uint32_t k1,
                         float* cos2, float* sin2) {
  U32x4 ctr;
  ctr.v[0] = call;
  ctr.v[1] = row;
  ctr.v[2] = 0u;
  ctr.v[3] = 0u;
  const U32x4 bits = philox4x32_10(ctr, k0, k1);
  box_muller(bits.v[0], bits.v[1], &cos2[0], &sin2[0]);
  box_muller(bits.v[2], bits.v[3], &cos2[1], &sin2[1]);
}

}  // namespace shgan
