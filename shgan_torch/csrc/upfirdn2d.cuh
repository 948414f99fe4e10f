// Index and padding arithmetic of the upfirdn2d contract, shared by the CUDA
// kernels (upfirdn2d.cu) and the host harness of tests/test_torch_kernel_math.py.
//
// Contract (shgan_tpu/ops/upfirdn2d.py:180-196): zero-insert up-1 zeros after
// every sample, signed pad (negative = crop), correlate with the taps (already
// flipped and gain-scaled on the host), keep every down-th sample.  Along one
// axis, output o reads the upsampled-and-padded signal at o*down + t for tap t,
// which is the upsampled signal at k = o*down + t - pad0; k holds the input
// sample k/up when k is a multiple of up and 0 <= k < n_in*up, else zero.
// The kernels take up, down in {1, 2}, so k/up and k%up are a shift and a mask.
#pragma once

#if defined(__CUDACC__)
#define SHGAN_HD __host__ __device__ __forceinline__
#else
#define SHGAN_HD inline
#endif

namespace shgan {

constexpr int kMaxTaps = 8;
// Tiled path (up = down = 1): a block of kBlockW x kBlockH threads computes a
// kTileW x kTileH output tile from a (kTileH + fh - 1) x (kTileW + fw - 1)
// input tile staged in shared memory.
constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kBlockW = 32;
constexpr int kBlockH = 8;
constexpr int kTileInW = kTileW + kMaxTaps - 1;
constexpr int kTileInH = kTileH + kMaxTaps - 1;

// Output extent along one axis (the reference host wrapper's arithmetic).
SHGAN_HD int upfirdn_out_size(int n_in, int up, int down, int pad0, int pad1, int taps) {
  return (n_in * up + pad0 + pad1 - taps) / down + 1;
}

// log2 of a factor in {1, 2}.
SHGAN_HD int log2_factor(int f) { return f >> 1; }

// First tap t >= 0 whose upsampled position base + t is a multiple of
// up = 1 << lg: (-base) mod up, for two's-complement base of either sign.
SHGAN_HD int upfirdn_first_tap(int base, int lg) { return (-base) & ((1 << lg) - 1); }

// One output element of the general path.  `load(sy, sx)` returns input
// sample (sy, sx) as float; it is only called for in-range indices.  Taps are
// row-major [fh, fw]; lupx/lupy are log2 of the up factors.
template <typename Load>
SHGAN_HD float upfirdn2d_point(const Load& load, int h, int w, int lupx, int lupy,
                               int downx, int downy, int padx0, int pady0,
                               const float* taps, int fh, int fw, int ox, int oy) {
  const int by = oy * downy - pady0;
  const int bx = ox * downx - padx0;
  const int hu = h << lupy, wu = w << lupx;
  float acc = 0.0f;
  for (int ty = upfirdn_first_tap(by, lupy); ty < fh; ty += 1 << lupy) {
    const int ky = by + ty;
    if (ky < 0 || ky >= hu) continue;
    const int sy = ky >> lupy;
    for (int tx = upfirdn_first_tap(bx, lupx); tx < fw; tx += 1 << lupx) {
      const int kx = bx + tx;
      if (kx < 0 || kx >= wu) continue;
      acc += taps[ty * fw + tx] * load(sy, kx >> lupx);
    }
  }
  return acc;
}

// Tiled path: tile element i along one axis holds input sample o0 - pad0 + i
// (o0 = the tile's first output), zero where that falls outside the input.
SHGAN_HD int tile_src(int o0, int pad0, int i) { return o0 - pad0 + i; }

// Output (ty, tx) of a tile from the staged input `tile(r, c)`.
template <typename Tile>
SHGAN_HD float tile_point(const Tile& tile, const float* taps, int fh, int fw, int ty,
                          int tx) {
  float acc = 0.0f;
  for (int i = 0; i < fh; ++i)
    for (int j = 0; j < fw; ++j) acc += taps[i * fw + j] * tile(ty + i, tx + j);
  return acc;
}

// The same with the tap count fixed at compile time, so the loops unroll.
template <int FH, int FW, typename Tile>
SHGAN_HD float tile_point_fixed(const Tile& tile, const float* taps, int ty, int tx) {
  float acc = 0.0f;
#if defined(__CUDACC__)
#pragma unroll
#endif
  for (int i = 0; i < FH; ++i) {
#if defined(__CUDACC__)
#pragma unroll
#endif
    for (int j = 0; j < FW; ++j) acc += taps[i * FW + j] * tile(ty + i, tx + j);
  }
  return acc;
}

}  // namespace shgan
