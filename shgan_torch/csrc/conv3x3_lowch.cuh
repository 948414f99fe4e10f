// Tiling and index arithmetic of the low-channel 3x3 convolution (kernel K3),
// shared by the CUDA kernel (conv3x3_lowch.cu) and the host harness of
// tests/test_torch_kernel_math.py.
//
// Contract: y[n,o,i,j] = sum_{c,dy,dx} w[o,c,dy,dx] * x[n,c,i+dy-1,j+dx-1]
// (correlation, stride 1, zero padding 1), NCHW in and out, C, O <= 32.
//
// A block computes a kTileH x kTileW output tile of one image for all (up to
// 32) output channels.  It walks the input channels in chunks of kCChunk: per
// chunk it stages the input tile with its 1-pixel halo (zero outside the
// image and for channels >= C) and the chunk's weights, laid out
// [ci][dy][dx][o] with o padded to kMaxO (zero for o >= O).  Each of the
// kThreads threads owns kOGroup output channels of kPix consecutive pixels of
// one tile row and keeps their sums in registers.
#pragma once

#if defined(__CUDACC__)
#define SHGAN_HD __host__ __device__ __forceinline__
#define SHGAN_UNROLL _Pragma("unroll")
#else
#define SHGAN_HD inline
#define SHGAN_UNROLL
#endif

namespace shgan {
namespace conv3 {

constexpr int kMaxC = 32;
constexpr int kMaxO = 32;
constexpr int kTileW = 64;
constexpr int kTileH = 8;
constexpr int kPix = 8;      // consecutive output pixels per thread
constexpr int kOGroup = 8;   // output channels per thread
constexpr int kCChunk = 8;   // input channels staged at a time
constexpr int kInW = kTileW + 2;
constexpr int kInH = kTileH + 2;
constexpr int kStrips = kTileW / kPix;                          // per tile row
constexpr int kThreads = (kMaxO / kOGroup) * kStrips * kTileH;  // 256
constexpr int kInElems = kCChunk * kInH * kInW;                 // staged inputs
constexpr int kWElems = kCChunk * 9 * kMaxO;                    // staged weights

// Origin of tile (bx, by) in the output (and, shifted by the halo, the input).
SHGAN_HD int tile_x0(int bx) { return bx * kTileW; }
SHGAN_HD int tile_y0(int by) { return by * kTileH; }

// Staged input element i of a chunk: channel ci and tile position (iy, ix),
// which holds input pixel (y0 - 1 + iy, x0 - 1 + ix).
SHGAN_HD void halo_coords(int i, int y0, int x0, int* ci, int* sy, int* sx) {
  *ci = i / (kInH * kInW);
  const int r = i - *ci * (kInH * kInW);
  const int iy = r / kInW;
  *sy = y0 - 1 + iy;
  *sx = x0 - 1 + (r - iy * kInW);
}

// Whether that pixel lies in the image (else the staged value is zero: the
// padding, the ragged edge, a channel >= C).
SHGAN_HD bool halo_inside(int c, int sy, int sx, int C, int H, int W) {
  return c < C && sy >= 0 && sy < H && sx >= 0 && sx < W;
}

// Offset of w[o][c][dy][dx] in the OIHW weight.
SHGAN_HD int weight_offset(int o, int c, int dy, int dx, int C) {
  return ((o * C + c) * 3 + dy) * 3 + dx;
}

// Staged weight element i of a chunk: (ci, dy, dx, o), o fastest.
SHGAN_HD void weight_coords(int i, int* ci, int* dy, int* dx, int* o) {
  *o = i % kMaxO;
  const int r = i / kMaxO;  // (ci * 3 + dy) * 3 + dx
  *dx = r % 3;
  *dy = (r / 3) % 3;
  *ci = r / 9;
}

// Index of staged input (ci, iy, ix) and staged weight (ci, dy, dx, o).
SHGAN_HD int in_index(int ci, int iy, int ix) { return (ci * kInH + iy) * kInW + ix; }
SHGAN_HD int w_index(int ci, int dy, int dx, int o) {
  return ((ci * 3 + dy) * 3 + dx) * kMaxO + o;
}

// Thread t's role: output-channel group og (channels og*kOGroup ...), tile
// row ty and first tile column tx0.  The 64 threads of a group form two
// warps, so the weights a warp reads are the same for all its threads.
SHGAN_HD void thread_role(int t, int* og, int* ty, int* tx0) {
  *og = t / (kStrips * kTileH);
  const int s = t - *og * (kStrips * kTileH);
  *ty = s / kStrips;
  *tx0 = (s % kStrips) * kPix;
}

// Add one staged chunk to a thread's sums: acc[o][p] is output channel
// og*kOGroup + o at tile pixel (ty, tx0 + p).  `in(i)` / `wt(i)` read the
// staged input / weight arrays at in_index / w_index.
template <typename In, typename Wt>
SHGAN_HD void accumulate_chunk(const In& in, const Wt& wt, int og, int ty, int tx0,
                               float (&acc)[kOGroup][kPix]) {
  SHGAN_UNROLL
  for (int ci = 0; ci < kCChunk; ++ci) {
    SHGAN_UNROLL
    for (int dy = 0; dy < 3; ++dy) {
      float row[kPix + 2];
      SHGAN_UNROLL
      for (int k = 0; k < kPix + 2; ++k) row[k] = in(in_index(ci, ty + dy, tx0 + k));
      SHGAN_UNROLL
      for (int dx = 0; dx < 3; ++dx) {
        float wv[kOGroup];
        SHGAN_UNROLL
        for (int o = 0; o < kOGroup; ++o) wv[o] = wt(w_index(ci, dy, dx, og * kOGroup + o));
        SHGAN_UNROLL
        for (int o = 0; o < kOGroup; ++o) {
          SHGAN_UNROLL
          for (int p = 0; p < kPix; ++p) acc[o][p] += wv[o] * row[p + dx];
        }
      }
    }
  }
}

}  // namespace conv3
}  // namespace shgan
