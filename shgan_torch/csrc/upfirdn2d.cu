// upfirdn2d in one pass: zero-insert by `up`, signed pad/crop, 2-D FIR with up
// to 8x8 taps (flip and gain folded in on the host), decimate by `down`, for
// up, down in {1, 2}; NCHW float32 or bfloat16 in and out, float32 sums.
//
// Replaces the TPU kernel shgan_tpu/ops/fir_pallas.py:100-123 (_pallas_fir),
// which ran only the stride-1 separable FIR over an input padded by XLA; here
// the padding, the zero insertion and the decimation are index arithmetic in
// the same kernel, so the padded or upsampled tensor is never written.
//
// Bound on the card: bytes.  A 4x4 filter does 16 multiply-adds per output
// (4 where up=2), far below the card's ratio of operations to bytes; the
// least traffic is one read of the input and one write of the output.
// Design:
// * up = down = 1 (every FIR of the main path but the 3-channel image
//   upsample; the arithmetic is in upfirdn2d.cuh): a persistent grid (as
//   many blocks as fit on the card at once) walks work items, each a 64x64
//   output tile of one plane, a 32x32 tile of four planes or a 16x16 tile
//   of sixteen (fir_tile_mode: the fewest staged input elements plus a fixed
//   cost per item), so an 8x8 plane does not leave a tile mostly idle, and
//   an item's window is clipped to the plane, so the encoder's (R+1)x(R+1)
//   edge items cost little.  The window is read with 16-byte loads (4
//   float32 or 8 bfloat16) from the chunk boundary at or below each row's
//   first element, so every row loads vectorized whatever W and the pads
//   are.  Each chunk lands in shared memory as float with 16-byte stores at
//   its own place in the staged row (the row starts `shift` floats into its
//   first chunk), and only a chunk that crosses an end of the plane row is
//   masked.  The loads of the next item are issued into registers before
//   this item computes, so they are in flight while it does.  Each thread
//   slides a 4-row window of 5 values down a strip of 8 rows x 2 columns of
//   outputs in registers, reading each staged row once per strip, two values
//   at a time.  Other taps up to 8x8 take the same staging with a plain loop
//   over the taps.
// * down = 2 or up = 2 (D's 1x1 skips and their backward, the skip-image
//   upsample and its backward, R1's second order): the same persistent
//   grid, work items, 16-byte staging from the chunk boundary and register
//   prefetch, with each mode's windows (upfirdn2d.cuh).  down = 2 stages
//   each row split by parity, so a thread's stride-2 taps are consecutive
//   words, and slides a 4-row window two rows an output down a strip of 4
//   outputs; up = 2 is polyphase: a thread computes 2 x 2 quads (one output
//   of each phase, each from its own 2 x 2 subset of the taps) from a 3 x 3
//   input neighbourhood and writes each output row of two quads with one
//   16-byte (8-byte bf16) store.  The traffic is the same as the stride-1
//   path's: one read of the input, one write of the output.
// * anything else (up = down = 2, one axis only, a tensor off 16-byte
//   alignment): one thread per output element; the taps that meet a sample
//   are found with shifts and masks (up is 1 or 2).  fir_route picks.
// * channels-last tensors (the compiled forward's layout) take the NHWC map
//   (upfirdn2d.cuh): a thread owns 4 channels (16-byte float32 loads, 8-byte
//   bf16) or, for the 3-channel skip image, one, of a strip of outputs, and
//   neighbouring threads neighbouring channels; stride 1 slides a register
//   window down a strip of 8 rows x 2 columns, up = 2 computes a 2 x 2 quad
//   from its 3 x 3 input pixels, other resampling sums one output a thread.  The input is read from device memory once, its reuse across a
//   strip in registers and across neighbouring strips from L1/L2; every
//   access is a contiguous run of channels.
// The taps ride in the kernel's parameter space.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "upfirdn2d.cuh"

namespace {

struct Taps {
  float v[shgan::kMaxTaps * shgan::kMaxTaps];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct TileArgs {
  long long planes;
  int items, h, w, out_h, out_w, padx0, pady0, fh, fw, tiles_x, tiles_y;
  int vec_store;  // up = 2: output rows take 16-byte (8-byte bf16) stores
};

// A 16-byte chunk as float: 4 float32 or 8 bfloat16.
__device__ __forceinline__ void chunk_floats(const uint4& d, float (&f)[4]) {
  f[0] = __uint_as_float(d.x);
  f[1] = __uint_as_float(d.y);
  f[2] = __uint_as_float(d.z);
  f[3] = __uint_as_float(d.w);
}
__device__ __forceinline__ void chunk_floats(const uint4& d, float (&f)[8]) {
  const uint32_t w[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// N consecutive staged values from float index p: pairs from an even index
// (8-byte aligned), a single value where one is left over.
template <int N>
__device__ __forceinline__ void staged_values(const float* win, int p, float (&v)[N]) {
  const float* src = win + p;
  if ((p & 1) == 0) {
#pragma unroll
    for (int j = 0; j + 1 < N; j += 2) {
      const float2 t = *reinterpret_cast<const float2*>(src + j);
      v[j] = t.x;
      v[j + 1] = t.y;
    }
    if (N % 2) v[N - 1] = src[N - 1];
  } else {
    v[0] = src[0];
#pragma unroll
    for (int j = 1; j + 1 < N; j += 2) {
      const float2 t = *reinterpret_cast<const float2*>(src + j);
      v[j] = t.x;
      v[j + 1] = t.y;
    }
    if (N % 2 == 0) v[N - 1] = src[N - 1];
  }
}

// K = 4: 4x4 taps, unrolled; K = 0: any fh, fw <= kMaxTaps.
template <typename T, int GW, int GH, int K>
__global__ void __launch_bounds__(shgan::kFirThreads)
    upfirdn2d_tile_kernel(const T* __restrict__ x, T* __restrict__ y, TileArgs a, Taps taps) {
  using namespace shgan;
  using M = FirMode<GW, GH>;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kTaps = K > 0 ? K : kMaxTaps;
  constexpr int kRows = GH + kTaps - 1;                   // staged rows, at most
  constexpr int kRowF = fir_row_elems(GW, kTaps, kVec);  // floats a staged row
  constexpr int kRoles =  // staging roles of a thread, at most
      (M::kPlanes * kRows * (kRowF / kVec) + kFirThreads - 1) / kFirThreads;
  __shared__ __align__(16) float tile[M::kPlanes * kRows * kRowF];
  const int th = GH + a.fh - 1, nch = fir_chunks(GW + a.fw - 1, kVec);
  const int roles = M::kPlanes * th * nch;
  const long long in_plane = static_cast<long long>(a.h) * a.w;
  const long long out_plane = static_cast<long long>(a.out_h) * a.out_w;
  // This thread's staging roles, the same for every item: plane slot, staged
  // row, chunk, packed k << 20 | iy << 10 | q (-1: none).
  int role[kRoles];
#pragma unroll
  for (int i = 0; i < kRoles; ++i) {
    const int j = threadIdx.x + i * kFirThreads;
    int k, iy, q;
    fir_stage_role(j, th, nch, &k, &iy, &q);
    role[i] = j < roles ? (k << 20) | (iy << 10) | q : -1;
  }
  int tk, ts, tc;
  fir_thread(threadIdx.x, GW, GH, &tk, &ts, &tc);

  // An item: index (-1: none), plane group, tile origin, staged window.
  struct Item {
    int idx, g, ty0, tx0, th, tw;
  };
  auto item_at = [&](int idx) {
    Item it{-1, 0, 0, 0, 0, 0};
    if (idx < 0 || idx >= a.items) return it;
    it.idx = idx;
    fir_item(idx, a.tiles_x, a.tiles_y, GW, GH, &it.g, &it.ty0, &it.tx0);
    it.th = fir_window(it.ty0, a.out_h, GH, a.fh);
    it.tw = fir_window(it.tx0, a.out_w, GW, a.fw);
    return it;
  };
  // Flat index of window element (iy, 0) of plane slot k of item `it`.
  auto row_start = [&](const Item& it, int k, int iy) {
    const long long plane = static_cast<long long>(it.g) * M::kPlanes + k;
    return plane * in_plane + static_cast<long long>(it.ty0 - a.pady0 + iy) * a.w +
           (it.tx0 - a.padx0);
  };
  // Issue the loads of item `it` into d (col: each chunk's window column;
  // a chunk at or past the window's end is not staged).
  auto load = [&](uint4 (&d)[kRoles], int (&col)[kRoles], const Item& it) {
    const int x0 = it.tx0 - a.padx0;
#pragma unroll
    for (int i = 0; i < kRoles; ++i) {
      d[i] = make_uint4(0, 0, 0, 0);
      col[i] = INT_MAX;
      const int iy = (role[i] >> 10) & 1023;
      if (role[i] < 0 || iy >= it.th) continue;
      const int k = role[i] >> 20, q = role[i] & 1023, sy = it.ty0 - a.pady0 + iy;
      const long long start = row_start(it, k, iy);
      col[i] = fir_chunk_col(start, q, kVec);
      if (static_cast<long long>(it.g) * M::kPlanes + k >= a.planes || sy < 0 || sy >= a.h ||
          !fir_chunk_needed(col[i], kVec, x0, a.w, it.tw))
        continue;
      d[i] = __ldg(reinterpret_cast<const uint4*>(x + fir_chunk_at(start, q, kVec)));
    }
  };
  // Store the chunks of item `it` into its staged rows, 16 bytes at a time,
  // masking the elements of a chunk that crosses the plane row's ends.
  auto stage = [&](const uint4 (&d)[kRoles], const int (&col)[kRoles], const Item& it) {
    const int x0 = it.tx0 - a.padx0;
#pragma unroll
    for (int i = 0; i < kRoles; ++i) {
      if (col[i] >= it.tw) continue;
      float f[kVec];
      chunk_floats(d[i], f);
      if (!fir_chunk_in_row(col[i], kVec, x0, a.w)) {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          if (!fir_col_in_row(col[i] + e, x0, a.w)) f[e] = 0.0f;
      }
      float4* dst = reinterpret_cast<float4*>(
          tile + ((role[i] >> 20) * kRows + ((role[i] >> 10) & 1023)) * kRowF +
          (role[i] & 1023) * kVec);
#pragma unroll
      for (int v = 0; v < kVec / 4; ++v)
        dst[v] = make_float4(f[4 * v], f[4 * v + 1], f[4 * v + 2], f[4 * v + 3]);
    }
  };
  const float* win = tile + tk * kRows * kRowF;
  // This thread's outputs of the staged item `it`.
  auto compute = [&](const Item& it) {
    const long long plane = static_cast<long long>(it.g) * M::kPlanes + tk;
    const int ox = it.tx0 + tc, oy0 = it.ty0 + ts * kStrip;
    if (plane >= a.planes || ox >= a.out_w || oy0 >= a.out_h) return;
    const int s0 = fir_row_shift(row_start(it, tk, 0), kVec);
    auto pos = [=](int r, int c) { return fir_staged_pos(r, c, kRowF, s0, a.w, kVec); };
    float out[kStrip][kCols];
    if constexpr (K > 0) {
      // the values of staged row r from window column c
      auto row = [&](int r, int c, auto& v) { staged_values(win, pos(r, c), v); };
      fir_strip_fixed<K, K>(row, taps.v, ts * kStrip, tc, out);
    } else {
      auto at = [&](int r, int c) { return win[pos(r, c)]; };
      fir_strip(at, taps.v, a.fh, a.fw, ts * kStrip, tc, out);
    }
    T* dst = y + plane * out_plane + static_cast<long long>(oy0) * a.out_w + ox;
    const bool both = ox + 1 < a.out_w;
#pragma unroll
    for (int r = 0; r < kStrip; ++r) {
      if (oy0 + r >= a.out_h) break;
      store(dst, out[r][0]);
      if (both) store(dst + 1, out[r][1]);
      dst += a.out_w;
    }
  };

  // The chunks of the next item are loaded into registers while the staged
  // item computes.
  uint4 d[kRoles];
  int col[kRoles];
  Item cur = item_at(blockIdx.x);
  if (cur.idx < 0) return;
  load(d, col, cur);
  stage(d, col, cur);
  __syncthreads();
  while (true) {
    const Item nxt = item_at(cur.idx + static_cast<int>(gridDim.x));
    if (nxt.idx >= 0) load(d, col, nxt);
    compute(cur);
    if (nxt.idx < 0) break;
    __syncthreads();  // every thread is done with cur's windows
    stage(d, col, nxt);
    __syncthreads();
    cur = nxt;
  }
}

// Four outputs of one row: one 16-byte (float32) or 8-byte (bf16) store.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

// The resampling paths: UP = false is down = 2, UP = true is up = 2 (the
// other factor 1); G x G output tiles (ResampleMode); K = 4: the unrolled
// 4x4 code (fir_resample_fixed), K = 0: any fh, fw <= kMaxTaps.  Blocks an
// SM (tools/k2_bounds_bench.py): three (at most 85 registers a thread) for
// up = 2 and down = 2's 32² tiles, whose float32 calls on 64²-256² planes
// ran 11-13 % faster than at the compiler's 119 registers and two blocks;
// two for down = 2's small tiles, whose calls ran 7-8 % slower with three.
template <typename T, bool UP, int G, int K>
__global__ void __launch_bounds__(shgan::kFirThreads, (UP || G == 32) ? 3 : 2)
    upfirdn2d_resample_kernel(const T* __restrict__ x, T* __restrict__ y, TileArgs a,
                              Taps taps) {
  using namespace shgan;
  using M = ResampleMode<UP, G>;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kTaps = K > 0 ? K : kMaxTaps;
  constexpr int kRows = fir_resample_extent(UP, G, kTaps);  // staged rows, at most
  constexpr int kRowF = fir_chunks(fir_resample_extent(UP, G, kTaps), kVec) * kVec;
  constexpr int kHalf = kRowF / 2;  // down = 2: the odd positions' half of a row
  constexpr int kRoles = (M::kPlanes * kRows * (kRowF / kVec) + kFirThreads - 1) / kFirThreads;
  static_assert(K == 0 || K == 4, "the unrolled code is 4x4");
  __shared__ __align__(16) float tile[M::kPlanes * kRows * kRowF];
  // staged rows, and chunks a staged row, of a tile that is not clipped
  const int th = fir_resample_window(UP, 0, G, G, a.fh, a.pady0);
  const int nch = fir_chunks(fir_resample_window(UP, 0, G, G, a.fw, a.padx0), kVec);
  const int roles = M::kPlanes * th * nch;
  const long long in_plane = static_cast<long long>(a.h) * a.w;
  const long long out_plane = static_cast<long long>(a.out_h) * a.out_w;
  // staging roles, packed k << 20 | iy << 10 | q (-1: none), as in
  // upfirdn2d_tile_kernel
  int role[kRoles];
#pragma unroll
  for (int i = 0; i < kRoles; ++i) {
    const int j = threadIdx.x + i * kFirThreads;
    int k, iy, q;
    fir_stage_role(j, th, nch, &k, &iy, &q);
    role[i] = j < roles ? (k << 20) | (iy << 10) | q : -1;
  }
  int tk, ts, tc;
  if constexpr (UP) {
    fir_up_thread(threadIdx.x, G, &tk, &ts, &tc);
  } else {
    fir_down_thread(threadIdx.x, G, &tk, &ts, &tc);
  }

  // An item: index (-1: none), plane group, tile origin, staged window
  // (extent, and the input sample of its element (0, 0)).
  struct Item {
    int idx, g, ty0, tx0, th, tw, iy0, ix0;
  };
  auto item_at = [&](int idx) {
    Item it{-1, 0, 0, 0, 0, 0, 0, 0};
    if (idx < 0 || idx >= a.items) return it;
    it.idx = idx;
    fir_item(idx, a.tiles_x, a.tiles_y, G, G, &it.g, &it.ty0, &it.tx0);
    it.th = fir_resample_window(UP, it.ty0, a.out_h, G, a.fh, a.pady0);
    it.tw = fir_resample_window(UP, it.tx0, a.out_w, G, a.fw, a.padx0);
    it.iy0 = fir_resample_start(UP, it.ty0, a.pady0);
    it.ix0 = fir_resample_start(UP, it.tx0, a.padx0);
    return it;
  };
  // Flat index of window element (iy, 0) of plane slot k of item `it`.
  auto row_start = [&](const Item& it, int k, int iy) {
    const long long plane = static_cast<long long>(it.g) * M::kPlanes + k;
    return plane * in_plane + static_cast<long long>(it.iy0 + iy) * a.w + it.ix0;
  };
  auto load = [&](uint4 (&d)[kRoles], int (&col)[kRoles], const Item& it) {
#pragma unroll
    for (int i = 0; i < kRoles; ++i) {
      d[i] = make_uint4(0, 0, 0, 0);
      col[i] = INT_MAX;
      const int iy = (role[i] >> 10) & 1023;
      if (role[i] < 0 || iy >= it.th) continue;
      const int k = role[i] >> 20, q = role[i] & 1023, sy = it.iy0 + iy;
      const long long start = row_start(it, k, iy);
      col[i] = fir_chunk_col(start, q, kVec);
      if (static_cast<long long>(it.g) * M::kPlanes + k >= a.planes || sy < 0 || sy >= a.h ||
          !fir_chunk_needed(col[i], kVec, it.ix0, a.w, it.tw))
        continue;
      d[i] = __ldg(reinterpret_cast<const uint4*>(x + fir_chunk_at(start, q, kVec)));
    }
  };
  // Store the chunks of item `it` into its staged rows: as they come (up =
  // 2), or split by parity (down = 2: the even elements of chunk q at float
  // q * kVec / 2 of the row's first half, the odd ones of its second).
  auto stage = [&](const uint4 (&d)[kRoles], const int (&col)[kRoles], const Item& it) {
#pragma unroll
    for (int i = 0; i < kRoles; ++i) {
      if (col[i] >= it.tw) continue;
      float f[kVec];
      chunk_floats(d[i], f);
      if (!fir_chunk_in_row(col[i], kVec, it.ix0, a.w)) {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          if (!fir_col_in_row(col[i] + e, it.ix0, a.w)) f[e] = 0.0f;
      }
      float* row = tile + ((role[i] >> 20) * kRows + ((role[i] >> 10) & 1023)) * kRowF;
      const int q = role[i] & 1023;
      if constexpr (UP) {
        float4* dst = reinterpret_cast<float4*>(row + q * kVec);
#pragma unroll
        for (int v = 0; v < kVec / 4; ++v)
          dst[v] = make_float4(f[4 * v], f[4 * v + 1], f[4 * v + 2], f[4 * v + 3]);
      } else if constexpr (kVec == 4) {
        *reinterpret_cast<float2*>(row + q * 2) = make_float2(f[0], f[2]);
        *reinterpret_cast<float2*>(row + kHalf + q * 2) = make_float2(f[1], f[3]);
      } else {
        *reinterpret_cast<float4*>(row + q * 4) = make_float4(f[0], f[2], f[4], f[6]);
        *reinterpret_cast<float4*>(row + kHalf + q * 4) = make_float4(f[1], f[3], f[5], f[7]);
      }
    }
  };
  const float* win = tile + tk * kRows * kRowF;
  // This thread's outputs of the staged item `it`.
  auto compute = [&](const Item& it) {
    const long long plane = static_cast<long long>(it.g) * M::kPlanes + tk;
    if (plane >= a.planes) return;
    const int s0 = fir_row_shift(row_start(it, tk, 0), kVec);
    if constexpr (UP) {
      const int ox0 = it.tx0 + 2 * tc, oy0 = it.ty0 + 2 * kUpStrip * ts;
      if (ox0 >= a.out_w || oy0 >= a.out_h) return;
      auto pos = [=](int r, int c) { return fir_staged_pos(r, c, kRowF, s0, a.w, kVec); };
      float out[kUpStrip][2][kUpOut];
      if constexpr (K > 0) {
        auto row = [&](int r, float (&v)[kUpQuads + 2]) { staged_values(win, pos(r, tc), v); };
        fir_up_quads_fixed4(row, taps.v, kUpStrip * ts, out);
      } else {
        auto at = [&](int r, int c) { return win[pos(r, c)]; };
        fir_up_quads(at, taps.v, a.fh, a.fw, a.padx0, a.pady0, kUpStrip * ts, tc, out);
      }
      const bool whole = a.vec_store && ox0 + kUpOut <= a.out_w;
#pragma unroll
      for (int r = 0; r < 2 * kUpStrip; ++r) {
        if (oy0 + r >= a.out_h) break;
        T* dst = y + plane * out_plane + static_cast<long long>(oy0 + r) * a.out_w + ox0;
        const float(&v)[kUpOut] = out[r / 2][r % 2];
        if (whole) {
          store4(dst, v);
        } else {
#pragma unroll
          for (int e = 0; e < kUpOut; ++e)
            if (ox0 + e < a.out_w) store(dst + e, v[e]);
        }
      }
    } else {
      const int ox = it.tx0 + tc, oy0 = it.ty0 + kDownStrip * ts;
      if (ox >= a.out_w || oy0 >= a.out_h) return;
      float out[kDownStrip];
      if constexpr (K > 0) {
        auto row = [&](int r, float (&v)[K]) {
          fir_down_row(win, r, tc, kRowF, s0, a.w, kVec, v);
        };
        fir_down_strip_fixed<K, K>(row, taps.v, 2 * kDownStrip * ts, out);
      } else {
        auto at = [&](int r, int c) {
          return win[fir_split_pos(r, c, kRowF, s0, a.w, kVec)];
        };
        fir_down_strip(at, taps.v, a.fh, a.fw, 2 * kDownStrip * ts, tc, out);
      }
      T* dst = y + plane * out_plane + static_cast<long long>(oy0) * a.out_w + ox;
#pragma unroll
      for (int r = 0; r < kDownStrip; ++r) {
        if (oy0 + r >= a.out_h) break;
        store(dst, out[r]);
        dst += a.out_w;
      }
    }
  };

  // The chunks of the next item are loaded into registers while the staged
  // item computes.
  uint4 d[kRoles];
  int col[kRoles];
  Item cur = item_at(blockIdx.x);
  if (cur.idx < 0) return;
  load(d, col, cur);
  stage(d, col, cur);
  __syncthreads();
  while (true) {
    const Item nxt = item_at(cur.idx + static_cast<int>(gridDim.x));
    if (nxt.idx >= 0) load(d, col, nxt);
    compute(cur);
    if (nxt.idx < 0) break;
    __syncthreads();  // every thread is done with cur's windows
    stage(d, col, nxt);
    __syncthreads();
    cur = nxt;
  }
}

template <typename T>
__global__ void upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t planes,
                                 int h, int w, int out_h, int out_w, int lupx, int lupy,
                                 int downx, int downy, int padx0, int pady0, Taps taps,
                                 int fh, int fw) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ox >= out_w || oy >= out_h) return;
  const int64_t in_plane = static_cast<int64_t>(h) * w;
  const int64_t out_plane = static_cast<int64_t>(out_h) * out_w;
  for (int64_t p = blockIdx.z; p < planes; p += gridDim.z) {
    const T* src = x + p * in_plane;
    auto load = [src, w](int sy, int sx) { return to_float(__ldg(src + sy * w + sx)); };
    const float v = shgan::upfirdn2d_point(load, h, w, lupx, lupy, downx, downy, padx0,
                                           pady0, taps.v, fh, fw, ox, oy);
    store(y + p * out_plane + static_cast<int64_t>(oy) * out_w + ox, v);
  }
}

// ---- the channels-last (NHWC) map ------------------------------------------

struct NhwcArgs {
  int h, w, c, out_h, out_w, lupx, lupy, downx, downy, padx0, pady0, fh, fw;
  shgan::NhwcFir P;
};

// V channels of an NHWC tensor at element offset `off`, as float.
template <int V>
__device__ __forceinline__ void load_v(const float* x, long long off, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(x + off));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = __ldg(x + off + k);
  }
}
template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* x, long long off, float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(x + off));
    v[0] = __uint_as_float(t.x << 16); v[1] = __uint_as_float(t.x & 0xffff0000u);
    v[2] = __uint_as_float(t.y << 16); v[3] = __uint_as_float(t.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = to_float(x[off + k]);
  }
}
template <int V>
__device__ __forceinline__ void store_v(float* y, long long off, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(y + off) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) y[off + k] = v[k];
  }
}
template <int V>
__device__ __forceinline__ void store_v(__nv_bfloat16* y, long long off, const float (&v)[V]) {
  if constexpr (V == 4) {
    store4(y + off, v);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) y[off + k] = __float2bfloat16(v[k]);
  }
}

// up = down = 1.  K = 4: 4x4 taps, the register window of fir_strip_fixed;
// K = 0: any fh, fw <= kMaxTaps, fir_strip's loop over the taps.
template <typename T, int V, int K>
__global__ void __launch_bounds__(shgan::kNhwcThreads)
    upfirdn2d_nhwc_tile_kernel(const T* __restrict__ x, T* __restrict__ y, NhwcArgs a,
                               Taps taps) {
  using namespace shgan;
  const unsigned int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.P.threads) return;
  int n, oy0, ox0, ch;
  nhwc_fir_thread(a.P, t, &n, &oy0, &ox0, &ch);
  // V channels of input pixel (sy, sx), zero outside the plane
  auto pixel = [&](int sy, int sx, float (&v)[V]) {
    if (sy < 0 || sy >= a.h || sx < 0 || sx >= a.w) {
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = 0.0f;
      return;
    }
    load_v<V>(x, nhwc_offset(n, sy, sx, ch, a.h, a.w, a.c), v);
  };
  auto put = [&](int oy, int ox, const float (&v)[V]) {
    store_v<V>(y, nhwc_offset(n, oy, ox, ch, a.out_h, a.out_w, a.c), v);
  };
  const int iy0 = oy0 - a.pady0, ix0 = ox0 - a.padx0;
  if constexpr (K > 0) {
    nhwc_fir_strip_fixed<K, V>(pixel, put, taps.v, oy0, ox0, iy0, ix0, a.out_h, a.out_w);
  } else {
    nhwc_fir_strip<V>(pixel, put, taps.v, a.fh, a.fw, oy0, ox0, iy0, ix0, a.out_h, a.out_w);
  }
}

// up = 2, 4x4 taps, even pads: a 2 x 2 quad of output pixels' V channels a
// thread.
template <typename T, int V>
__global__ void __launch_bounds__(shgan::kNhwcThreads)
    upfirdn2d_nhwc_up2_kernel(const T* __restrict__ x, T* __restrict__ y, NhwcArgs a,
                              Taps taps) {
  using namespace shgan;
  const unsigned int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.P.threads) return;
  int n, oy0, ox0, ch;
  nhwc_fir_thread(a.P, t, &n, &oy0, &ox0, &ch);
  auto pixel = [&](int sy, int sx, float (&v)[V]) {
    if (sy < 0 || sy >= a.h || sx < 0 || sx >= a.w) {
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = 0.0f;
      return;
    }
    load_v<V>(x, nhwc_offset(n, sy, sx, ch, a.h, a.w, a.c), v);
  };
  auto put = [&](int oy, int ox, const float (&v)[V]) {
    store_v<V>(y, nhwc_offset(n, oy, ox, ch, a.out_h, a.out_w, a.c), v);
  };
  nhwc_up2_quad<V>(pixel, put, taps.v, oy0, ox0, a.padx0, a.pady0, a.out_h, a.out_w);
}

// Any up, down in {1, 2}: one output pixel's V channels a thread.
template <typename T, int V>
__global__ void __launch_bounds__(shgan::kNhwcThreads)
    upfirdn2d_nhwc_kernel(const T* __restrict__ x, T* __restrict__ y, NhwcArgs a, Taps taps) {
  using namespace shgan;
  const unsigned int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.P.threads) return;
  int n, oy, ox, ch;
  nhwc_fir_thread(a.P, t, &n, &oy, &ox, &ch);
  auto load = [&](int sy, int sx, float (&v)[V]) {
    load_v<V>(x, nhwc_offset(n, sy, sx, ch, a.h, a.w, a.c), v);
  };
  float acc[V];
  upfirdn2d_point_v<V>(load, a.h, a.w, a.lupx, a.lupy, a.downx, a.downy, a.padx0, a.pady0,
                       taps.v, a.fh, a.fw, ox, oy, acc);
  store_v<V>(y, nhwc_offset(n, oy, ox, ch, a.out_h, a.out_w, a.c), acc);
}

template <typename T, int V>
cudaError_t launch_nhwc_v(const T* x, T* y, NhwcArgs a, int route, const Taps& t,
                          cudaStream_t s) {
  if (a.P.threads > INT_MAX) return cudaErrorInvalidValue;  // nhwc_fir_thread's range
  const long long blocks = (a.P.threads + shgan::kNhwcThreads - 1) / shgan::kNhwcThreads;
  const unsigned int grid = static_cast<unsigned int>(blocks);
  if (route == shgan::kNhwcUp2) {
    upfirdn2d_nhwc_up2_kernel<T, V><<<grid, shgan::kNhwcThreads, 0, s>>>(x, y, a, t);
  } else if (route == shgan::kNhwcGeneric) {
    upfirdn2d_nhwc_kernel<T, V><<<grid, shgan::kNhwcThreads, 0, s>>>(x, y, a, t);
  } else if (a.fh == 4 && a.fw == 4) {
    upfirdn2d_nhwc_tile_kernel<T, V, 4><<<grid, shgan::kNhwcThreads, 0, s>>>(x, y, a, t);
  } else {
    upfirdn2d_nhwc_tile_kernel<T, V, 0><<<grid, shgan::kNhwcThreads, 0, s>>>(x, y, a, t);
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_nhwc(const void* x, void* y, int n, int c, int h, int w, int out_h,
                        int out_w, int upx, int upy, int downx, int downy, int padx0,
                        int pady0, const Taps& t, int fh, int fw, cudaStream_t s) {
  const uintptr_t vb = 4 * sizeof(T);  // a 4-channel access
  const int vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(x) % vb == 0 &&
                          reinterpret_cast<uintptr_t>(y) % vb == 0
                      ? 4
                      : 1;
  const int route = shgan::nhwc_fir_route(upx, upy, downx, downy, fh, fw, padx0, pady0);
  NhwcArgs a{h, w, c, out_h, out_w, shgan::log2_factor(upx), shgan::log2_factor(upy), downx,
             downy, padx0, pady0, fh, fw, shgan::nhwc_fir_plan(n, c, out_h, out_w, vec, route)};
  const T* xin = static_cast<const T*>(x);
  T* yout = static_cast<T*>(y);
  return vec == 4 ? launch_nhwc_v<T, 4>(xin, yout, a, route, t, s)
                  : launch_nhwc_v<T, 1>(xin, yout, a, route, t, s);
}

// A grid of one wave for kernel `fn`: as many blocks as the card holds at
// once (per_sm: its blocks per SM, found once), or fewer.
cudaError_t one_wave(const void* fn, int& per_sm, int items, unsigned int* grid) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && per_sm == 0)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, shgan::kFirThreads, 0);
  if (e != cudaSuccess) return e;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<unsigned int>(items < cap ? items : cap);
  return cudaSuccess;
}

template <typename T, int GW, int GH>
cudaError_t launch_tile(const T* x, T* y, long long planes, int h, int w, int out_h, int out_w,
                        int padx0, int pady0, const Taps& t, int fh, int fw, cudaStream_t s) {
  using M = shgan::FirMode<GW, GH>;
  TileArgs a{planes, 0, h, w, out_h, out_w, padx0, pady0, fh, fw, (out_w + GW - 1) / GW,
             (out_h + GH - 1) / GH};
  const long long items = (planes + M::kPlanes - 1) / M::kPlanes * a.tiles_x * a.tiles_y;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  a.items = static_cast<int>(items);
  const bool k4 = fh == 4 && fw == 4;
  const void* fn = k4 ? reinterpret_cast<const void*>(upfirdn2d_tile_kernel<T, GW, GH, 4>)
                      : reinterpret_cast<const void*>(upfirdn2d_tile_kernel<T, GW, GH, 0>);
  static int blocks_per_sm[2] = {0, 0};  // of this instantiation: 4x4 taps, other taps
  unsigned int grid = 0;
  const cudaError_t e = one_wave(fn, blocks_per_sm[k4 ? 0 : 1], a.items, &grid);
  if (e != cudaSuccess) return e;
  if (k4) {
    upfirdn2d_tile_kernel<T, GW, GH, 4><<<grid, shgan::kFirThreads, 0, s>>>(x, y, a, t);
  } else {
    upfirdn2d_tile_kernel<T, GW, GH, 0><<<grid, shgan::kFirThreads, 0, s>>>(x, y, a, t);
  }
  return cudaSuccess;
}

template <typename T, bool UP, int G>
cudaError_t launch_resample(const T* x, T* y, long long planes, int h, int w, int out_h,
                            int out_w, int padx0, int pady0, const Taps& t, int fh, int fw,
                            cudaStream_t s) {
  using M = shgan::ResampleMode<UP, G>;
  TileArgs a{planes, 0, h, w, out_h, out_w, padx0, pady0, fh, fw, (out_w + G - 1) / G,
             (out_h + G - 1) / G,
             out_w % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0};
  const long long items = (planes + M::kPlanes - 1) / M::kPlanes * a.tiles_x * a.tiles_y;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  a.items = static_cast<int>(items);
  const bool k4 = shgan::fir_resample_fixed(UP, fh, fw, padx0, pady0);
  const void* fn = k4 ? reinterpret_cast<const void*>(upfirdn2d_resample_kernel<T, UP, G, 4>)
                      : reinterpret_cast<const void*>(upfirdn2d_resample_kernel<T, UP, G, 0>);
  static int blocks_per_sm[2] = {0, 0};  // of this instantiation: 4x4 taps, other taps
  unsigned int grid = 0;
  const cudaError_t e = one_wave(fn, blocks_per_sm[k4 ? 0 : 1], a.items, &grid);
  if (e != cudaSuccess) return e;
  if (k4) {
    upfirdn2d_resample_kernel<T, UP, G, 4><<<grid, shgan::kFirThreads, 0, s>>>(x, y, a, t);
  } else {
    upfirdn2d_resample_kernel<T, UP, G, 0><<<grid, shgan::kFirThreads, 0, s>>>(x, y, a, t);
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long planes, int h, int w, int out_h, int out_w,
                   int upx, int upy, int downx, int downy, int padx0, int pady0, const Taps& t,
                   int fh, int fw, cudaStream_t s) {
  const T* xin = static_cast<const T*>(x);
  T* yout = static_cast<T*>(y);
  switch (shgan::fir_route(upx, upy, downx, downy, reinterpret_cast<uintptr_t>(x) % 16 == 0)) {
    case shgan::kRouteTile:
      switch (shgan::fir_tile_mode(out_h, out_w, fh, fw)) {
        case 0:
          return launch_tile<T, 64, 64>(xin, yout, planes, h, w, out_h, out_w, padx0, pady0, t,
                                        fh, fw, s);
        case 1:
          return launch_tile<T, 32, 32>(xin, yout, planes, h, w, out_h, out_w, padx0, pady0, t,
                                        fh, fw, s);
        default:
          return launch_tile<T, 16, 16>(xin, yout, planes, h, w, out_h, out_w, padx0, pady0, t,
                                        fh, fw, s);
      }
    case shgan::kRouteDown2:
      switch (shgan::fir_resample_mode(false, out_h, out_w, fh, fw, padx0, pady0)) {
        case 0:
          return launch_resample<T, false, 32>(xin, yout, planes, h, w, out_h, out_w, padx0,
                                               pady0, t, fh, fw, s);
        case 1:
          return launch_resample<T, false, 16>(xin, yout, planes, h, w, out_h, out_w, padx0,
                                               pady0, t, fh, fw, s);
        default:
          return launch_resample<T, false, 8>(xin, yout, planes, h, w, out_h, out_w, padx0,
                                              pady0, t, fh, fw, s);
      }
    case shgan::kRouteUp2:
      switch (shgan::fir_resample_mode(true, out_h, out_w, fh, fw, padx0, pady0)) {
        case 0:
          return launch_resample<T, true, 64>(xin, yout, planes, h, w, out_h, out_w, padx0,
                                              pady0, t, fh, fw, s);
        case 1:
          return launch_resample<T, true, 32>(xin, yout, planes, h, w, out_h, out_w, padx0,
                                              pady0, t, fh, fw, s);
        default:
          return launch_resample<T, true, 16>(xin, yout, planes, h, w, out_h, out_w, padx0,
                                              pady0, t, fh, fw, s);
      }
    default:
      break;
  }
  const unsigned int gz = static_cast<unsigned int>(planes < 65535 ? planes : 65535);
  const dim3 block(shgan::kBlockW, shgan::kBlockH);
  const dim3 grid((out_w + shgan::kBlockW - 1) / shgan::kBlockW,
                  (out_h + shgan::kBlockH - 1) / shgan::kBlockH, gz);
  upfirdn2d_kernel<T><<<grid, block, 0, s>>>(
      xin, yout, planes, h, w, out_h, out_w, shgan::log2_factor(upx), shgan::log2_factor(upy),
      downx, downy, padx0, pady0, t, fh, fw);
  return cudaSuccess;
}

bool factor_ok(int f) { return f == 1 || f == 2; }

}  // namespace

// x: contiguous [planes, h, w]; y: contiguous [planes, out_h, out_w]; dtype 0 =
// float32, 1 = bfloat16.  taps: host pointer to fh*fw row-major float32
// correlation taps.  nhwc_c > 0: x and y are channels-last instead, [planes /
// nhwc_c, h, w, nhwc_c] and [planes / nhwc_c, out_h, out_w, nhwc_c] in memory
// (the NHWC map).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments outside the kernels' range.
extern "C" int shgan_upfirdn2d(const void* x, void* y, int dtype, long long planes, int h,
                               int w, int out_h, int out_w, int upx, int upy, int downx,
                               int downy, int padx0, int pady0, const float* taps, int fh,
                               int fw, int nhwc_c, void* stream) {
  if (fh < 1 || fw < 1 || fh > shgan::kMaxTaps || fw > shgan::kMaxTaps || !factor_ok(upx) ||
      !factor_ok(upy) || !factor_ok(downx) || !factor_ok(downy) || (dtype != 0 && dtype != 1) ||
      nhwc_c < 0 || (nhwc_c > 0 && (planes % nhwc_c != 0 || planes / nhwc_c > INT_MAX)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (planes == 0 || out_h <= 0 || out_w <= 0) return static_cast<int>(cudaSuccess);
  Taps t = {};
  for (int i = 0; i < fh * fw; ++i) t.v[i] = taps[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nhwc_c > 0) {
    const int n = static_cast<int>(planes / nhwc_c);
    const cudaError_t e =
        dtype == 0 ? launch_nhwc<float>(x, y, n, nhwc_c, h, w, out_h, out_w, upx, upy, downx,
                                        downy, padx0, pady0, t, fh, fw, s)
                   : launch_nhwc<__nv_bfloat16>(x, y, n, nhwc_c, h, w, out_h, out_w, upx, upy,
                                                downx, downy, padx0, pady0, t, fh, fw, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t e =
      dtype == 0 ? launch<float>(x, y, planes, h, w, out_h, out_w, upx, upy, downx, downy,
                                 padx0, pady0, t, fh, fw, s)
                 : launch<__nv_bfloat16>(x, y, planes, h, w, out_h, out_w, upx, upy, downx,
                                         downy, padx0, pady0, t, fh, fw, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
