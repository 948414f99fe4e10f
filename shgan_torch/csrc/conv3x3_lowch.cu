// 3x3, stride-1, pad-1 convolution for C_in, C_out <= 32 (kernel K3): NCHW
// or NHWC (channels-last) float32 or bfloat16 in and out, float32 weights
// (OIHW correlation kernel), float32 sums.
//
// Replaces the TPU kernel shgan_tpu/ops/conv1024.py::conv3x3_lowch (body
// `_kernel`), which ran the conv as three dy-shifted [O,3C] x [3C,BH*W]
// contractions on the matrix unit over three row-shifted copies of the
// padded input, because blocked BlockSpecs cannot express overlapping
// windows.
//
// Bound on the card: bytes for bfloat16 I/O (0.54 GB at [4,32,1024^2] take
// 0.160 ms at 3.35 TB/s, the 77.3 GFLOP 0.078 ms at 989 TF/s); for float32
// I/O the 1.07 GB take 0.321 ms against 0.156 ms for the operations at the
// dense TF32 rate, but float32 accuracy needs three TF32 products per
// multiply-add (3xTF32), whose 0.469 ms at that rate are this design's floor.
// Design: an implicit GEMM on the tensor cores through mma.sync (M = output
// pixels, N = 32 output channels, K = 9*C; the layout is in
// conv3x3_lowch.cuh).  mma.sync and not wgmma: a dx shift of one pixel puts
// A's rows 4 bytes off the 16-byte alignment that a wgmma shared-memory
// descriptor needs, while mma.sync takes its A fragment from registers that
// each lane loads with a plain ld.shared at (c, y+dy, x+dx).
// * float32: m16n8k8 TF32, each operand split into a TF32 high part and a
//   TF32 residual; the weights are split once, as the block stages them.
// * bfloat16: m16n8k16 bf16 on channel pairs interleaved at staging.
// A persistent block per SM walks its tiles (16 rows x 64 pixels, all
// output channels) with every weight fragment resident in shared memory,
// and double-buffers the input stages: float32 stages land by cp.async
// (16-byte copies of the interior, 4-byte copies of the halo columns, zero
// fill outside the image) while the previous stage multiplies; bfloat16
// stages are loaded to registers and interleaved there, their loads in
// flight during the previous stage's multiplies.  The epilogue passes each
// warp's sums through shared memory and stores 16 bytes at a time along W.
// NHWC (the compiled forward's channels-last tensors, conv3x3_lowch.cuh):
// both dtypes stage by cp.async into a pixel-major stage, two 16-byte copies
// a pixel's 32 bytes of a stage (4-byte copies a slot where C is not a
// multiple of 16 bytes), and the multiplies read the NCHW path's words
// through the NHWC stage's index map; the epilogue stores each pixel's
// channels of an n8 tile as 16-byte runs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "conv3x3_lowch.cuh"

namespace {

using namespace shgan::conv3;

struct Args {
  const void* x;
  const float* w;
  void* y;
  int C, O, H, W, tiles_x, tiles_y, ntiles, nst;
  bool vec;  // W a multiple of 16 bytes and x, y 16-byte aligned
  int halo;  // input rows above and below the output's (0: pad 1 in H)
  bool chunks;  // NHWC: a pixel's channels a multiple of 16 bytes, x aligned
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
// 16 bytes at dst, the first `bytes` of them from src, the rest zero.
__device__ __forceinline__ void cp_async16n(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ const T* src_at(const T* x, const Args& a, int n, int c, int sy,
                                           int sx) {
  const int64_t plane = static_cast<int64_t>(n) * a.C + c;
  return x + (plane * (a.H + 2 * a.halo) + sy + a.halo) * a.W + sx;
}

using Acc = float[kMTiles][kNTiles][4];

// ---- NHWC staging (both dtypes) ---------------------------------------------------

template <int Bytes>
__device__ void stage_nhwc(const void* x, uint32_t* buf, const Args& a, int t, int s) {
  int n, y0, x0;
  tile_origin(t, a.tiles_x, a.tiles_y, &n, &y0, &x0);
  const uint32_t base = smem_addr(buf);
  const unsigned char* xb = static_cast<const unsigned char*>(x);
  if (a.chunks) {  // a pixel's half stage (4 slots) a 16-byte copy
    for (int j = threadIdx.x; j < 2 * kInH * kInW; j += kThreads) {
      int iy, ix, h;
      nhwc_chunk_item(j, &iy, &ix, &h);
      const int c = slot_channel<Bytes>(s, 4 * h, 0), sy = y0 - 1 + iy, sx = x0 - 1 + ix;
      const bool ok = inside(c, sy + a.halo, sx, a.C, a.H + 2 * a.halo, a.W);
      const int left = (a.C - c) * Bytes;  // the channels past C read as zero
      cp_async16n(base + 4 * nhwc_word(4 * h, iy, ix),
                  ok ? xb + Bytes * nhwc_src(n, c, sy, sx, a.C, a.H, a.W, a.halo) : xb,
                  ok ? (left < 16 ? left : 16) : 0);
    }
    return;
  }
  for (int j = threadIdx.x; j < kSlots * kInH * kInW; j += kThreads) {
    int slot, iy, ix;
    nhwc_item(j, &slot, &iy, &ix);
    const int c = slot_channel<Bytes>(s, slot, 0), sy = y0 - 1 + iy, sx = x0 - 1 + ix;
    // a bfloat16 pair (c, c + 1) is inside with c: C is even on this path
    const bool ok = inside(c, sy + a.halo, sx, a.C, a.H + 2 * a.halo, a.W);
    cp_async4(base + 4 * nhwc_word(slot, iy, ix),
              ok ? xb + Bytes * nhwc_src(n, c, sy, sx, a.C, a.H, a.W, a.halo) : xb, ok);
  }
}

// ---- float32: cp.async staging, 3xTF32 ----------------------------------------

__device__ void stage_f32(const float* x, uint32_t* buf, const Args& a, int t, int s) {
  int n, y0, x0;
  tile_origin(t, a.tiles_x, a.tiles_y, &n, &y0, &x0);
  const uint32_t base = smem_addr(buf);
  if (a.vec) {
    for (int j = threadIdx.x; j < kSlots * kInH * (kTileW / 4); j += kThreads) {
      int slot, iy, ix;
      vec_item(j, 4, &slot, &iy, &ix);
      const int c = s * 8 + slot, sy = y0 - 1 + iy, sx = x0 - 1 + ix;
      const bool ok = inside(c, sy + a.halo, sx, a.C, a.H + 2 * a.halo, a.W);  // all 4 or none
      cp_async16(base + 4 * staged_word(slot, iy, ix), ok ? src_at(x, a, n, c, sy, sx) : x, ok);
    }
    for (int j = threadIdx.x; j < kSlots * kInH * 2; j += kThreads) {
      int slot, iy, ix;
      halo_item(j, &slot, &iy, &ix);
      const int c = s * 8 + slot, sy = y0 - 1 + iy, sx = x0 - 1 + ix;
      const bool ok = inside(c, sy + a.halo, sx, a.C, a.H + 2 * a.halo, a.W);
      cp_async4(base + 4 * staged_word(slot, iy, ix), ok ? src_at(x, a, n, c, sy, sx) : x, ok);
    }
  } else {
    for (int j = threadIdx.x; j < kSlots * kInH * kInW; j += kThreads) {
      int slot, iy, ix;
      pixel_item(j, &slot, &iy, &ix);
      const int c = s * 8 + slot, sy = y0 - 1 + iy, sx = x0 - 1 + ix;
      const bool ok = inside(c, sy + a.halo, sx, a.C, a.H + 2 * a.halo, a.W);
      cp_async4(base + 4 * staged_word(slot, iy, ix), ok ? src_at(x, a, n, c, sy, sx) : x, ok);
    }
  }
}

// Weight fragment entry: B registers 0 and 1, TF32 high parts then residuals.
__device__ void stage_weights_f32(float4* wsm, const Args& a) {
  for (int e = threadIdx.x; e < a.nst * 9 * kNTiles * 32; e += kThreads) {
    const int lane = e & 31, nt = (e >> 5) % kNTiles, tap = (e / (32 * kNTiles)) % 9;
    const int s = e / (32 * kNTiles * 9);
    const int o = nt * 8 + b_col(lane);
    float hi[2], lo[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = slot_channel<4>(s, b_slot(lane, r), 0);
      const float v =
          (c < a.C && o < a.O) ? __ldg(a.w + weight_offset(o, c, tap / 3, tap % 3, a.C)) : 0.0f;
      split_tf32(v, &hi[r], &lo[r]);
    }
    wsm[wfrag_index(s, tap, nt, lane)] = make_float4(hi[0], hi[1], lo[0], lo[1]);
  }
}

// A register r's stage word: the NCHW stage's slot planes, or the NHWC stage.
template <bool NHWC>
__device__ __forceinline__ int a_at(int lane, int r, int warp, int mt, int dy, int dx) {
  if constexpr (NHWC) {
    return nhwc_a_word(lane, r, warp, mt, dy, dx);
  } else {
    return a_word(lane, r, warp, mt, dy, dx);
  }
}

template <bool NHWC = false>
__device__ __forceinline__ void mma_stage_f32(const uint32_t* buf, const float4* wsm, int s,
                                              int warp, int lane, Acc& acc) {
  const float* in = reinterpret_cast<const float*>(buf);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    float4 b[kNTiles];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) b[nt] = wsm[wfrag_index(s, tap, nt, lane)];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float h, l;
        split_tf32_a(in[a_at<NHWC>(lane, r, warp, mt, dy, dx)], &h, &l);
        ah[r] = __float_as_uint(h);
        al[r] = __float_as_uint(l);
      }
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {  // small terms first
        mma_tf32(acc[mt][nt], al, __float_as_uint(b[nt].x), __float_as_uint(b[nt].y));
        mma_tf32(acc[mt][nt], ah, __float_as_uint(b[nt].z), __float_as_uint(b[nt].w));
        mma_tf32(acc[mt][nt], ah, __float_as_uint(b[nt].x), __float_as_uint(b[nt].y));
      }
    }
  }
}

// ---- bfloat16: register staging with interleaved channel pairs ----------------

struct Bf16Stage {
  static constexpr int kItems = kSlots * kInH * (kTileW / 8);  // 8-pixel groups
  static constexpr int kPer = (kItems + kThreads - 1) / kThreads;
  static constexpr int kHalo = kSlots * kInH * 2;
  static_assert(kHalo <= kThreads, "one halo pair per thread");
  uint4 even[kPer], odd[kPer];  // channels 2p and 2p+1, 8 pixels each
  uint32_t halo;

  static __device__ __forceinline__ uint32_t pair(const __nv_bfloat16* x, const Args& a, int n,
                                                  int c, int sy, int sx) {
    const bool row = sy >= -a.halo && sy < a.H + a.halo && sx >= 0 && sx < a.W;
    const uint32_t lo =
        (row && c < a.C) ? __bfloat16_as_ushort(src_at(x, a, n, c, sy, sx)[0]) : 0u;
    const uint32_t hi =
        (row && c + 1 < a.C) ? __bfloat16_as_ushort(src_at(x, a, n, c + 1, sy, sx)[0]) : 0u;
    return lo | (hi << 16);
  }

  // Start the global loads of stage s of tile t (16-byte path only).
  __device__ __forceinline__ void load(const __nv_bfloat16* x, const Args& a, int t, int s) {
    if (!a.vec) return;
    int n, y0, x0;
    tile_origin(t, a.tiles_x, a.tiles_y, &n, &y0, &x0);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = threadIdx.x + k * kThreads;
      even[k] = odd[k] = make_uint4(0, 0, 0, 0);
      if (j >= kItems) continue;
      int p, iy, ix;
      vec_item(j, 8, &p, &iy, &ix);
      const int c = slot_channel<2>(s, p, 0), sy = y0 - 1 + iy, sx = x0 - 1 + ix;
      if (sy < -a.halo || sy >= a.H + a.halo || sx >= a.W) continue;  // all 8 or none
      if (c < a.C) even[k] = __ldg(reinterpret_cast<const uint4*>(src_at(x, a, n, c, sy, sx)));
      if (c + 1 < a.C)
        odd[k] = __ldg(reinterpret_cast<const uint4*>(src_at(x, a, n, c + 1, sy, sx)));
    }
    halo = 0;
    if (threadIdx.x < kHalo) {
      int p, iy, ix;
      halo_item(threadIdx.x, &p, &iy, &ix);
      halo = pair(x, a, n, slot_channel<2>(s, p, 0), y0 - 1 + iy, x0 - 1 + ix);
    }
  }

  // Interleave what load() fetched into `buf` (or, off the 16-byte path,
  // load and store the stage pixel by pixel).
  __device__ __forceinline__ void store(const __nv_bfloat16* x, uint32_t* buf, const Args& a,
                                        int t, int s) const {
    if (!a.vec) {
      int n, y0, x0;
      tile_origin(t, a.tiles_x, a.tiles_y, &n, &y0, &x0);
      for (int j = threadIdx.x; j < kSlots * kInH * kInW; j += kThreads) {
        int p, iy, ix;
        pixel_item(j, &p, &iy, &ix);
        buf[staged_word(p, iy, ix)] =
            pair(x, a, n, slot_channel<2>(s, p, 0), y0 - 1 + iy, x0 - 1 + ix);
      }
      return;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = threadIdx.x + k * kThreads;
      if (j >= kItems) continue;
      int p, iy, ix;
      vec_item(j, 8, &p, &iy, &ix);
      const uint32_t e[4] = {even[k].x, even[k].y, even[k].z, even[k].w};
      const uint32_t o[4] = {odd[k].x, odd[k].y, odd[k].z, odd[k].w};
      uint32_t wv[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        wv[2 * q] = pair_first(e[q], o[q]);
        wv[2 * q + 1] = pair_second(e[q], o[q]);
      }
      uint4* dst = reinterpret_cast<uint4*>(buf + staged_word(p, iy, ix));
      dst[0] = make_uint4(wv[0], wv[1], wv[2], wv[3]);
      dst[1] = make_uint4(wv[4], wv[5], wv[6], wv[7]);
    }
    if (threadIdx.x < kHalo) {
      int p, iy, ix;
      halo_item(threadIdx.x, &p, &iy, &ix);
      buf[staged_word(p, iy, ix)] = halo;
    }
  }
};

// Weight fragment entry: B registers 0 and 1, each a (c, c+1) bf16 pair.
__device__ void stage_weights_bf16(uint2* wsm, const Args& a) {
  for (int e = threadIdx.x; e < a.nst * 9 * kNTiles * 32; e += kThreads) {
    const int lane = e & 31, nt = (e >> 5) % kNTiles, tap = (e / (32 * kNTiles)) % 9;
    const int s = e / (32 * kNTiles * 9);
    const int o = nt * 8 + b_col(lane);
    uint32_t reg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = slot_channel<2>(s, b_slot(lane, r), h);
        v[h] = (c < a.C && o < a.O) ? __ldg(a.w + weight_offset(o, c, tap / 3, tap % 3, a.C))
                                    : 0.0f;
      }
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[0], v[1]);  // .x: the lower K
      reg[r] = *reinterpret_cast<const uint32_t*>(&b);
    }
    wsm[wfrag_index(s, tap, nt, lane)] = make_uint2(reg[0], reg[1]);
  }
}

template <bool NHWC = false>
__device__ __forceinline__ void mma_stage_bf16(const uint32_t* buf, const uint2* wsm, int s,
                                               int warp, int lane, Acc& acc) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    uint2 b[kNTiles];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) b[nt] = wsm[wfrag_index(s, tap, nt, lane)];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
      uint32_t af[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) af[r] = buf[a_at<NHWC>(lane, r, warp, mt, dy, dx)];
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) mma_bf16(acc[mt][nt], af, b[nt].x, b[nt].y);
    }
  }
}

// ---- epilogue -------------------------------------------------------------------

__device__ __forceinline__ void store_vec(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(v);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* dst, const float* v) {
  __nv_bfloat162 h[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(h);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// NHWC: a pixel's run of 16 / sizeof(T) channels, gathered from the scratch.
__device__ __forceinline__ void store_run(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_run(__nv_bfloat16* dst, const float (&v)[8]) {
  store_vec(dst, v);
}

// Warp `warp` writes its tile row (all output channels) and zeroes its sums.
template <typename T, bool NHWC>
__device__ __forceinline__ void epilogue(Acc& acc, float* sc, T* y, const Args& a, int t,
                                         int warp, int lane) {
  constexpr int kVec = Io<sizeof(T)>::kVec, kSegs = kTileW / kVec;
  int n, y0, x0;
  tile_origin(t, a.tiles_x, a.tiles_y, &n, &y0, &x0);
  const int oy = y0 + warp;
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        sc[out_word(c_col(lane, r), 16 * mt + c_row(lane, r))] = acc[mt][nt][r];
        acc[mt][nt][r] = 0.0f;
      }
    __syncwarp();
    if constexpr (NHWC) {
      // kRun channels a 16-byte run, kRuns runs an n8 tile a pixel
      constexpr int kRun = 16 / sizeof(T), kRuns = 8 / kRun;
      for (int j = lane; j < kTileW * kRuns && oy < a.H; j += 32) {
        const int px = j / kRuns, q = j - px * kRuns, ox = x0 + px;
        const int o0 = nt * 8 + q * kRun;
        if (ox >= a.W || o0 >= a.O) continue;
        float v[kRun];
#pragma unroll
        for (int k = 0; k < kRun; ++k) v[k] = sc[out_word(q * kRun + k, px)];
        T* dst = y + nhwc_dst(n, o0, oy, ox, a.O, a.H, a.W);
        if (a.vec) {  // O % kRun == 0: the run is inside and 16-byte aligned
          store_run(dst, v);
        } else {
          for (int k = 0; k < kRun && o0 + k < a.O; ++k) store1(dst + k, v[k]);
        }
      }
    } else if (oy < a.H) {
      for (int j = lane; j < 8 * kSegs; j += 32) {
        const int cl = j / kSegs, px = (j - cl * kSegs) * kVec;
        const int o = nt * 8 + cl, ox = x0 + px;
        if (o >= a.O || ox >= a.W) continue;
        const float* v = sc + out_word(cl, px);
        T* dst = y + ((static_cast<int64_t>(n) * a.O + o) * a.H + oy) * a.W + ox;
        if (a.vec) {  // W % kVec == 0, so the whole vector is inside
          store_vec(dst, v);
        } else {
          for (int q = 0; q < kVec && ox + q < a.W; ++q) store1(dst + q, v[q]);
        }
      }
    }
    __syncwarp();
  }
}

// ---- the kernels ----------------------------------------------------------------

// Shared memory: two stage buffers (of the layout's stage), the warps'
// epilogue scratch, the weights.
template <bool NHWC>
constexpr int kStage = NHWC ? kNhwcStageWords : kStageWords;
template <bool NHWC>
constexpr int kBufBytes = 2 * kStage<NHWC> * 4;
constexpr int kScratchBytes = kWarps * kOutWords * 4;
template <bool NHWC>
constexpr int kSmemF32 = kBufBytes<NHWC> + kScratchBytes + kMaxStages * 9 * kNTiles * 32 * 16;
template <bool NHWC>
constexpr int kSmemBf16 =
    kBufBytes<NHWC> + kScratchBytes + (kMaxStages / 2) * 9 * kNTiles * 32 * 8;
static_assert(kSmemF32<true> <= 232448, "at most the 227 KB a block can take");

// Block b walks tiles b, b + gridDim.x, ...; item i is stage i % nst of its
// (i / nst)-th tile.
__device__ __forceinline__ int item_tile(int i, int nst) {
  return blockIdx.x + (i / nst) * gridDim.x;
}
__device__ __forceinline__ int block_items(const Args& a) {
  return (a.ntiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x * a.nst;
}

// Stage s of tile t of the input into buf, by cp.async: the NCHW or the NHWC
// staging (float32; NHWC also bfloat16).
template <int Bytes, bool NHWC>
__device__ __forceinline__ void stage_async(const void* x, uint32_t* buf, const Args& a, int t,
                                            int s) {
  if constexpr (NHWC) {
    stage_nhwc<Bytes>(x, buf, a, t, s);
  } else {
    stage_f32(static_cast<const float*>(x), buf, a, t, s);
  }
}

template <bool NHWC>
__global__ void __launch_bounds__(kThreads, 1) conv3x3_lowch_f32_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* bufs = reinterpret_cast<uint32_t*>(smem);
  float* sc =
      reinterpret_cast<float*>(smem + kBufBytes<NHWC>) + (threadIdx.x / 32) * kOutWords;
  float4* wsm = reinterpret_cast<float4*>(smem + kBufBytes<NHWC> + kScratchBytes);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int items = block_items(a);
  if (items <= 0) return;
  stage_async<4, NHWC>(a.x, bufs, a, item_tile(0, a.nst), 0);
  cp_async_commit();
  stage_weights_f32(wsm, a);  // while the first stage is in flight
  Acc acc = {};
  for (int i = 0; i < items; ++i) {
    cp_async_wait_all();
    __syncthreads();  // stage i landed; every warp is done with stage i - 1
    if (i + 1 < items) {
      stage_async<4, NHWC>(a.x, bufs + ((i + 1) & 1) * kStage<NHWC>, a,
                           item_tile(i + 1, a.nst), (i + 1) % a.nst);
      cp_async_commit();
    }
    mma_stage_f32<NHWC>(bufs + (i & 1) * kStage<NHWC>, wsm, i % a.nst, warp, lane, acc);
    if (i % a.nst == a.nst - 1)
      epilogue<float, NHWC>(acc, sc, static_cast<float*>(a.y), a, item_tile(i, a.nst), warp,
                            lane);
  }
}

template <bool NHWC>
__global__ void __launch_bounds__(kThreads, 1) conv3x3_lowch_bf16_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* bufs = reinterpret_cast<uint32_t*>(smem);
  float* sc =
      reinterpret_cast<float*>(smem + kBufBytes<NHWC>) + (threadIdx.x / 32) * kOutWords;
  uint2* wsm = reinterpret_cast<uint2*>(smem + kBufBytes<NHWC> + kScratchBytes);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int items = block_items(a);
  if (items <= 0) return;
  if constexpr (NHWC) {  // the float32 kernel's cp.async pipeline
    stage_async<2, true>(a.x, bufs, a, item_tile(0, a.nst), 0);
    cp_async_commit();
    stage_weights_bf16(wsm, a);
    Acc acc = {};
    for (int i = 0; i < items; ++i) {
      cp_async_wait_all();
      __syncthreads();
      if (i + 1 < items) {
        stage_async<2, true>(a.x, bufs + ((i + 1) & 1) * kNhwcStageWords, a,
                             item_tile(i + 1, a.nst), (i + 1) % a.nst);
        cp_async_commit();
      }
      mma_stage_bf16<true>(bufs + (i & 1) * kNhwcStageWords, wsm, i % a.nst, warp, lane, acc);
      if (i % a.nst == a.nst - 1)
        epilogue<__nv_bfloat16, true>(acc, sc, static_cast<__nv_bfloat16*>(a.y), a,
                                      item_tile(i, a.nst), warp, lane);
    }
    return;
  }
  Bf16Stage st;
  st.load(x, a, item_tile(0, a.nst), 0);
  stage_weights_bf16(wsm, a);
  st.store(x, bufs, a, item_tile(0, a.nst), 0);
  Acc acc = {};
  for (int i = 0; i < items; ++i) {
    const bool next = i + 1 < items;
    const int tn = item_tile(i + 1, a.nst), sn = (i + 1) % a.nst;
    if (next) st.load(x, a, tn, sn);  // in flight during this stage's multiplies
    __syncthreads();  // stage i stored; every warp is done with stage i - 1
    mma_stage_bf16(bufs + (i & 1) * kStageWords, wsm, i % a.nst, warp, lane, acc);
    if (i % a.nst == a.nst - 1)
      epilogue<__nv_bfloat16, false>(acc, sc, static_cast<__nv_bfloat16*>(a.y), a,
                                     item_tile(i, a.nst), warp, lane);
    if (next) st.store(x, bufs + ((i + 1) & 1) * kStageWords, a, tn, sn);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int dev, bool* done) {
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done[dev] = e == cudaSuccess;
  return e;
}

}  // namespace

// x: contiguous NCHW [n, c, h + 2 * halo, w] (dtype 0 = float32, 1 =
// bfloat16); w: contiguous float32 OIHW [o, c, 3, 3]; y: contiguous [n, o, h,
// w] of x's dtype.  halo 0: pad 1 on all sides; halo 1 (a slab of an
// H-sharded plane with a row of each neighbour's above and below): output
// row i reads input rows i..i+2, pad 1 in W only.  nhwc = 1: x and y are
// channels-last instead, [n, h + 2 * halo, w, c] and [n, h, w, o] in memory,
// 4-byte aligned (bfloat16: c even).  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments outside the kernel's range.
extern "C" int shgan_conv3x3_lowch(const void* x, const float* w, void* y, int dtype, int n,
                                   int c, int o, int h, int wd, int halo, int nhwc,
                                   void* stream) {
  if (c < 1 || c > kMaxC || o < 1 || o > kMaxO || h < 1 || wd < 1 || n < 0 ||
      (halo != 0 && halo != 1) || (dtype != 0 && dtype != 1) ||
      (nhwc && dtype == 1 && c % 2) || (nhwc && reinterpret_cast<uintptr_t>(x) % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int tiles_x = (wd + kTileW - 1) / kTileW, tiles_y = (h + kTileH - 1) / kTileH;
  const int64_t ntiles = static_cast<int64_t>(n) * tiles_x * tiles_y;
  if (ntiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vec_px = dtype == 0 ? 4 : 8;
  // vec: NCHW, W a multiple of a 16-byte access; NHWC, O a multiple of a
  // 16-byte run of channels; and x, y 16-byte aligned
  Args a{x, w, y, c, o, h, wd, tiles_x, tiles_y, static_cast<int>(ntiles),
         stages_for(c, dtype == 0 ? Io<4>::kStageCh : Io<2>::kStageCh),
         (nhwc ? o % vec_px == 0 : wd % vec_px == 0) &&
             reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(y) % 16 == 0,
         halo,
         nhwc && (c * (dtype == 0 ? 4 : 2)) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(x) % 16 == 0};
  const int grid = static_cast<int>(ntiles < sms ? ntiles : sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool ready[2][2][64] = {};  // [dtype][nhwc][device]
  bool* done = ready[dtype][nhwc ? 1 : 0];
  if (dtype == 0) {
    auto* k = nhwc ? conv3x3_lowch_f32_kernel<true> : conv3x3_lowch_f32_kernel<false>;
    const int bytes = nhwc ? kSmemF32<true> : kSmemF32<false>;
    e = allow_smem(k, bytes, dev, done);
    if (e != cudaSuccess) return static_cast<int>(e);
    k<<<grid, kThreads, bytes, s>>>(a);
  } else {
    auto* k = nhwc ? conv3x3_lowch_bf16_kernel<true> : conv3x3_lowch_bf16_kernel<false>;
    const int bytes = nhwc ? kSmemBf16<true> : kSmemBf16<false>;
    e = allow_smem(k, bytes, dev, done);
    if (e != cudaSuccess) return static_cast<int>(e);
    k<<<grid, kThreads, bytes, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
