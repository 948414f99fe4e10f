// Tiling, staging, fragment ownership and TF32 split of the low-channel 3x3
// convolution (kernel K3), shared by the CUDA kernel (conv3x3_lowch.cu) and
// the host harness of tests/test_torch_kernel_math.py.
//
// Contract: y[n,o,i,j] = sum_{c,dy,dx} w[o,c,dy,dx] * x[n,c,i+dy-1,j+dx-1]
// (correlation, stride 1, zero padding 1), NCHW in and out, or NHWC in and
// out (channels-last tensors), C, O <= 32.
//
// Implicit GEMM: M = output pixels, N = 32 output channels, K = 9*C ordered
// (stage s, tap dy*3+dx, channel slot).  A tile is kTileH output rows x
// kTileW pixels of one image; warp w owns tile row w: kMTiles m16 tiles of 16
// consecutive pixels, times kNTiles n8 tiles of output channels.
//
// Staging: a stage holds kSlots 32-bit channel slots of the input tile with
// its 1-pixel halo: float32 puts one channel in a slot (8 channels a stage,
// one m16n8k8 TF32 step per tap), bfloat16 an interleaved pair (2c, 2c+1)
// (16 channels a stage, one m16n8k16 step per tap), so one 32-bit shared load
// yields a fragment register either way.  Staged pixel ix (0 = x0 - 1) of
// tile row iy sits at word kLead + ix of its row: the interior (ix >= 1)
// starts 16-byte aligned.  The slot planes are kPlane words apart, kPlane = 24
// (mod 32), so the 8 x 4 lanes of an A-fragment load (pixel = lane / 4, slot
// = lane % 4) fall on 32 distinct banks.
//
// NHWC: a pixel's channels are contiguous, and a stage's kSlots slots of one
// pixel are its 32 bytes of channels [s * kStageCh, (s + 1) * kStageCh): a
// float32 channel or a bfloat16 pair (2c, 2c + 1) is already the 32-bit word
// its slot holds.  So the NHWC stage is pixel-major: staged pixel (iy, ix)
// keeps its kSlots words together (nhwc_word), kNhwcPitch = 12 words apart,
// so the 8 pixels x 4 slots of an A-fragment load fall on 32 distinct banks
// (12 g mod 32 for g < 8 are 8 distinct multiples of 4) while a lane's
// address stays linear in its pixel.  A pixel's two halves of
// 4 slots are two 16-byte copies (nhwc_chunk_item) where a pixel's channels
// are a multiple of 16 bytes, else 4-byte copies a slot (nhwc_item).  The
// multiplies read the words the NCHW stage holds, through nhwc_a_word, so
// the two layouts give the same bits.  The epilogue writes each output
// pixel's channels of an n8 tile as 16-byte runs.
#pragma once

#include <cstdint>
#include <cstring>

#if defined(__CUDACC__)
#define SHGAN_HD __host__ __device__ __forceinline__
#else
#define SHGAN_HD inline
#endif

namespace shgan {
namespace conv3 {

constexpr int kMaxC = 32;
constexpr int kMaxO = 32;
constexpr int kTileH = 16;               // output rows per tile, one per warp
constexpr int kTileW = 64;               // output pixels per tile row
constexpr int kWarps = kTileH;
constexpr int kThreads = 32 * kWarps;    // 512
constexpr int kMTiles = kTileW / 16;     // m16 tiles per warp
constexpr int kNTiles = kMaxO / 8;       // n8 tiles
constexpr int kSlots = 8;                // 32-bit channel slots per stage
constexpr int kInH = kTileH + 2;         // staged rows
constexpr int kInW = kTileW + 2;         // staged pixels per row
constexpr int kLead = 3;                 // word of staged pixel ix = 0
constexpr int kRow = 72;                 // words per staged row
constexpr int kPlane = 1304;             // words per slot plane
constexpr int kStageWords = kSlots * kPlane;
constexpr int kOutPitch = 68;            // epilogue scratch: words per channel
constexpr int kOutWords = 8 * kOutPitch; // per warp: one n8 tile of channels
constexpr int kMaxStages = kMaxC / 8;    // float32: 8 channels a stage

static_assert(kLead + kInW <= kRow, "a staged row must fit its pitch");
static_assert((kLead + 1) % 4 == 0 && kRow % 4 == 0, "interior 16-byte aligned");
static_assert(kPlane >= kInH * kRow && kPlane % 4 == 0, "slot plane pitch");
static_assert(kPlane % 32 == 8 || kPlane % 32 == 24, "A loads conflict-free");
static_assert(kOutPitch % 16 == 4, "epilogue writes conflict-free, rows aligned");

// Channels per slot: 1 for float32, 2 for bfloat16.
template <int Bytes>
struct Io {
  static constexpr int kPerSlot = 4 / Bytes;
  static constexpr int kStageCh = kSlots * kPerSlot;  // channels per stage
  static constexpr int kVec = 16 / Bytes;             // pixels per 16-byte access
};

SHGAN_HD int stages_for(int C, int stage_ch) { return (C + stage_ch - 1) / stage_ch; }

// Tile t of an [n, H, W] output with tiles_x x tiles_y tiles an image, x fastest.
SHGAN_HD void tile_origin(int t, int tiles_x, int tiles_y, int* n, int* y0, int* x0) {
  const int per_image = tiles_x * tiles_y;
  *n = t / per_image;
  const int r = t - *n * per_image;
  *y0 = (r / tiles_x) * kTileH;
  *x0 = (r % tiles_x) * kTileW;
}

// Word offset of staged (slot, tile row iy, pixel ix) in a stage buffer; it
// holds input pixel (y0 - 1 + iy, x0 - 1 + ix), zero outside the image.
SHGAN_HD int staged_word(int slot, int iy, int ix) { return slot * kPlane + iy * kRow + kLead + ix; }
SHGAN_HD bool inside(int c, int sy, int sx, int C, int H, int W) {
  return c < C && sy >= 0 && sy < H && sx >= 0 && sx < W;
}

// Staging work items of a stage, decoded to (slot, iy, ix) of the first
// staged pixel:
// * 16-byte path: item j copies `px` consecutive interior pixels (4 float32
//   or 8 bfloat16), kSlots * kInH * (kTileW / px) items, ix = 1 + px * k;
// * halo columns: item j < kSlots * kInH * 2 is one pixel, ix = 0 or kInW - 1;
// * pixel path (W or a pointer off 16 bytes): item j < kSlots * kInH * kInW
//   is one pixel.
SHGAN_HD void vec_item(int j, int px, int* slot, int* iy, int* ix) {
  const int groups = kTileW / px;
  *slot = j / (kInH * groups);
  const int r = j - *slot * (kInH * groups);
  *iy = r / groups;
  *ix = 1 + px * (r - *iy * groups);
}
SHGAN_HD void halo_item(int j, int* slot, int* iy, int* ix) {
  *slot = j / (kInH * 2);
  *iy = (j >> 1) - *slot * kInH;
  *ix = (j & 1) ? kInW - 1 : 0;
}
SHGAN_HD void pixel_item(int j, int* slot, int* iy, int* ix) {
  *slot = j / (kInH * kInW);
  const int r = j - *slot * (kInH * kInW);
  *iy = r / kInW;
  *ix = r - *iy * kInW;
}

// NHWC stage word of (slot, staged row iy, staged pixel ix).
constexpr int kNhwcPitch = 12;  // words a staged pixel: its kSlots, then 4 unused
constexpr int kNhwcStageWords = kInH * kInW * kNhwcPitch;
static_assert(kNhwcPitch >= kSlots && kNhwcPitch % 4 == 0, "16-byte halves");
SHGAN_HD int nhwc_word(int slot, int iy, int ix) {
  return (iy * kInW + ix) * kNhwcPitch + slot;
}

// NHWC staging item j (j < kSlots * kInH * kInW) -> slot, staged row iy and
// pixel ix, slots fastest (the 4-byte copies).
SHGAN_HD void nhwc_item(int j, int* slot, int* iy, int* ix) {
  *slot = j % kSlots;
  const int r = j / kSlots;
  *iy = r / kInW;
  *ix = r - *iy * kInW;
}

// NHWC 16-byte staging item j (j < 2 * kInH * kInW) -> staged row iy, pixel
// ix and half h: slots [4h, 4h + 4), halves fastest: the words
// nhwc_word(4h, iy, ix)... are contiguous and 16-byte aligned.
SHGAN_HD void nhwc_chunk_item(int j, int* iy, int* ix, int* h) {
  *h = j & 1;
  const int r = j >> 1;
  *iy = r / kInW;
  *ix = r - *iy * kInW;
}

// Element offset of channel c of input pixel (sy, sx) (sy in the output's
// rows: the halo rows are -halo and H + halo - 1) of image n of an NHWC
// [n, H + 2 halo, W, C] tensor.
SHGAN_HD long long nhwc_src(int n, int c, int sy, int sx, int C, int H, int W, int halo) {
  return ((static_cast<long long>(n) * (H + 2 * halo) + sy + halo) * W + sx) * C + c;
}

// Element offset of channel o of output pixel (oy, ox) of image n of an NHWC
// [n, H, W, O] tensor.
SHGAN_HD long long nhwc_dst(int n, int o, int oy, int ox, int O, int H, int W) {
  return ((static_cast<long long>(n) * H + oy) * W + ox) * O + o;
}

// bfloat16 interleave: from words e (channel c) and o (channel c + 1), each
// holding two pixels (low half first), the (c, c+1) words of the first and
// the second pixel; the lower K index sits in the low half, as mma takes it.
SHGAN_HD uint32_t pair_first(uint32_t e, uint32_t o) { return (e & 0xffffu) | (o << 16); }
SHGAN_HD uint32_t pair_second(uint32_t e, uint32_t o) { return (e >> 16) | (o & 0xffff0000u); }

// Fragment ownership (PTX mma.sync m16n8k8 .tf32 and m16n8k16 .bf16, row.col;
// g = lane / 4, q = lane % 4).  A register r (0..3) holds M row g + 8*(r&1)
// and the K slot q + 4*(r>>1); B register r (0..1) the K slot q + 4*r and N
// column g; C register r (0..3) M row g + 8*(r>>1) and N column 2q + (r&1).
// A K slot is one channel (float32) or a channel pair (bfloat16).
SHGAN_HD int a_row(int lane, int r) { return (lane >> 2) + 8 * (r & 1); }
SHGAN_HD int a_slot(int lane, int r) { return (lane & 3) + 4 * (r >> 1); }
SHGAN_HD int b_slot(int lane, int r) { return (lane & 3) + 4 * r; }
SHGAN_HD int b_col(int lane) { return lane >> 2; }
SHGAN_HD int c_row(int lane, int r) { return (lane >> 2) + 8 * (r >> 1); }
SHGAN_HD int c_col(int lane, int r) { return 2 * (lane & 3) + (r & 1); }

// Shared word that lane `lane` loads into A register r for warp `warp`'s m16
// tile mt at tap (dy, dx): output pixel (warp, 16*mt + a_row) reads staged
// pixel (warp + dy, 16*mt + a_row + dx).
SHGAN_HD int a_word(int lane, int r, int warp, int mt, int dy, int dx) {
  return staged_word(a_slot(lane, r), warp + dy, 16 * mt + a_row(lane, r) + dx);
}

// The word lane `lane` loads into A register r (as a_word) from an NHWC stage.
SHGAN_HD int nhwc_a_word(int lane, int r, int warp, int mt, int dy, int dx) {
  return nhwc_word(a_slot(lane, r), warp + dy, 16 * mt + a_row(lane, r) + dx);
}

// Weight fragments are staged in the order the lanes read them: entry
// (stage s, tap, n tile nt, lane) holds B registers 0 and 1 (float32: their
// TF32 high parts, then their residuals).
SHGAN_HD int wfrag_index(int s, int tap, int nt, int lane) {
  return ((s * 9 + tap) * kNTiles + nt) * 32 + lane;
}

// Offset of w[o][c][dy][dx] in the OIHW weight.
SHGAN_HD int weight_offset(int o, int c, int dy, int dx, int C) {
  return ((o * C + c) * 3 + dy) * 3 + dx;
}

// Channel of K slot `slot` (half h of a bfloat16 pair) in stage s.
template <int Bytes>
SHGAN_HD int slot_channel(int s, int slot, int h) {
  return s * Io<Bytes>::kStageCh + slot * Io<Bytes>::kPerSlot + h;
}

// Round to TF32 (10 mantissa bits, nearest, ties away from zero): the
// device's cvt.rna.tf32.f32, and the same on the host.
SHGAN_HD float tf32_rna(float v) {
#if defined(__CUDA_ARCH__)
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
#else
  uint32_t u;
  std::memcpy(&u, &v, 4);
  if ((u & 0x7f800000u) != 0x7f800000u) u += 0x1000u;
  u &= 0xffffe000u;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
#endif
}

// 3xTF32: v = hi + lo with both TF32; a*b ~ a_hi*b_hi + a_hi*b_lo + a_lo*b_hi
// keeps ~float32 accuracy (the a_lo*b_lo term is below float32's rounding).
// The weights' split, done once per block as they are staged.
SHGAN_HD void split_tf32(float v, float* hi, float* lo) {
  *hi = tf32_rna(v);
  *lo = tf32_rna(v - *hi);
}

// The mma loop's split of an A operand (the input, split on every fragment
// load): hi is v rounded to TF32 as tf32_rna rounds it (for finite v), by two
// integer operations instead of a cvt; lo = v - hi, exact in float32, goes to
// the mma as it is: the tensor core reads the top 19 bits of a .tf32
// operand, so lo enters truncated to TF32.  The weights are
// split once, with split_tf32.
SHGAN_HD void split_tf32_a(float v, float* hi, float* lo) {
  uint32_t u;
#if defined(__CUDA_ARCH__)
  u = __float_as_uint(v);
  *hi = __uint_as_float((u + 0x1000u) & 0xffffe000u);
#else
  std::memcpy(&u, &v, 4);
  u = (u + 0x1000u) & 0xffffe000u;
  std::memcpy(hi, &u, 4);
#endif
  *lo = v - *hi;
}

// Epilogue scratch word of output (M row m of the warp's tile row, channel
// cl of the current n8 tile).
SHGAN_HD int out_word(int cl, int m) { return cl * kOutPitch + m; }

}  // namespace conv3
}  // namespace shgan
