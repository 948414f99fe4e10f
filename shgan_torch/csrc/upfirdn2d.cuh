// Index, padding and tiling arithmetic of the upfirdn2d contract, shared by
// the CUDA kernels (upfirdn2d.cu) and the host harness of
// tests/test_torch_kernel_math.py.
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
#define SHGAN_UNROLL _Pragma("unroll")
#else
#define SHGAN_HD inline
#define SHGAN_UNROLL
#endif

namespace shgan {

constexpr int kMaxTaps = 8;
// Generic path (any up/down in {1, 2}): one thread per output, blocks of
// kBlockW x kBlockH threads.
constexpr int kBlockW = 32;
constexpr int kBlockH = 8;

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

// ---- Tiled path (up = down = 1) -------------------------------------------
//
// A block of kFirThreads threads walks work items; an item is a GW x GH
// output tile of each of kPlanes consecutive planes (a "plane group").  Thread
// t owns kCols adjacent columns and a strip of kStrip output rows of one plane
// of the group (fir_thread).  The item's input, a (GH + fh - 1) x (GW + fw - 1)
// window per plane (element (iy, cc) = input (ty0 - pady0 + iy, x0 + cc),
// x0 = tx0 - padx0, zero outside the plane), is fetched in 16-byte chunks (4
// float32 or 8 bfloat16) from the chunk boundary at or below each row's first
// element, so every load is aligned whatever W and the pads are.  A staged
// row holds its chunks as they come, as float: chunk q at float q * vec, so
// window element cc sits at cc + shift, shift = the row start's offset in its
// chunk (fir_row_shift), and each chunk is stored with 16-byte stores.  Only
// a chunk that crosses the plane row's ends is masked, in registers.
//
// Modes: 0 = 64 x 64 tiles, one plane an item; 1 = 32 x 32, four planes;
// 2 = 16 x 16, sixteen planes (fir_tile_mode).
constexpr int kFirThreads = 256;
constexpr int kStrip = 8;  // output rows per thread
constexpr int kCols = 2;   // adjacent output columns per thread

template <int GW, int GH>
struct FirMode {
  static constexpr int kGroupThreads = (GW / kCols) * (GH / kStrip);
  static constexpr int kPlanes = kFirThreads / kGroupThreads;
  static_assert(kPlanes * kGroupThreads == kFirThreads, "whole groups");
};

// Chunks per staged row: enough to cover tw columns from any offset in the
// first chunk; the elements a staged row takes for taps up to `taps` wide.
SHGAN_HD constexpr int fir_chunks(int tw, int vec) { return (tw + 2 * vec - 2) / vec; }
SHGAN_HD constexpr int fir_row_elems(int gw, int taps, int vec) {
  return fir_chunks(gw + taps - 1, vec) * vec;
}

constexpr int kFirModes = 3;
SHGAN_HD int fir_mode_w(int mode) { return 64 >> mode; }
// Cost of one work item in staged elements: its fixed share of index
// arithmetic and barriers (fitted to the card's times of the main path's
// FIR calls under each mode).
constexpr int kFirItemCost = 800;

// The mode that stages the fewest input elements for one out_h x out_w plane
// (the windows of its tiles, clipped to the plane, fir_window) plus a fixed
// cost per item; the larger tile on a tie.
SHGAN_HD int fir_tile_mode(int out_h, int out_w, int fh, int fw) {
  int best = 0;
  long long best_cost = -1;
  for (int m = 0; m < kFirModes; ++m) {
    const int g = fir_mode_w(m), ty = (out_h + g - 1) / g, tx = (out_w + g - 1) / g;
    const int planes = kFirThreads / ((g / kCols) * (g / kStrip));
    const long long cost =
        static_cast<long long>(out_h + ty * (fh - 1)) * (out_w + tx * (fw - 1)) +
        static_cast<long long>(ty) * tx * kFirItemCost / planes;
    if (best_cost < 0 || cost < best_cost) {
      best = m;
      best_cost = cost;
    }
  }
  return best;
}

// Floor of v / d, for d > 0 and v of either sign.
SHGAN_HD long long floor_div(long long v, int d) {
  const long long q = v / d;
  return (v % d != 0 && v < 0) ? q - 1 : q;
}

// Item `item` -> plane group g, tile origin (ty0, tx0); tiles x fastest.
SHGAN_HD void fir_item(int item, int tiles_x, int tiles_y, int gw, int gh, int* g, int* ty0,
                       int* tx0) {
  const int per_group = tiles_x * tiles_y;
  *g = item / per_group;
  const int r = item - *g * per_group;
  *ty0 = (r / tiles_x) * gh;
  *tx0 = (r % tiles_x) * gw;
}

// Extent of an item's staged window along one axis: the input that its
// outputs in [o0, min(o0 + g, out)) read.  Rows and columns beyond it are
// neither loaded nor staged, so an item at the ragged edge (the encoder's
// R + 1 outputs leave one row and one column of items with one output row or
// column) costs little.
SHGAN_HD int fir_window(int o0, int out, int g, int taps) {
  return (out - o0 < g ? out - o0 : g) + taps - 1;
}

// Thread t -> plane slot k of the group, strip s, first column c (even).
SHGAN_HD void fir_thread(int t, int gw, int gh, int* k, int* s, int* c) {
  const int pairs = gw / kCols, group = pairs * (gh / kStrip);
  *k = t / group;
  const int r = t - *k * group;
  *s = r / pairs;
  *c = (r - *s * pairs) * kCols;
}

// Staging role j of an item (j < kPlanes * th * nch) -> plane slot k, staged
// row iy, chunk q of that row.
SHGAN_HD void fir_stage_role(int j, int th, int nch, int* k, int* iy, int* q) {
  *k = j / (th * nch);
  const int r = j - *k * (th * nch);
  *iy = r / nch;
  *q = r - *iy * nch;
}

// A staged row whose window starts at flat index `start` (row base + x0):
// its first element's offset in its chunk; chunk q's flat index (a multiple
// of vec) and window column (negative for elements before the window).
SHGAN_HD int fir_row_shift(long long start, int vec) {
  return static_cast<int>(start - floor_div(start, vec) * vec);
}
// Index of window element (r, c) in a plane's staged rows of row_e elements
// each, when window row 0 starts s0 = fir_row_shift(..) into its chunk: row
// r starts (s0 + r * w) mod vec into its own (vec a power of two).
SHGAN_HD int fir_staged_pos(int r, int c, int row_e, int s0, int w, int vec) {
  return r * row_e + c + ((s0 + r * (w & (vec - 1))) & (vec - 1));
}
SHGAN_HD long long fir_chunk_at(long long start, int q, int vec) {
  return floor_div(start, vec) * vec + static_cast<long long>(q) * vec;
}
SHGAN_HD int fir_chunk_col(long long start, int q, int vec) {
  return static_cast<int>(fir_chunk_at(start, q, vec) - start);
}

// Whether chunk element columns [cc0, cc0 + vec) of the window meet the
// plane row (input columns x0 + cc in [0, w)) and the window [0, tw): the
// chunk is loaded only then, so a chunk read from memory always holds an
// element of the tensor.  A chunk with cc0 >= tw is not staged at all.
SHGAN_HD bool fir_chunk_needed(int cc0, int vec, int x0, int w, int tw) {
  const int lo = cc0 > -x0 ? cc0 : -x0;                      // max(cc0, -x0)
  const int hi = cc0 + vec < w - x0 ? cc0 + vec : w - x0;    // min(.., w - x0)
  return lo < hi && cc0 + vec > 0 && cc0 < tw;
}

// Whether element cc is inside the plane row (else it is staged as zero); a
// chunk wholly inside is staged without per-element tests.
SHGAN_HD bool fir_col_in_row(int cc, int x0, int w) { return x0 + cc >= 0 && x0 + cc < w; }
SHGAN_HD bool fir_chunk_in_row(int cc0, int vec, int x0, int w) {
  return x0 + cc0 >= 0 && x0 + cc0 + vec <= w;
}

// The kStrip x kCols outputs of a thread from the staged window:
// out[r][u] = sum_{i,j} taps[i][j] * window(r0 + r + i, c + u + j).  The
// fixed-size version slides an FH-row window of FW + kCols - 1 values down
// the strip in registers, so each staged row is read once per strip;
// `row(r, c, v)` fills v[0..N) with window(r, c .. c + N).
template <int FH, int FW, typename Row>
SHGAN_HD void fir_strip_fixed(const Row& row, const float* taps, int r0, int c,
                              float (&out)[kStrip][kCols]) {
  constexpr int N = FW + kCols - 1;
  float win[FH][N];
  SHGAN_UNROLL
  for (int i = 0; i < FH - 1; ++i) row(r0 + i, c, win[i]);
  SHGAN_UNROLL
  for (int r = 0; r < kStrip; ++r) {
    row(r0 + r + FH - 1, c, win[FH - 1]);
    SHGAN_UNROLL
    for (int u = 0; u < kCols; ++u) {
      float acc = 0.0f;
      SHGAN_UNROLL
      for (int i = 0; i < FH; ++i)
        SHGAN_UNROLL
        for (int j = 0; j < FW; ++j) acc += taps[i * FW + j] * win[i][u + j];
      out[r][u] = acc;
    }
    SHGAN_UNROLL
    for (int i = 0; i < FH - 1; ++i)
      SHGAN_UNROLL
      for (int j = 0; j < N; ++j) win[i][j] = win[i + 1][j];
  }
}

// Any fh, fw: `at(r, c)` reads one staged value.
template <typename At>
SHGAN_HD void fir_strip(const At& at, const float* taps, int fh, int fw, int r0, int c,
                        float (&out)[kStrip][kCols]) {
  for (int r = 0; r < kStrip; ++r)
    for (int u = 0; u < kCols; ++u) {
      float acc = 0.0f;
      for (int i = 0; i < fh; ++i)
        for (int j = 0; j < fw; ++j) acc += taps[i * fw + j] * at(r0 + r + i, c + u + j);
      out[r][u] = acc;
    }
}

// ---- Tiled resampling paths (down = 2 or up = 2, the other factor 1) -----
//
// The same persistent grid, work items, 16-byte chunk staging and register
// prefetch as the stride-1 path above; what differs is the window an output
// tile stages and how the threads read it.
//
// down = 2: output (oy, ox) reads input rows 2 * oy - pady0 + i and columns
// 2 * ox - padx0 + j.  An output tile GW x GH stages a (2 GH + fh - 2) x
// (2 GW + fw - 2) window.  Each staged row is stored split by the parity of
// its staged position (fir_split_pos): the even positions, then the odd
// ones, each half row_e / 2 floats.  A thread owns one output column and a
// strip of kDownStrip output rows; the two taps of one parity in a row are
// then consecutive words of one half, and neighbouring threads read
// neighbouring words (no bank conflicts).  Consecutive output rows share
// fh - 2 of their staged rows, so the strip slides down two rows at a time.
//
// up = 2 (polyphase): along one axis, output o = o0 + 2 a + p (o0 even,
// phase p in {0, 1}) takes the taps t = t_p + 2 m, t_p = (pad0 - p) mod 2,
// which meet input samples o0 / 2 - floor(pad0 / 2) + a + r_p + m
// (fir_up_phase).  An output tile stages a (GH / 2 + reach_y) x (GW / 2 +
// reach_x) input window, reach = max_p (r_p + n_p - 1) (fir_up_reach).  A
// thread owns kUpQuads adjacent quads (2 x 2 outputs, one of each phase) on
// each of kUpStrip quad rows: with 4x4 taps and even pads, a quad reads a
// 3 x 3 input neighbourhood, each phase its own 2 x 2 subset of the taps
// (fir_up_quads_fixed4), and each output row of the thread's quads is
// 2 * kUpQuads consecutive outputs, written with one 16-byte (float32) or
// 8-byte (bf16) store.
//
// Modes (fir_resample_mode): square output tiles of side fir_resample_g,
// one plane, four or sixteen planes an item.
constexpr int kRouteGeneric = 0;  // upfirdn2d_kernel: one thread an output
constexpr int kRouteTile = 1;     // up = down = 1
constexpr int kRouteDown2 = 2;    // down = 2, up = 1
constexpr int kRouteUp2 = 3;      // up = 2, down = 1

// The kernel a call takes.  The tiled paths' 16-byte loads need a 16-byte
// aligned tensor; other factor pairs (up = down = 2, or one axis only) take
// the generic kernel.
SHGAN_HD int fir_route(int upx, int upy, int downx, int downy, bool aligned16) {
  if (!aligned16) return kRouteGeneric;
  if (upx == 1 && upy == 1 && downx == 1 && downy == 1) return kRouteTile;
  if (upx == 1 && upy == 1 && downx == 2 && downy == 2) return kRouteDown2;
  if (upx == 2 && upy == 2 && downx == 1 && downy == 1) return kRouteUp2;
  return kRouteGeneric;
}

constexpr int kDownStrip = 4;  // output rows of a thread (one column), down = 2
constexpr int kUpStrip = 2;    // quad rows of a thread, up = 2
constexpr int kUpQuads = 2;    // adjacent quads of a thread, up = 2

// Output tile side of mode m: 32, 16, 8 (down = 2); 64, 32, 16 (up = 2).
SHGAN_HD constexpr int fir_resample_g(bool up, int m) { return (up ? 64 : 32) >> m; }

template <bool UP, int G>
struct ResampleMode {
  static constexpr int kGroupThreads =
      UP ? (G / (2 * kUpQuads)) * (G / (2 * kUpStrip)) : G * (G / kDownStrip);
  static constexpr int kPlanes = kFirThreads / kGroupThreads;
  static_assert(kPlanes * kGroupThreads == kFirThreads, "whole groups");
};

// The taps of phase p (up = 2) along one axis with pad0 and `taps` taps:
// first tap t, its input offset r in the staged window (in quads), count n.
SHGAN_HD void fir_up_phase(int pad0, int p, int taps, int* t, int* r, int* n) {
  *t = (pad0 - p) & 1;
  *r = (p - pad0 + *t) / 2 + static_cast<int>(floor_div(pad0, 2));  // exact
  *n = (taps - *t + 1) >> 1;
}

// Staged input samples beyond a tile's quads along one axis (up = 2).
SHGAN_HD int fir_up_reach(int pad0, int taps) {
  int reach = 0;
  for (int p = 0; p < 2; ++p) {
    int t, r, n;
    fir_up_phase(pad0, p, taps, &t, &r, &n);
    if (r + n - 1 > reach) reach = r + n - 1;
  }
  return reach;
}

// Input sample of staged window element 0 of the tile at output o0, and the
// window's extent for the tile's outputs [o0, min(o0 + g, out)): clipped to
// them, as fir_window is.
SHGAN_HD int fir_resample_start(bool up, int o0, int pad0) {
  return up ? o0 / 2 - static_cast<int>(floor_div(pad0, 2)) : 2 * o0 - pad0;
}
SHGAN_HD int fir_resample_window(bool up, int o0, int out, int g, int taps, int pad0) {
  const int n = out - o0 < g ? out - o0 : g;
  return up ? (n + 1) / 2 + fir_up_reach(pad0, taps) : 2 * n + taps - 2;
}
// The most a tile of side g stages along one axis, for taps up to `taps`.
SHGAN_HD constexpr int fir_resample_extent(bool up, int g, int taps) {
  return up ? g / 2 + (taps + 1) / 2 : 2 * g + taps - 2;
}

// The mode that stages the fewest input elements for one out_h x out_w
// plane plus a fixed cost per item (kFirItemCost staged elements, shared
// among the item's planes); the larger tile on a tie.
SHGAN_HD int fir_resample_mode(bool up, int out_h, int out_w, int fh, int fw, int padx0,
                               int pady0) {
  int best = 0;
  long long best_cost = -1;
  for (int m = 0; m < kFirModes; ++m) {
    const int g = fir_resample_g(up, m), ty = (out_h + g - 1) / g, tx = (out_w + g - 1) / g;
    const int planes = kFirThreads / (up ? (g / (2 * kUpQuads)) * (g / (2 * kUpStrip))
                                          : g * (g / kDownStrip));
    long long rows = 0, cols = 0;
    for (int i = 0; i < ty; ++i) rows += fir_resample_window(up, i * g, out_h, g, fh, pady0);
    for (int i = 0; i < tx; ++i) cols += fir_resample_window(up, i * g, out_w, g, fw, padx0);
    const long long cost = rows * cols + static_cast<long long>(ty) * tx * kFirItemCost / planes;
    if (best_cost < 0 || cost < best_cost) {
      best = m;
      best_cost = cost;
    }
  }
  return best;
}

// Whether a resampling call takes the unrolled 4x4 code; other taps (up to
// kMaxTaps), and up = 2 with an odd pad0 (its phases take other tap
// subsets), take the general tap loop of the same kernel.
SHGAN_HD bool fir_resample_fixed(bool up, int fh, int fw, int padx0, int pady0) {
  return fh == 4 && fw == 4 && (!up || ((padx0 & 1) == 0 && (pady0 & 1) == 0));
}

// Thread t -> plane slot k, strip s, column c (down = 2: the output column;
// up = 2: the first of its kUpQuads quad columns).
SHGAN_HD void fir_down_thread(int t, int g, int* k, int* s, int* c) {
  const int group = g * (g / kDownStrip);
  *k = t / group;
  const int r = t - *k * group;
  *s = r / g;
  *c = r - *s * g;
}
SHGAN_HD void fir_up_thread(int t, int g, int* k, int* s, int* c) {
  const int pairs = g / (2 * kUpQuads), group = pairs * (g / (2 * kUpStrip));
  *k = t / group;
  const int r = t - *k * group;
  *s = r / pairs;
  *c = (r - *s * pairs) * kUpQuads;
}

// down = 2: index of window element (r, c) in a plane's staged rows of
// row_e floats each, split by parity: the element's staged position p = c +
// the row's shift (as in fir_staged_pos) goes to half p & 1 at p >> 1.
SHGAN_HD int fir_split_pos(int r, int c, int row_e, int s0, int w, int vec) {
  const int p = c + ((s0 + r * (w & (vec - 1))) & (vec - 1));
  return r * row_e + (p & 1) * (row_e >> 1) + (p >> 1);
}
// Where element e of staged chunk q lands in its split row.
SHGAN_HD int fir_split_chunk(int q, int e, int row_e, int vec) {
  return (e & 1) * (row_e >> 1) + ((q * vec + e) >> 1);
}
// v[j] = window(r, 2 c + j), j < FW, from the split rows at `win`: the even
// j from one half, the odd j from the other (which is which: the parity of
// the row's shift), each at consecutive words.
template <int FW>
SHGAN_HD void fir_down_row(const float* win, int r, int c, int row_e, int s0, int w, int vec,
                           float (&v)[FW]) {
  const int sh = (s0 + r * (w & (vec - 1))) & (vec - 1), pi = sh & 1;
  const float* base = win + r * row_e + c + (sh >> 1);
  const float* ev = base + pi * (row_e >> 1);
  const float* od = base + (1 - pi) * (row_e >> 1) + pi;
  SHGAN_UNROLL
  for (int j = 0; j < FW; ++j) v[j] = (j & 1) ? od[j >> 1] : ev[j >> 1];
}

// down = 2, fixed FH x FW taps: the thread's kDownStrip outputs, out[r] =
// sum_{i,j} taps[i][j] * window(r0 + 2 r + i, 2 c + j).  The strip slides
// an FH-row window down two staged rows an output; `row(r, v)` fills v[0..FW)
// with window(r, 2 c .. 2 c + FW).
template <int FH, int FW, typename Row>
SHGAN_HD void fir_down_strip_fixed(const Row& row, const float* taps, int r0,
                                   float (&out)[kDownStrip]) {
  static_assert(FH >= 2, "the window slides two rows an output");
  float win[FH][FW];
  SHGAN_UNROLL
  for (int i = 0; i < FH - 2; ++i) row(r0 + i, win[i]);
  SHGAN_UNROLL
  for (int r = 0; r < kDownStrip; ++r) {
    row(r0 + 2 * r + FH - 2, win[FH - 2]);
    row(r0 + 2 * r + FH - 1, win[FH - 1]);
    float acc = 0.0f;
    SHGAN_UNROLL
    for (int i = 0; i < FH; ++i)
      SHGAN_UNROLL
      for (int j = 0; j < FW; ++j) acc += taps[i * FW + j] * win[i][j];
    out[r] = acc;
    SHGAN_UNROLL
    for (int i = 0; i < FH - 2; ++i)
      SHGAN_UNROLL
      for (int j = 0; j < FW; ++j) win[i][j] = win[i + 2][j];
  }
}

// down = 2, any fh, fw: `at(r, c)` reads one staged value.
template <typename At>
SHGAN_HD void fir_down_strip(const At& at, const float* taps, int fh, int fw, int r0, int c,
                             float (&out)[kDownStrip]) {
  for (int r = 0; r < kDownStrip; ++r) {
    float acc = 0.0f;
    for (int i = 0; i < fh; ++i)
      for (int j = 0; j < fw; ++j) acc += taps[i * fw + j] * at(r0 + 2 * r + i, 2 * c + j);
    out[r] = acc;
  }
}

// up = 2: out[a][py][2 q + px] is output (2 (a0 + a) + py, 2 (c + q) + px) of
// the tile, from staged window elements (a0 + a + r_py + m, c + q + r_px +
// m') times taps (t_py + 2 m, t_px + 2 m').
constexpr int kUpOut = 2 * kUpQuads;  // outputs of a thread's quads in a row

// Fixed 4x4 taps with even pads: t = (0, 1) and r = (0, 1) on both axes, so
// a quad row reads three staged rows and the window slides one staged row a
// quad row; `row(r, v)` fills v[0..kUpQuads + 2) with window(r, c ..).
template <typename Row>
SHGAN_HD void fir_up_quads_fixed4(const Row& row, const float* taps, int a0,
                                  float (&out)[kUpStrip][2][kUpOut]) {
  constexpr int N = kUpQuads + 2;
  float win[3][N];
  row(a0, win[0]);
  row(a0 + 1, win[1]);
  SHGAN_UNROLL
  for (int a = 0; a < kUpStrip; ++a) {
    row(a0 + a + 2, win[2]);
    SHGAN_UNROLL
    for (int py = 0; py < 2; ++py)
      SHGAN_UNROLL
      for (int q = 0; q < kUpQuads; ++q)
        SHGAN_UNROLL
        for (int px = 0; px < 2; ++px) {
          float acc = 0.0f;
          SHGAN_UNROLL
          for (int m = 0; m < 2; ++m)
            SHGAN_UNROLL
            for (int n = 0; n < 2; ++n)
              acc += taps[(py + 2 * m) * 4 + px + 2 * n] * win[py + m][q + px + n];
          out[a][py][2 * q + px] = acc;
        }
    SHGAN_UNROLL
    for (int j = 0; j < N; ++j) {
      win[0][j] = win[1][j];
      win[1][j] = win[2][j];
    }
  }
}

// Any fh, fw and pads: `at(r, c)` reads one staged value.
template <typename At>
SHGAN_HD void fir_up_quads(const At& at, const float* taps, int fh, int fw, int padx0,
                           int pady0, int a0, int c, float (&out)[kUpStrip][2][kUpOut]) {
  for (int py = 0; py < 2; ++py) {
    int ty, ry, ny;
    fir_up_phase(pady0, py, fh, &ty, &ry, &ny);
    for (int px = 0; px < 2; ++px) {
      int tx, rx, nx;
      fir_up_phase(padx0, px, fw, &tx, &rx, &nx);
      for (int a = 0; a < kUpStrip; ++a)
        for (int q = 0; q < kUpQuads; ++q) {
          float acc = 0.0f;
          for (int m = 0; m < ny; ++m)
            for (int n = 0; n < nx; ++n)
              acc += taps[(ty + 2 * m) * fw + tx + 2 * n] *
                     at(a0 + a + ry + m, c + q + rx + n);
          out[a][py][2 * q + px] = acc;
        }
    }
  }
}

// ---- The channels-last (NHWC) map --------------------------------------------
//
// x [N, H, W, C] in memory (a channels-last tensor of logical shape [N, C, H,
// W]); y the same of the output.  The channel is the fastest axis, so the
// planes are not tiled as on the NCHW map: a thread owns `vec` consecutive
// channels (4 where C % 4 == 0 and the pointers allow 16-byte float32 /
// 8-byte bf16 accesses, else 1: the 3-channel skip image) of a strip of
// outputs, and neighbouring threads take neighbouring channel groups of one
// strip, so a warp's load of an input pixel is one contiguous run.  Threads
// are numbered channel group fastest, then strip column, strip row, batch
// row (nhwc_fir_thread).
// * up = down = 1 (every FIR of the main path but the image upsample): a
//   strip is kCols adjacent outputs on each of kStrip rows; the thread slides
//   an FH-row window of FW + kCols - 1 input pixels (zero outside the plane)
//   down the strip in registers, so each input pixel it reads is loaded once
//   a strip, and each output is fir_strip_fixed's (or fir_strip's) sum, term
//   for term.
// * up = 2 with 4x4 taps and even pads (the skip-image upsample): a strip is
//   a 2 x 2 quad of outputs, one of each phase, from the 3 x 3 input pixels
//   around it (nhwc_up2_quad: fir_up_quads_fixed4's sums).
// * anything else (down = 2, other taps or pads, one axis): a strip is one
//   output, its sum upfirdn2d_point's over the taps that meet a sample.
// Either way an output's sum is the NCHW map's, in the same order: the two
// maps give the same bits.
constexpr int kNhwcThreads = 256;
constexpr int kNhwcGeneric = 0;  // upfirdn2d_nhwc_kernel: an output a thread
constexpr int kNhwcTile = 1;     // up = down = 1: strips of kStrip x kCols
constexpr int kNhwcUp2 = 2;      // up = 2, 4x4 taps, even pads: quads

SHGAN_HD int nhwc_fir_route(int upx, int upy, int downx, int downy, int fh, int fw, int padx0,
                            int pady0) {
  if (upx == 1 && upy == 1 && downx == 1 && downy == 1) return kNhwcTile;
  if (upx == 2 && upy == 2 && downx == 1 && downy == 1 && fir_resample_fixed(true, fh, fw, padx0, pady0))
    return kNhwcUp2;
  return kNhwcGeneric;
}

struct NhwcFir {
  int vec;                 // channels an access
  int groups;              // channel groups a pixel: C / vec
  int sw, sh;              // outputs a strip: columns, rows
  int strips_x, strips_y;  // strips of a plane
  long long threads;       // N * strips_y * strips_x * groups
};

SHGAN_HD NhwcFir nhwc_fir_plan(int n, int c, int out_h, int out_w, int vec, int route) {
  NhwcFir P;
  P.vec = vec;
  P.groups = c / vec;
  P.sw = route == kNhwcTile ? kCols : route == kNhwcUp2 ? 2 : 1;
  P.sh = route == kNhwcTile ? kStrip : route == kNhwcUp2 ? 2 : 1;
  P.strips_x = (out_w + P.sw - 1) / P.sw;
  P.strips_y = (out_h + P.sh - 1) / P.sh;
  P.threads = static_cast<long long>(n) * P.strips_y * P.strips_x * P.groups;
  return P;
}

// Thread t -> batch row n, first output row oy0 and column ox0 of its strip,
// first channel ch.  32-bit arithmetic: a launch has fewer than 2^31
// threads (the launch refuses more).
SHGAN_HD void nhwc_fir_thread(const NhwcFir& P, unsigned int t, int* n, int* oy0, int* ox0,
                              int* ch) {
  const unsigned int groups = P.groups, sxn = P.strips_x, syn = P.strips_y;
  const unsigned int g = t % groups;
  unsigned int r = t / groups;
  const unsigned int sx = r % sxn;
  r /= sxn;
  const unsigned int sy = r % syn;
  *n = static_cast<int>(r / syn);
  *oy0 = static_cast<int>(sy) * P.sh;
  *ox0 = static_cast<int>(sx) * P.sw;
  *ch = static_cast<int>(g) * P.vec;
}

// Element offset of (row n, pixel (py, px), channel ch) of an NHWC tensor.
SHGAN_HD long long nhwc_offset(int n, int py, int px, int ch, int h, int w, int c) {
  return ((static_cast<long long>(n) * h + py) * w + px) * c + ch;
}

// The stride-1 thread body: the strip of outputs (oy0.., ox0..) of V
// channels, its window's first input pixel (iy0, ix0) = (oy0 - pady0, ox0 -
// padx0).  `pixel(sy, sx, v)` fills v with the V channels of input pixel
// (sy, sx), zero outside the plane; `put(oy, ox, v)` stores an output's V
// channels.  Fixed K x K taps: an FH-row window of K + kCols - 1 pixels
// slides down the strip, each output row loading one new window row, and an
// output is fir_strip_fixed's sum, term for term.
template <int K, int V, typename Pixel, typename Put>
SHGAN_HD void nhwc_fir_strip_fixed(const Pixel& pixel, const Put& put, const float* taps,
                                   int oy0, int ox0, int iy0, int ix0, int out_h, int out_w) {
  constexpr int N = K + kCols - 1;
  float win[K][N][V];
  SHGAN_UNROLL
  for (int i = 0; i < K - 1; ++i)
    SHGAN_UNROLL
    for (int j = 0; j < N; ++j) pixel(iy0 + i, ix0 + j, win[i][j]);
  SHGAN_UNROLL
  for (int r = 0; r < kStrip; ++r) {
    if (oy0 + r >= out_h) break;
    SHGAN_UNROLL
    for (int j = 0; j < N; ++j) pixel(iy0 + r + K - 1, ix0 + j, win[K - 1][j]);
    SHGAN_UNROLL
    for (int u = 0; u < kCols; ++u) {
      if (ox0 + u >= out_w) break;
      float out[V];
      SHGAN_UNROLL
      for (int k = 0; k < V; ++k) {
        float acc = 0.0f;
        SHGAN_UNROLL
        for (int i = 0; i < K; ++i)
          SHGAN_UNROLL
          for (int j = 0; j < K; ++j) acc += taps[i * K + j] * win[i][u + j][k];
        out[k] = acc;
      }
      put(oy0 + r, ox0 + u, out);
    }
    SHGAN_UNROLL
    for (int i = 0; i < K - 1; ++i)
      SHGAN_UNROLL
      for (int j = 0; j < N; ++j)
        SHGAN_UNROLL
        for (int k = 0; k < V; ++k) win[i][j][k] = win[i + 1][j][k];
  }
}

// Any fh x fw taps: each output fir_strip's sum, the taps in its order.
template <int V, typename Pixel, typename Put>
SHGAN_HD void nhwc_fir_strip(const Pixel& pixel, const Put& put, const float* taps, int fh,
                             int fw, int oy0, int ox0, int iy0, int ix0, int out_h, int out_w) {
  for (int r = 0; r < kStrip && oy0 + r < out_h; ++r)
    for (int u = 0; u < kCols && ox0 + u < out_w; ++u) {
      float out[V];
      for (int k = 0; k < V; ++k) out[k] = 0.0f;
      for (int i = 0; i < fh; ++i)
        for (int j = 0; j < fw; ++j) {
          float v[V];
          pixel(iy0 + r + i, ix0 + u + j, v);
          for (int k = 0; k < V; ++k) out[k] += taps[i * fw + j] * v[k];
        }
      put(oy0 + r, ox0 + u, out);
    }
}

// The up = 2 thread body (4x4 taps, even pads): the quad of outputs (oy0 +
// py, ox0 + px), oy0 and ox0 even, from input pixels (oy0 / 2 - pady0 / 2 +
// r, ox0 / 2 - padx0 / 2 + q), r, q < 3 (zero outside the plane): output
// (py, px) takes taps (py + 2m, px + 2n) times pixel (py + m, px + n), in m
// then n, as fir_up_quads_fixed4 sums and upfirdn2d_point meets them.
template <int V, typename Pixel, typename Put>
SHGAN_HD void nhwc_up2_quad(const Pixel& pixel, const Put& put, const float* taps, int oy0,
                            int ox0, int padx0, int pady0, int out_h, int out_w) {
  const int iy0 = oy0 / 2 - pady0 / 2, ix0 = ox0 / 2 - padx0 / 2;
  float win[3][3][V];
  SHGAN_UNROLL
  for (int r = 0; r < 3; ++r)
    SHGAN_UNROLL
    for (int q = 0; q < 3; ++q) pixel(iy0 + r, ix0 + q, win[r][q]);
  SHGAN_UNROLL
  for (int py = 0; py < 2; ++py)
    SHGAN_UNROLL
    for (int px = 0; px < 2; ++px) {
      if (oy0 + py >= out_h || ox0 + px >= out_w) continue;
      float out[V];
      SHGAN_UNROLL
      for (int k = 0; k < V; ++k) {
        float acc = 0.0f;
        SHGAN_UNROLL
        for (int m = 0; m < 2; ++m)
          SHGAN_UNROLL
          for (int nn = 0; nn < 2; ++nn)
            acc += taps[(py + 2 * m) * 4 + px + 2 * nn] * win[py + m][px + nn][k];
        out[k] = acc;
      }
      put(oy0 + py, ox0 + px, out);
    }
}

// The V-channel version of upfirdn2d_point: `load(sy, sx, v)` fills v with
// the V channels of input sample (sy, sx); acc[k] is channel k's sum, in
// upfirdn2d_point's order.
template <int V, typename Load>
SHGAN_HD void upfirdn2d_point_v(const Load& load, int h, int w, int lupx, int lupy, int downx,
                                int downy, int padx0, int pady0, const float* taps, int fh,
                                int fw, int ox, int oy, float (&acc)[V]) {
  const int by = oy * downy - pady0;
  const int bx = ox * downx - padx0;
  const int hu = h << lupy, wu = w << lupx;
  for (int k = 0; k < V; ++k) acc[k] = 0.0f;
  for (int ty = upfirdn_first_tap(by, lupy); ty < fh; ty += 1 << lupy) {
    const int ky = by + ty;
    if (ky < 0 || ky >= hu) continue;
    const int sy = ky >> lupy;
    for (int tx = upfirdn_first_tap(bx, lupx); tx < fw; tx += 1 << lupx) {
      const int kx = bx + tx;
      if (kx < 0 || kx >= wu) continue;
      float v[V];
      load(sy, kx >> lupx, v);
      for (int k = 0; k < V; ++k) acc[k] += taps[ty * fw + tx] * v[k];
    }
  }
}

}  // namespace shgan
