// Native host-side freeform-mask generator (copy of
// shgan_tpu/native/src/maskgen.cpp, kept identical in everything below this
// header so both packages draw the same masks for the same seed).
//
// Role: CoModGAN's rejection-sampled freeform mask generation (the
// reference's ds_ffhq.py:145-217, numpy+PIL) becomes the data-path
// bottleneck when one device consumes hundreds of masks/sec.  This library
// generates whole batches of masks in parallel C++ threads.
//
// Semantics match the reference recipe: random rectangles (MultiFill) +
// polyline brush strokes with round caps (RandomBrush), random H/V flips,
// and a hole-ratio rejection loop.  Strokes are rasterized as capsules
// (thick segment + round caps), the geometry PIL's draw.line(width) +
// per-vertex ellipse approximates.  RNG is a per-mask-seeded xoshiro256++,
// so results are deterministic given (seed, index) and independent of
// thread scheduling.
//
// C ABI (ctypes-friendly):
//   shgan_random_mask_batch(out, n, s, hole_lo, hole_hi, seed, threads)
//     out: float32 [n, s, s], 1 = keep, 0 = hole.
// Returns 0 on success.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ----------------------------------------------------------------- RNG ----
struct Rng {
  uint64_t s[4];

  static uint64_t splitmix(uint64_t& x) {
    x += 0x9e3779b97f4a7c15ull;
    uint64_t z = x;
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
  }

  explicit Rng(uint64_t seed) {
    for (auto& si : s) si = splitmix(seed);
  }

  static uint64_t rotl(uint64_t x, int k) { return (x << k) | (x >> (64 - k)); }

  uint64_t next() {
    const uint64_t result = rotl(s[0] + s[3], 23) + s[0];
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3];
    s[2] ^= t; s[3] = rotl(s[3], 45);
    return result;
  }

  // uniform in [0, 1)
  double uniform() { return (next() >> 11) * 0x1.0p-53; }
  // uniform in [lo, hi)
  double uniform(double lo, double hi) { return lo + (hi - lo) * uniform(); }
  // integer in [0, n) — like np.random.randint(n); n >= 1
  int64_t randint(int64_t n) {
    return static_cast<int64_t>(uniform() * static_cast<double>(n));
  }
  int64_t randint(int64_t lo, int64_t hi) { return lo + randint(hi - lo); }
  // standard normal via Box–Muller
  double normal(double mean, double stddev) {
    double u1 = uniform(), u2 = uniform();
    while (u1 <= 1e-300) u1 = uniform();
    return mean + stddev * std::sqrt(-2.0 * std::log(u1)) *
                      std::cos(2.0 * M_PI * u2);
  }
};

// ------------------------------------------------------------- raster -----
// Fill a solid axis-aligned rectangle [x0,x1) x [y0,y1) with `value`,
// clamped to the canvas.
inline void fill_rect(uint8_t* m, int s, int64_t x0, int64_t y0, int64_t x1,
                      int64_t y1, uint8_t value) {
  x0 = std::max<int64_t>(x0, 0); y0 = std::max<int64_t>(y0, 0);
  x1 = std::min<int64_t>(x1, s); y1 = std::min<int64_t>(y1, s);
  for (int64_t y = y0; y < y1; ++y)
    std::memset(m + y * s + x0, value, static_cast<size_t>(std::max<int64_t>(x1 - x0, 0)));
}

// Rasterize a capsule (thick segment with round caps) of half-width r
// from (x0,y0) to (x1,y1): every pixel whose center is within r of the
// segment is set to 1.
void draw_capsule(uint8_t* m, int s, double x0, double y0, double x1,
                  double y1, double r) {
  const double dx = x1 - x0, dy = y1 - y0;
  const double len2 = dx * dx + dy * dy;
  const int ix0 = std::max(0, static_cast<int>(std::floor(std::min(x0, x1) - r)));
  const int iy0 = std::max(0, static_cast<int>(std::floor(std::min(y0, y1) - r)));
  const int ix1 = std::min(s - 1, static_cast<int>(std::ceil(std::max(x0, x1) + r)));
  const int iy1 = std::min(s - 1, static_cast<int>(std::ceil(std::max(y0, y1) + r)));
  const double r2 = r * r;
  for (int y = iy0; y <= iy1; ++y) {
    uint8_t* row = m + static_cast<int64_t>(y) * s;
    for (int x = ix0; x <= ix1; ++x) {
      double t = 0.0;
      if (len2 > 0.0)
        t = std::min(1.0, std::max(0.0, ((x - x0) * dx + (y - y0) * dy) / len2));
      const double px = x0 + t * dx - x, py = y0 + t * dy - y;
      if (px * px + py * py <= r2) row[x] = 1;
    }
  }
}

// ------------------------------------------- CoModGAN brush + rejection ---
// RandomBrush (ds_ffhq.py:145-197): chains of strokes with angles drawn
// around 2π/5, segment lengths ~ N(diag/8, diag/16), width U[12, 48)
// (scaled with resolution below), plus random flips.
void random_brush(Rng& rng, uint8_t* brush, int s, int max_tries) {
  std::memset(brush, 0, static_cast<size_t>(s) * s);
  const double mean_angle = 2.0 * M_PI / 5.0;
  const double angle_range = 2.0 * M_PI / 15.0;
  const double avg_radius = std::sqrt(2.0 * s * s) / 8.0;
  const int min_vertex = 4, max_vertex = 18;

  const int tries = static_cast<int>(rng.randint(std::max(max_tries, 1)));
  for (int t = 0; t < tries; ++t) {
    const int num_vertex = static_cast<int>(rng.randint(min_vertex, max_vertex));
    const double amin = mean_angle - rng.uniform(0.0, angle_range);
    const double amax = mean_angle + rng.uniform(0.0, angle_range);

    std::vector<double> vx, vy;
    vx.push_back(static_cast<double>(rng.randint(s)));
    vy.push_back(static_cast<double>(rng.randint(s)));
    for (int i = 0; i < num_vertex; ++i) {
      const double a = (i % 2 == 0) ? 2.0 * M_PI - rng.uniform(amin, amax)
                                    : rng.uniform(amin, amax);
      double r = rng.normal(avg_radius, std::floor(avg_radius / 2.0));
      r = std::min(std::max(r, 0.0), 2.0 * avg_radius);
      vx.push_back(std::min(std::max(vx.back() + r * std::cos(a), 0.0),
                            static_cast<double>(s)));
      vy.push_back(std::min(std::max(vy.back() + r * std::sin(a), 0.0),
                            static_cast<double>(s)));
    }
    const double width = std::floor(rng.uniform(12.0, 48.0));
    for (size_t i = 0; i + 1 < vx.size(); ++i)
      draw_capsule(brush, s, vx[i], vy[i], vx[i + 1], vy[i + 1], width / 2.0);
  }
  // random H/V flips (ds_ffhq.py:193-196)
  if (rng.uniform() > 0.5) {  // flip rows
    for (int y = 0; y < s / 2; ++y)
      for (int x = 0; x < s; ++x)
        std::swap(brush[y * s + x], brush[(s - 1 - y) * s + x]);
  }
  if (rng.uniform() > 0.5) {  // flip cols
    for (int y = 0; y < s; ++y)
      for (int x = 0; x < s / 2; ++x)
        std::swap(brush[y * s + x], brush[y * s + (s - 1 - x)]);
  }
}

// RandomMask (ds_ffhq.py:199-217): rectangles + brush + hole-ratio
// rejection.  Writes float32 s×s, 1 = keep.  Returns false when the
// hole-ratio test never passes within the attempt cap (the reference —
// and the numpy fallback — loop forever; a bounded loop must ERROR
// rather than silently emit an out-of-range mask).
bool random_mask_one(uint64_t seed, float* out, int s, float hole_lo,
                     float hole_hi) {
  Rng rng(seed);
  std::vector<uint8_t> keep(static_cast<size_t>(s) * s);
  std::vector<uint8_t> brush(static_cast<size_t>(s) * s);
  const double coef = std::min(static_cast<double>(hole_lo) + hole_hi, 1.0);

  bool ok = false;
  for (int attempt = 0; attempt < 10000; ++attempt) {
    std::memset(keep.data(), 1, keep.size());

    auto multi_fill = [&](int max_tries, int max_size) {
      const int tries = static_cast<int>(rng.randint(std::max(max_tries, 1)));
      for (int i = 0; i < tries; ++i) {
        const int64_t w = rng.randint(max_size), h = rng.randint(max_size);
        const int64_t ww = w / 2, hh = h / 2;
        const int64_t x = rng.randint(-ww, s - w + ww);
        const int64_t y = rng.randint(-hh, s - h + hh);
        fill_rect(keep.data(), s, x, y, x + w, y + h, 0);
      }
    };
    multi_fill(static_cast<int>(10 * coef), s / 2);
    multi_fill(static_cast<int>(5 * coef), s);

    random_brush(rng, brush.data(), s, static_cast<int>(20 * coef));

    int64_t holes = 0;
    for (size_t i = 0; i < keep.size(); ++i) {
      keep[i] = keep[i] && !brush[i];
      holes += 1 - keep[i];
    }
    const double ratio = static_cast<double>(holes) / keep.size();
    if (ratio > hole_lo && ratio < hole_hi) {
      ok = true;
      break;
    }
  }
  for (size_t i = 0; i < keep.size(); ++i)
    out[i] = static_cast<float>(keep[i]);
  return ok;
}

}  // namespace

#define SHGAN_EXPORT __attribute__((visibility("default")))

extern "C" {

SHGAN_EXPORT
int shgan_random_mask_batch(float* out, int64_t n, int32_t s, float hole_lo,
                            float hole_hi, uint64_t seed,
                            int32_t num_threads) {
  if (n <= 0 || s <= 0) return 1;
  if (num_threads <= 0)
    num_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
  num_threads = std::min<int64_t>(std::max(num_threads, 1), n);

  std::atomic<int64_t> next(0);
  std::atomic<bool> exhausted(false);
  auto work = [&]() {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n) return;
      uint64_t mixer = seed + 0x51ed2701;
      const uint64_t mask_seed =
          Rng::splitmix(mixer) ^ (0x9e3779b97f4a7c15ull * (i + 1));
      if (!random_mask_one(mask_seed, out + i * static_cast<int64_t>(s) * s,
                           s, hole_lo, hole_hi))
        exhausted.store(true);
    }
  };
  std::vector<std::thread> threads;
  for (int32_t t = 1; t < num_threads; ++t) threads.emplace_back(work);
  work();
  for (auto& t : threads) t.join();
  return exhausted.load() ? 2 : 0;  // 2: hole_range unsatisfiable
}

// Version/ABI probe for the loader.
SHGAN_EXPORT
int shgan_native_abi_version() { return 1; }

}  // extern "C"
