"""The kernels' arithmetic on the host: a g++ harness around the
``__host__ __device__`` headers of ``shgan_torch/csrc`` (the Philox rounds,
the Box–Muller conversion and the noise layout of kernel K1; the upfirdn2d
index and padding arithmetic of kernel K2; the tiling, halo staging and
weight layout of kernel K3, run as a host emulation of its tiled loop),
held to the plain PyTorch versions.  This is the only way the kernels' own code runs without a card.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from shgan_torch.ops import noise
from shgan_torch.ops.conv1024 import conv3x3_lowch_plain
from shgan_torch.ops.upfirdn2d import fir_plain, out_size

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "shgan_torch", "csrc")

HARNESS = r"""
#include <cstdio>
#include <string>
#include <vector>
#include "conv3x3_lowch.cuh"
#include "philox.cuh"
#include "upfirdn2d.cuh"

// Reads commands from stdin, one per line:
//   philox k0 k1 c0 c1 c2 c3        -> 4 words
//   noise k0 k1 batch res           -> batch*res*res floats, kernel layout
//   fir h w upx upy downx downy px0 px1 py0 py1 fh fw taps... x...
//                                   -> out_h out_w, then the outputs
//   tile (same arguments, up = down = 1) -> the tiled kernel's outputs
//   conv3 n c o h w weights... x...  -> K3's tiled loop, block by block
int main() {
  char cmd[16];
  while (std::scanf("%15s", cmd) == 1) {
    std::string c(cmd);
    if (c == "philox") {
      unsigned k0, k1;
      shgan::U32x4 ctr;
      std::scanf("%u %u %u %u %u %u", &k0, &k1, &ctr.v[0], &ctr.v[1],
                 &ctr.v[2], &ctr.v[3]);
      shgan::U32x4 o = shgan::philox4x32_10(ctr, k0, k1);
      std::printf("%u %u %u %u\n", o.v[0], o.v[1], o.v[2], o.v[3]);
    } else if (c == "noise") {
      unsigned k0, k1;
      int batch, res;
      std::scanf("%u %u %d %d", &k0, &k1, &batch, &res);
      const long plane = (long)res * res, half = plane / 2;
      std::vector<float> out(batch * plane);
      for (int row = 0; row < batch; ++row)
        for (long call = 0; call < plane / 4; ++call) {
          float cs[2], sn[2];
          shgan::noise_quad((unsigned)call, (unsigned)row, k0, k1, cs, sn);
          float* base = out.data() + row * plane + 2 * call;
          base[0] = cs[0]; base[1] = cs[1];
          base[half] = sn[0]; base[half + 1] = sn[1];
        }
      for (float v : out) std::printf("%.9g\n", v);
    } else if (c == "conv3") {
      namespace k3 = shgan::conv3;
      int n, ch, oc, h, w;
      std::scanf("%d %d %d %d %d", &n, &ch, &oc, &h, &w);
      std::vector<float> wt(oc * ch * 9), x((long)n * ch * h * w);
      for (float& v : wt) std::scanf("%f", &v);
      for (float& v : x) std::scanf("%f", &v);
      std::vector<float> y((long)n * oc * h * w, -1e30f);  // unwritten: huge
      static float xs[k3::kInElems], ws[k3::kWElems];
      static float acc[k3::kThreads][k3::kOGroup][k3::kPix];
      auto in = [&](int i) { return xs[i]; };
      auto wgt = [&](int i) { return ws[i]; };
      const long plane = (long)h * w;
      for (int b = 0; b < n; ++b)
        for (int by = 0; by * k3::kTileH < h; ++by)
          for (int bx = 0; bx * k3::kTileW < w; ++bx) {
            const int x0 = k3::tile_x0(bx), y0 = k3::tile_y0(by);
            for (auto& a : acc) for (auto& r : a) for (float& v : r) v = 0.0f;
            for (int c0 = 0; c0 < ch; c0 += k3::kCChunk) {
              for (int i = 0; i < k3::kInElems; ++i) {
                int ci, sy, sx;
                k3::halo_coords(i, y0, x0, &ci, &sy, &sx);
                xs[i] = k3::halo_inside(c0 + ci, sy, sx, ch, h, w)
                            ? x[(b * ch + c0 + ci) * plane + (long)sy * w + sx]
                            : 0.0f;
              }
              for (int i = 0; i < k3::kWElems; ++i) {
                int ci, dy, dx, o;
                k3::weight_coords(i, &ci, &dy, &dx, &o);
                ws[i] = (c0 + ci < ch && o < oc)
                            ? wt[k3::weight_offset(o, c0 + ci, dy, dx, ch)]
                            : 0.0f;
              }
              for (int t = 0; t < k3::kThreads; ++t) {
                int og, ty, tx0;
                k3::thread_role(t, &og, &ty, &tx0);
                k3::accumulate_chunk(in, wgt, og, ty, tx0, acc[t]);
              }
            }
            for (int t = 0; t < k3::kThreads; ++t) {
              int og, ty, tx0;
              k3::thread_role(t, &og, &ty, &tx0);
              for (int o = 0; o < k3::kOGroup; ++o)
                for (int p = 0; p < k3::kPix; ++p) {
                  const int oo = og * k3::kOGroup + o, yy = y0 + ty,
                            xx = x0 + tx0 + p;
                  if (oo < oc && yy < h && xx < w)
                    y[(b * oc + oo) * plane + (long)yy * w + xx] = acc[t][o][p];
                }
            }
          }
      for (float v : y) std::printf("%.9g\n", v);
    } else if (c == "fir" || c == "tile") {
      const bool tiled = c == "tile";  // tile: up = down = 1 only
      int h, w, upx, upy, dx, dy, px0, px1, py0, py1, fh, fw;
      std::scanf("%d %d %d %d %d %d %d %d %d %d %d %d", &h, &w, &upx, &upy,
                 &dx, &dy, &px0, &px1, &py0, &py1, &fh, &fw);
      std::vector<float> taps(fh * fw), x(h * w);
      for (float& t : taps) std::scanf("%f", &t);
      for (float& v : x) std::scanf("%f", &v);
      const int oh = shgan::upfirdn_out_size(h, upy, dy, py0, py1, fh);
      const int ow = shgan::upfirdn_out_size(w, upx, dx, px0, px1, fw);
      std::printf("%d %d\n", oh, ow);
      auto load = [&](int sy, int sx) { return x[sy * w + sx]; };
      if (tiled) {  // the tiled kernel's staging and sums, tile by tile
        std::vector<float> out(oh * ow);
        static float tile[shgan::kTileInH][shgan::kTileInW];
        auto at = [&](int r, int cc) { return tile[r][cc]; };
        for (int oy0 = 0; oy0 < oh; oy0 += shgan::kTileH)
          for (int ox0 = 0; ox0 < ow; ox0 += shgan::kTileW) {
            for (int iy = 0; iy < shgan::kTileH + fh - 1; ++iy)
              for (int ix = 0; ix < shgan::kTileW + fw - 1; ++ix) {
                const int sy = shgan::tile_src(oy0, py0, iy);
                const int sx = shgan::tile_src(ox0, px0, ix);
                tile[iy][ix] = (sy >= 0 && sy < h && sx >= 0 && sx < w)
                                   ? load(sy, sx) : 0.0f;
              }
            for (int ty = 0; ty < shgan::kTileH; ++ty)
              for (int tx = 0; tx < shgan::kTileW; ++tx) {
                if (oy0 + ty >= oh || ox0 + tx >= ow) continue;
                out[(oy0 + ty) * ow + ox0 + tx] =
                    (fh == 4 && fw == 4)
                        ? shgan::tile_point_fixed<4, 4>(at, taps.data(), ty, tx)
                        : shgan::tile_point(at, taps.data(), fh, fw, ty, tx);
              }
          }
        for (float v : out) std::printf("%.9g\n", v);
        continue;
      }
      for (int oy = 0; oy < oh; ++oy)
        for (int ox = 0; ox < ow; ++ox)
          std::printf("%.9g\n", shgan::upfirdn2d_point(
              load, h, w, shgan::log2_factor(upx), shgan::log2_factor(upy),
              dx, dy, px0, py0, taps.data(), fh, fw, ox, oy));
    }
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host harness cannot be built")
    d = tmp_path_factory.mktemp("kernel_math")
    src, exe = d / "harness.cpp", d / "harness"
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O2", "-I", CSRC, str(src), "-o",
                    str(exe)], check=True, capture_output=True, text=True)

    def run(text):
        r = subprocess.run([str(exe)], input=text, capture_output=True,
                           text=True, check=True, timeout=60)
        return r.stdout.split()

    return run


@pytest.mark.parametrize("key,ctr", [
    ((0, 0), (0, 0, 0, 0)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF,) * 4),
    ((0xA4093822, 0x299F31D0),
     (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344)),
    ((12345, 678), (99, 3, 0, 0)),
])
def test_philox_header_matches_plain(harness, key, ctr):
    got = [int(v) for v in harness(f"philox {key[0]} {key[1]} "
                                   + " ".join(map(str, ctr)))]
    words = [torch.tensor([c], dtype=torch.int64) for c in ctr]
    want = [int(w) for w in noise.philox4x32_10(*words, *key)]
    assert got == want


@pytest.mark.parametrize("batch,res", [(2, 4), (3, 16)])
def test_noise_header_matches_plain(harness, batch, res):
    key = noise.noise_key(21, 2 * res)
    got = np.array(harness(f"noise {key[0]} {key[1]} {batch} {res}"),
                   np.float32).reshape(batch, res, res)
    want = noise.philox_normal_plain(key, batch, res).numpy()
    # same bits; only libm vs torch rounding of log/sqrt/sin/cos differs
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


FIR_CASES = [
    # (h, w, up, down, pads x0 x1 y0 y1, taps) — the main path's three
    # call sites, then signed and asymmetric cases
    (9, 9, (1, 1), (1, 1), (1, 1, 1, 1), (4, 4)),     # synthesis up FIR
    (8, 8, (1, 1), (1, 1), (2, 2, 2, 2), (4, 4)),     # encoder down blur
    (4, 4, (2, 2), (1, 1), (2, 1, 2, 1), (4, 4)),     # skip-image upsample
    (8, 9, (1, 1), (2, 2), (1, 1, 1, 1), (4, 4)),
    (8, 9, (2, 2), (2, 2), (2, 2, 2, 2), (4, 4)),
    (8, 9, (1, 1), (1, 1), (-1, 2, 0, -2), (3, 5)),
    (7, 6, (2, 1), (1, 2), (1, 1, 2, 2), (8, 8)),
    (5, 5, (1, 1), (1, 1), (0, 0, 0, 0), (1, 1)),
]


TILE_CASES = [c for c in FIR_CASES if c[2] == c[3] == (1, 1)] + [
    (70, 45, (1, 1), (1, 1), (1, 1, 1, 1), (4, 4)),   # several tiles, ragged
    (66, 33, (1, 1), (1, 1), (2, 2, 2, 2), (4, 4)),
    (40, 37, (1, 1), (1, 1), (-3, 2, 4, -1), (3, 5)),
    (34, 34, (1, 1), (1, 1), (0, 0, 0, 0), (8, 8)),
]


def _run_fir(harness, mode, h, w, up, down, pads, taps):
    rng = np.random.RandomState(h * 31 + w)
    t = rng.randn(*taps).astype(np.float32)
    x = rng.randn(h, w).astype(np.float32)
    cmd = " ".join(map(str, (h, w, up[0], up[1], down[0], down[1]) + pads
                       + taps))
    vals = " ".join(f"{v:.9g}" for v in np.concatenate([t.ravel(),
                                                        x.ravel()]))
    out = harness(f"{mode} {cmd} {vals}")
    oh, ow = int(out[0]), int(out[1])
    assert oh == out_size(h, up[1], down[1], pads[2], pads[3], taps[0])
    assert ow == out_size(w, up[0], down[0], pads[0], pads[1], taps[1])
    got = np.array(out[2:], np.float32).reshape(oh, ow)
    want = fir_plain(torch.from_numpy(x)[None, None], t, up, down,
                     pads)[0, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("h,w,up,down,pads,taps", TILE_CASES)
def test_upfirdn_tiled_header_matches_plain(harness, h, w, up, down, pads,
                                            taps):
    _run_fir(harness, "tile", h, w, up, down, pads, taps)


@pytest.mark.parametrize("h,w,up,down,pads,taps", FIR_CASES)
def test_upfirdn_header_matches_plain(harness, h, w, up, down, pads, taps):
    _run_fir(harness, "fir", h, w, up, down, pads, taps)


CONV3_CASES = [
    # (n, c, o, h, w) — one whole tile; ragged rows and columns; W not a
    # multiple of the 64-wide tile or of the 8-pixel strip; C not a multiple
    # of the 8-channel chunk; O < 32 (part of a channel group unused)
    (1, 8, 8, 8, 64),
    (2, 32, 32, 9, 70),
    (1, 5, 3, 13, 21),
    (1, 12, 32, 17, 130),
    (1, 32, 7, 3, 5),
]


@pytest.mark.parametrize("n,c,o,h,w", CONV3_CASES)
def test_conv3x3_lowch_tiled_loop_matches_plain(harness, n, c, o, h, w):
    rng = np.random.RandomState(n * 1000 + c * 37 + w)
    wt = (rng.randn(o, c, 3, 3) / np.sqrt(9 * c)).astype(np.float32)
    x = rng.randn(n, c, h, w).astype(np.float32)
    vals = " ".join(f"{v:.9g}" for v in np.concatenate([wt.ravel(),
                                                        x.ravel()]))
    got = np.array(harness(f"conv3 {n} {c} {o} {h} {w} {vals}"),
                   np.float32).reshape(n, o, h, w)
    want = conv3x3_lowch_plain(torch.from_numpy(x),
                               torch.from_numpy(wt)).numpy()
    # every output written once; float32 sums in another order
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
