"""The kernels' arithmetic on the host: a g++ harness around the
``__host__ __device__`` headers of ``shgan_torch/csrc`` (the Philox rounds,
the Box–Muller conversion and the noise layout of kernel K1; the upfirdn2d
index and padding arithmetic of kernel K2; the tiling, halo staging,
fragment ownership and TF32 split of kernel K3, run as a host emulation of
its mma loop; the launch rule, index map, element math and bf16 rounding of
the fused synthesis epilogue, run as a host emulation of its threads), held
to the plain PyTorch versions and numpy.  This is the only way the kernels'
own code runs without a card.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from shgan_torch.ops import noise
from shgan_torch.ops import noise_bias_act as nba_mod
from shgan_torch.ops.bias_act import lrelu_agc, parse_activation
from shgan_torch.ops.conv1024 import conv3x3_lowch_plain
from shgan_torch.ops.noise_bias_act import epilogue_act, noise_bias_act_plain
from shgan_torch.ops.upfirdn2d import (correlation_taps, fir_plain, out_size,
                                       setup_filter)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "shgan_torch", "csrc")

HARNESS = r"""
#include <array>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include "conv3x3_lowch.cuh"
#include "noise_bias_act.cuh"
#include "philox.cuh"
#include "upfirdn2d.cuh"


namespace k3 = shgan::conv3;
namespace nba = shgan::nba;

static uint32_t bits(float v) { uint32_t u; std::memcpy(&u, &v, 4); return u; }
static float val(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
static uint32_t bf16_bits(float v) { return bits(v) >> 16; }  // bf16-exact input

// nbamap n c res cpt per -> per chunks bt bc tiles, then the number of
// elements of [n, c, res, res] not touched exactly once by the index map
static void nbamap() {
  int n, c, res, cpt, per;
  std::scanf("%d %d %d %d %d", &n, &c, &res, &cpt, &per);
  const nba::Launch L = nba::plan(n, c, res, cpt, per);
  const long long plane = (long long)res * res, calls = plane / 4;
  std::vector<unsigned char> hits((size_t)n * c * plane, 0);
  for (int bz = 0; bz < L.chunks; ++bz)
    for (int by = 0; by < n; ++by)
      for (long long bx = 0; bx < L.tiles; ++bx)
        for (int ty = 0; ty < L.bc; ++ty)
          for (int tx = 0; tx < L.bt; ++tx) {
            const long long q0 = nba::first_call(L, bx, tx, calls);
            if (q0 < 0) continue;
            for (int k = 0; k < L.per; ++k) {
              const int ch = nba::channel(L, bz, ty, k, c);
              if (ch < 0) break;
              for (int h = 0; h < 2; ++h)
                for (int e = 0; e < 2 * cpt; ++e) {
                  const long long at = ((long long)by * c + ch) * plane + h * plane / 2 + 2 * q0 + e;
                  if (hits[at] < 255) ++hits[at];
                }
            }
          }
  long long bad = 0;
  for (unsigned char v : hits) bad += v != 1;
  std::printf("%d %d %d %d %lld %lld\n", L.per, L.chunks, L.bt, L.bc, L.tiles, bad);
}

// nba bf cpt per n c res mode k0 k1 alpha gain clamp has_dcoef has_bias
//     strength row0 dcoef[n*c]... bias[c]... const[res*res]... x[n*c*res*res]...
// -> the fused epilogue emulated thread by thread as the kernel runs it
// (bf: x holds bf16 values, each result rounded once to bf16); each output
// as its float32 bits.  An element written twice or never aborts.
static void nba_run() {
  int bf, cpt, per, n, c, res, mode, hd, hb;
  unsigned k0, k1;
  float s;
  long long row0;
  nba::Act act;
  std::scanf("%d %d %d %d %d %d %d %u %u %f %f %f %d %d %f %lld", &bf, &cpt, &per, &n, &c,
             &res, &mode, &k0, &k1, &act.alpha, &act.gain, &act.clamp, &hd, &hb, &s, &row0);
  const long long plane = (long long)res * res, half = plane / 2, calls = plane / 4;
  std::vector<float> dcoef(n * c), bias(c), cst(plane), x((size_t)n * c * plane);
  for (float& v : dcoef) std::scanf("%f", &v);
  for (float& v : bias) std::scanf("%f", &v);
  for (float& v : cst) std::scanf("%f", &v);
  for (float& v : x) std::scanf("%f", &v);
  std::vector<float> y(x.size());
  std::vector<int> hits(x.size(), 0);
  const nba::Launch L = nba::plan(n, c, res, cpt, per);
  const int V = 2 * cpt;
  for (int bz = 0; bz < L.chunks; ++bz)
    for (int row = 0; row < n; ++row)
      for (long long bx = 0; bx < L.tiles; ++bx)
        for (int ty = 0; ty < L.bc; ++ty)
          for (int tx = 0; tx < L.bt; ++tx) {
            const long long q0 = nba::first_call(L, bx, tx, calls);
            if (q0 < 0) continue;
            float nz[2][4];
            for (int e = 0; e < V; ++e) nz[0][e] = nz[1][e] = -0.0f;
            if (mode == nba::kNoiseRandom)
              for (int j = 0; j < cpt; ++j)
                shgan::noise_quad((unsigned)(q0 + j), shgan::noise_row(row0, row), k0, k1,
                                  &nz[0][2 * j], &nz[1][2 * j]);
            if (mode == nba::kNoiseConst)
              for (int e = 0; e < V; ++e) {
                nz[0][e] = cst[2 * q0 + e];
                nz[1][e] = cst[half + 2 * q0 + e];
              }
            if (mode != nba::kNoiseNone)
              for (int e = 0; e < V; ++e) {
                nz[0][e] = nba::mul_rn(nz[0][e], s);
                nz[1][e] = nba::mul_rn(nz[1][e], s);
              }
            for (int k = 0; k < L.per; ++k) {
              const int ch = nba::channel(L, bz, ty, k, c);
              if (ch < 0) break;
              const long long p = (long long)row * c + ch;
              const float d = hd ? dcoef[p] : 1.0f, b = hb ? bias[ch] : -0.0f;
              for (int h = 0; h < 2; ++h)
                for (int e = 0; e < V; ++e) {
                  const long long at = p * plane + h * half + 2 * q0 + e;
                  float v = nba::apply(x[at], d, nz[h][e], b, act);
                  if (bf) v = nba::from_bf16(nba::to_bf16(v));
                  if (hits[at]++) std::abort();
                  y[at] = v;
                }
            }
          }
  for (int h : hits)
    if (h != 1) std::abort();
  for (float v : y) std::printf("%u\n", bits(v));
}

// nbagrad bf cpt n c res mode k0 k1 alpha gain clamp hd hb s mask_only hvs vs row0
//     dcoef[n*c]... bias[c]... const[res*res]... x[...]... dy[...]...
// -> noise_bias_act_grad emulated block by block as the kernel runs it
// (grad_plan's channel-group blocks and thread strides, each thread's sums
// per channel in its order, each channel's fixed tree, the two finishing
// passes; bf: x and dy hold bf16 values,
// out is rounded once to bf16 at the store): out's bits, then the raw
// normal each element used (per row and pixel; channels that disagree
// abort), then dd[n*c], db[c] and ds's bits (full mode).
static void nbagrad_run() {
  int bf, cpt, n, c, res, mode, hd, hb, mo, hvs;
  unsigned k0, k1;
  float s, vs;
  long long row0;
  nba::Act act;
  std::scanf("%d %d %d %d %d %d %u %u %f %f %f %d %d %f %d %d %f %lld", &bf, &cpt, &n, &c,
             &res, &mode, &k0, &k1, &act.alpha, &act.gain, &act.clamp, &hd, &hb, &s, &mo, &hvs,
             &vs, &row0);
  const long long plane = (long long)res * res, half = plane / 2, calls = plane / 4;
  const long long planes = (long long)n * c;
  std::vector<float> dcoef(planes), bias(c), cst(plane), x(planes * plane), dy(x.size());
  for (float& v : dcoef) std::scanf("%f", &v);
  for (float& v : bias) std::scanf("%f", &v);
  for (float& v : cst) std::scanf("%f", &v);
  for (float& v : x) std::scanf("%f", &v);
  for (float& v : dy) std::scanf("%f", &v);
  std::vector<float> out(x.size()), nus((size_t)n * plane);
  std::vector<int> hits(x.size(), 0), seen(nus.size(), 0);
  const nba::GradLaunch G = nba::grad_plan(n, c, res, cpt);
  const int chunks = nba::grad_chunks(n, c, res);
  if (chunks != G.chunks) std::abort();
  std::vector<float> work(nba::grad_work_floats(n, c, res));
  const int V = 2 * cpt;
  // the kernel's blocks: (row, group of G.group channels) x chunk; each
  // thread walks its calls, drawing the normals once, and the group's
  // channels, a sum triple per channel; then each channel's fixed tree
  for (long long bx = 0; bx < (long long)n * G.groups; ++bx)
    for (int by = 0; by < G.chunks; ++by) {
      const int row = (int)(bx / G.groups), ch0 = (int)(bx % G.groups) * G.group;
      const int kn = c - ch0 < G.group ? c - ch0 : G.group;
      const long long p0 = (long long)row * c + ch0;
      const long long qa = (long long)by * G.calls_per_block;
      const long long qb = qa + G.calls_per_block < calls ? qa + G.calls_per_block : calls;
      const float sv = mode != nba::kNoiseNone ? s : 0.0f;
      std::vector<std::vector<float>> sums(3 * kn, std::vector<float>(G.threads, 0.0f));
      for (int t = 0; t < G.threads; ++t) {
        std::vector<float> acc(3 * kn, 0.0f);
        for (long long q = qa + (long long)t * cpt; q < qb; q += (long long)G.threads * cpt) {
          float nu[2][8];
          for (int e = 0; e < V; ++e) nu[0][e] = nu[1][e] = 0.0f;
          if (mode == nba::kNoiseRandom)
            for (int j = 0; j < cpt; ++j)
              shgan::noise_quad((unsigned)(q + j), shgan::noise_row(row0, row), k0, k1,
                                &nu[0][2 * j], &nu[1][2 * j]);
          if (mode == nba::kNoiseConst)
            for (int e = 0; e < V; ++e) {
              nu[0][e] = cst[2 * q + e];
              nu[1][e] = cst[half + 2 * q + e];
            }
          for (int k = 0; k < kn; ++k) {
            const long long p = p0 + k;
            const float d = hd ? dcoef[p] : 1.0f, b = hb ? bias[ch0 + k] : -0.0f;
            for (int h = 0; h < 2; ++h)
              for (int e = 0; e < V; ++e) {
                const long long pix = h * half + 2 * q + e, at = p * plane + pix;
                const float nz = mode != nba::kNoiseNone ? nba::mul_rn(nu[h][e], sv) : -0.0f;
                const float o = mo ? nba::mask_element(dy[at], vs, hvs != 0, x[at], d, nu[h][e],
                                                       nz, b, act)
                                   : nba::grad_element(dy[at], x[at], d, hd != 0, nu[h][e], nz,
                                                       b, act, &acc[3 * k]);
                out[at] = bf ? nba::from_bf16(nba::to_bf16(o)) : o;
                if (hits[at]++) std::abort();
                const size_t rp = (size_t)row * plane + pix;
                if (seen[rp]++ && bits(nus[rp]) != bits(nu[h][e])) std::abort();
                nus[rp] = nu[h][e];
              }
          }
        }
        for (int i = 0; i < 3 * kn; ++i) sums[i][t] = acc[i];
      }
      for (int k = 0; k < kn; ++k) {
        for (int hh = G.threads / 2; hh > 0; hh /= 2)
          for (int j = 0; j < 3; ++j)
            for (int t = 0; t < hh; ++t) nba::tree_add(sums[3 * k + j].data(), t, hh);
        for (int j = 0; j < 3; ++j) work[(j * planes + p0 + k) * G.chunks + by] = sums[3 * k + j][0];
      }
    }
  for (int h : hits)
    if (h != 1) std::abort();
  for (float v : out) std::printf("%u\n", bits(v));
  for (float v : nus) std::printf("%u\n", bits(v));
  if (mo) return;
  // grad_finish_planes, then grad_finish_sums (db per channel over the rows;
  // ds: kThreads strided sums, then the tree)
  float* pw = work.data() + 3 * planes * chunks;
  std::vector<float> dd(planes);
  for (long long p = 0; p < planes; ++p) {
    float acc[3];
    for (int k = 0; k < 3; ++k) {
      acc[k] = 0.0f;
      for (int j = 0; j < chunks; ++j) acc[k] = nba::add_rn(acc[k], work[(k * planes + p) * chunks + j]);
    }
    dd[p] = acc[0];
    pw[p] = acc[1];
    pw[planes + p] = acc[2];
  }
  for (float v : dd) std::printf("%u\n", bits(v));
  for (int ch = 0; ch < c; ++ch) {
    float acc = 0.0f;
    for (int r = 0; r < n; ++r) acc = nba::add_rn(acc, pw[(long long)r * c + ch]);
    std::printf("%u\n", bits(acc));
  }
  std::vector<float> st(nba::kThreads, 0.0f);
  for (int t = 0; t < nba::kThreads; ++t)
    for (long long p = t; p < planes; p += nba::kThreads) st[t] = nba::add_rn(st[t], pw[planes + p]);
  for (int hh = nba::kThreads / 2; hh > 0; hh /= 2)
    for (int t = 0; t < hh; ++t) nba::tree_add(st.data(), t, hh);
  std::printf("%u\n", bits(st[0]));
}

// what the tensor core multiplies for a .tf32 operand: its top 19 bits
static float tf32_operand(float v) { return val(bits(v) & 0xffffe000u); }
static float from_bf16(uint32_t b) { return val((b & 0xffffu) << 16); }

// conv3 bf n c o h w weights... x... -> K3 emulated block by block: the
// kernel's staging (16-byte or pixel path), its weight fragments, and each
// mma rebuilt from the fragments the 32 lanes own, summed in float.
// Unstaged shared words hold NaN, so a fragment read of one shows up.
static void conv3() {
  int bf, n, ch, oc, h, w;
  std::scanf("%d %d %d %d %d %d", &bf, &n, &ch, &oc, &h, &w);
  std::vector<float> wt(oc * ch * 9), x((long)n * ch * h * w);
  for (float& v : wt) std::scanf("%f", &v);
  for (float& v : x) std::scanf("%f", &v);
  const int stage_ch = bf ? 16 : 8, nst = k3::stages_for(ch, stage_ch);
  const int px = bf ? 8 : 4;
  const bool vec = w % px == 0;
  const int tx = (w + k3::kTileW - 1) / k3::kTileW, ty = (h + k3::kTileH - 1) / k3::kTileH;
  std::vector<std::array<uint32_t, 4>> wf(nst * 9 * k3::kNTiles * 32);
  for (int e = 0; e < (int)wf.size(); ++e) {
    const int lane = e & 31, nt = (e >> 5) % k3::kNTiles;
    const int tap = (e / (32 * k3::kNTiles)) % 9, s = e / (32 * k3::kNTiles * 9);
    const int o = nt * 8 + k3::b_col(lane);
    auto wv = [&](int c) {
      return (c < ch && o < oc) ? wt[k3::weight_offset(o, c, tap / 3, tap % 3, ch)] : 0.0f;
    };
    if (k3::wfrag_index(s, tap, nt, lane) != e) std::abort();
    for (int r = 0; r < 2; ++r) {
      if (bf) {
        const int c = k3::slot_channel<2>(s, k3::b_slot(lane, r), 0);
        wf[e][r] = bf16_bits(wv(c)) | (bf16_bits(wv(c + 1)) << 16);
      } else {
        float hi, lo;
        k3::split_tf32(wv(k3::slot_channel<4>(s, k3::b_slot(lane, r), 0)), &hi, &lo);
        wf[e][r] = bits(hi);
        wf[e][2 + r] = bits(lo);
      }
    }
  }
  std::vector<uint32_t> buf(k3::kStageWords);
  std::vector<float> y((long)n * oc * h * w, -1e30f);  // unwritten: huge
  static float acc[k3::kWarps][32][k3::kMTiles][k3::kNTiles][4];
  for (int t = 0; t < n * tx * ty; ++t) {
    int b, y0, x0;
    k3::tile_origin(t, tx, ty, &b, &y0, &x0);
    std::memset(acc, 0, sizeof(acc));
    auto xin = [&](int c, int sy, int sx) {
      return x[((long)(b * ch + c) * h + sy) * w + sx];
    };
    for (int s = 0; s < nst; ++s) {
      std::fill(buf.begin(), buf.end(), 0x7fc00000u);
      // the staged word of (slot, iy, ix): one channel, or a bf16 pair
      auto word = [&](int slot, int iy, int ix) -> uint32_t {
        const int sy = y0 - 1 + iy, sx = x0 - 1 + ix;
        if (!bf) {
          const int c = k3::slot_channel<4>(s, slot, 0);
          return k3::inside(c, sy, sx, ch, h, w) ? bits(xin(c, sy, sx)) : 0u;
        }
        const int c = k3::slot_channel<2>(s, slot, 0);
        const uint32_t lo = k3::inside(c, sy, sx, ch, h, w) ? bf16_bits(xin(c, sy, sx)) : 0u;
        const uint32_t hi =
            k3::inside(c + 1, sy, sx, ch, h, w) ? bf16_bits(xin(c + 1, sy, sx)) : 0u;
        return lo | (hi << 16);
      };
      if (vec) {
        for (int j = 0; j < k3::kSlots * k3::kInH * (k3::kTileW / px); ++j) {
          int slot, iy, ix;
          k3::vec_item(j, px, &slot, &iy, &ix);
          const int sy = y0 - 1 + iy, sx = x0 - 1 + ix;
          if (!bf) {  // one 16-byte copy: all four pixels or zero fill
            const int c = k3::slot_channel<4>(s, slot, 0);
            const bool ok = k3::inside(c, sy, sx, ch, h, w);
            for (int q = 0; q < 4; ++q)
              buf[k3::staged_word(slot, iy, ix + q)] = ok ? bits(xin(c, sy, sx + q)) : 0u;
            continue;
          }
          // two 16-byte loads (channels c, c+1), interleaved word by word
          const int c = k3::slot_channel<2>(s, slot, 0);
          const bool row = sy >= 0 && sy < h && sx < w;
          uint32_t ev[4], od[4];
          for (int q = 0; q < 4; ++q) {
            auto two = [&](int cc) -> uint32_t {
              if (!row || cc >= ch) return 0u;
              return bf16_bits(xin(cc, sy, sx + 2 * q)) |
                     (bf16_bits(xin(cc, sy, sx + 2 * q + 1)) << 16);
            };
            ev[q] = two(c);
            od[q] = two(c + 1);
          }
          for (int q = 0; q < 4; ++q) {
            buf[k3::staged_word(slot, iy, ix + 2 * q)] = k3::pair_first(ev[q], od[q]);
            buf[k3::staged_word(slot, iy, ix + 2 * q + 1)] = k3::pair_second(ev[q], od[q]);
          }
        }
        for (int j = 0; j < k3::kSlots * k3::kInH * 2; ++j) {
          int slot, iy, ix;
          k3::halo_item(j, &slot, &iy, &ix);
          buf[k3::staged_word(slot, iy, ix)] = word(slot, iy, ix);
        }
      } else {
        for (int j = 0; j < k3::kSlots * k3::kInH * k3::kInW; ++j) {
          int slot, iy, ix;
          k3::pixel_item(j, &slot, &iy, &ix);
          buf[k3::staged_word(slot, iy, ix)] = word(slot, iy, ix);
        }
      }
      // the mma loop: A[m][k] and B[k][n] rebuilt from the lanes' registers
      const int K = bf ? 16 : 8;
      for (int warp = 0; warp < k3::kWarps; ++warp)
        for (int tap = 0; tap < 9; ++tap)
          for (int mt = 0; mt < k3::kMTiles; ++mt)
            for (int nt = 0; nt < k3::kNTiles; ++nt) {
              float A[3][16][16], B[3][16][8];  // [part]: 0 hi, 1 lo (float32)
              for (int lane = 0; lane < 32; ++lane) {
                for (int r = 0; r < 4; ++r) {
                  const uint32_t u = buf[k3::a_word(lane, r, warp, mt, tap / 3, tap % 3)];
                  const int m = k3::a_row(lane, r), sl = k3::a_slot(lane, r);
                  if (bf) {
                    A[0][m][2 * sl] = from_bf16(u);
                    A[0][m][2 * sl + 1] = from_bf16(u >> 16);
                  } else {
                    float hi, lo;  // as the tensor core reads them
                    k3::split_tf32_a(val(u), &hi, &lo);
                    A[0][m][sl] = tf32_operand(hi);
                    A[1][m][sl] = tf32_operand(lo);
                  }
                }
                const auto& f = wf[k3::wfrag_index(s, tap, nt, lane)];
                for (int r = 0; r < 2; ++r) {
                  const int sl = k3::b_slot(lane, r), col = k3::b_col(lane);
                  if (bf) {
                    B[0][2 * sl][col] = from_bf16(f[r]);
                    B[0][2 * sl + 1][col] = from_bf16(f[r] >> 16);
                  } else {
                    B[0][sl][col] = val(f[r]);
                    B[1][sl][col] = val(f[2 + r]);
                  }
                }
              }
              // float32: lo*hi, hi*lo, hi*hi (the kernel's order); bf16: one
              const int parts[3][2] = {{1, 0}, {0, 1}, {0, 0}};
              for (int p = bf ? 2 : 0; p < 3; ++p)
                for (int lane = 0; lane < 32; ++lane)
                  for (int r = 0; r < 4; ++r) {
                    const int m = k3::c_row(lane, r), nn = k3::c_col(lane, r);
                    float d = 0.0f;
                    for (int k = 0; k < K; ++k)
                      d += A[parts[p][0]][m][k] * B[parts[p][1]][k][nn];
                    acc[warp][lane][mt][nt][r] += d;
                  }
            }
    }
    for (int warp = 0; warp < k3::kWarps; ++warp)
      for (int lane = 0; lane < 32; ++lane)
        for (int mt = 0; mt < k3::kMTiles; ++mt)
          for (int nt = 0; nt < k3::kNTiles; ++nt)
            for (int r = 0; r < 4; ++r) {
              const int yy = y0 + warp, xx = x0 + 16 * mt + k3::c_row(lane, r);
              const int o = nt * 8 + k3::c_col(lane, r);
              if (o < oc && yy < h && xx < w)
                y[((long)(b * oc + o) * h + yy) * w + xx] = acc[warp][lane][mt][nt][r];
            }
  }
  for (float v : y) std::printf("%.9g\n", v);
}

// K2's tiled path (up = down = 1) emulated item by item: the work items of
// plane groups, the 16-byte chunk staging with its masks, each thread's strip.
// Staged words never written hold NaN; an output written twice aborts.
template <int GW, int GH>
static void run_tile(int vec, int planes, int h, int w, int px0, int py0, int fh, int fw,
                     const std::vector<float>& taps, const std::vector<float>& x, int oh,
                     int ow) {
  using M = shgan::FirMode<GW, GH>;
  const int tiles_x = (ow + GW - 1) / GW, tiles_y = (oh + GH - 1) / GH;
  const int groups = (planes + M::kPlanes - 1) / M::kPlanes;
  const int th = GH + fh - 1, tw = GW + fw - 1, nch = shgan::fir_chunks(tw, vec);
  const int row_f = shgan::fir_row_elems(GW, fw, vec);
  const long long total = (long long)planes * h * w;
  const long long granules = (total + vec - 1) / vec * vec;
  std::vector<float> y((long long)planes * oh * ow, -1e30f);
  std::vector<float> buf(M::kPlanes * th * row_f);
  for (int item = 0; item < groups * tiles_x * tiles_y; ++item) {
    int g, ty0, tx0;
    shgan::fir_item(item, tiles_x, tiles_y, GW, GH, &g, &ty0, &tx0);
    std::fill(buf.begin(), buf.end(), std::nanf(""));
    const int x0 = tx0 - px0;
    const int tw_i = shgan::fir_window(tx0, ow, GW, fw);
    const int th_i = shgan::fir_window(ty0, oh, GH, fh);
    // the flat index of window element (iy, 0) of plane slot k
    auto row_start = [&](int k, int iy) {
      return (((long long)g * M::kPlanes + k) * h + ty0 - py0 + iy) * w + x0;
    };
    for (int j = 0; j < M::kPlanes * th * nch; ++j) {
      int k, iy, q;
      shgan::fir_stage_role(j, th, nch, &k, &iy, &q);
      if (iy >= th_i) continue;
      const long long plane = (long long)g * M::kPlanes + k;
      const int sy = ty0 - py0 + iy;
      const long long start = row_start(k, iy);
      const long long at = shgan::fir_chunk_at(start, q, vec);
      const int cc0 = shgan::fir_chunk_col(start, q, vec);
      if (cc0 >= tw_i) continue;
      float v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (plane < planes && sy >= 0 && sy < h && shgan::fir_chunk_needed(cc0, vec, x0, w, tw_i)) {
        if (at < 0 || at + vec > granules || at % vec != 0) std::abort();
        for (int e = 0; e < vec; ++e) v[e] = at + e < total ? x[at + e] : std::nanf("");
        if (!shgan::fir_chunk_in_row(cc0, vec, x0, w))
          for (int e = 0; e < vec; ++e)
            if (!shgan::fir_col_in_row(cc0 + e, x0, w)) v[e] = 0.0f;
      }
      float* row = &buf[(k * th + iy) * row_f];
      for (int e = 0; e < vec; ++e) row[q * vec + e] = v[e];
    }
    for (int t = 0; t < shgan::kFirThreads; ++t) {
      int k, s, c;
      shgan::fir_thread(t, GW, GH, &k, &s, &c);
      const long long plane = (long long)g * M::kPlanes + k;
      if (plane >= planes || tx0 + c >= ow) continue;
      const int s0 = shgan::fir_row_shift(row_start(k, 0), vec);
      auto at = [&](int r, int cc) {
        return buf[k * th * row_f + shgan::fir_staged_pos(r, cc, row_f, s0, w, vec)];
      };
      auto row = [&](int r, int cc, auto& v) {
        for (int j = 0; j < (int)(sizeof(v) / sizeof(float)); ++j) v[j] = at(r, cc + j);
      };
      float out[shgan::kStrip][shgan::kCols];
      if (fh == 4 && fw == 4) {
        shgan::fir_strip_fixed<4, 4>(row, taps.data(), s * shgan::kStrip, c, out);
      } else {
        shgan::fir_strip(at, taps.data(), fh, fw, s * shgan::kStrip, c, out);
      }
      for (int r = 0; r < shgan::kStrip; ++r)
        for (int u = 0; u < shgan::kCols; ++u) {
          const int oy = ty0 + s * shgan::kStrip + r, ox = tx0 + c + u;
          if (oy >= oh || ox >= ow) continue;
          float& dst = y[(plane * oh + oy) * ow + ox];
          if (dst != -1e30f) std::abort();
          dst = out[r][u];
        }
    }
  }
  for (float v : y) std::printf("%.9g\n", v);
}

// tile vec planes h w px0 px1 py0 py1 fh fw taps... x... -> out_h out_w,
// then the outputs of every plane
static void tile() {
  int vec, planes, h, w, px0, px1, py0, py1, fh, fw;
  std::scanf("%d %d %d %d %d %d %d %d %d %d", &vec, &planes, &h, &w, &px0, &px1, &py0, &py1,
             &fh, &fw);
  std::vector<float> taps(fh * fw), x((long)planes * h * w);
  for (float& t : taps) std::scanf("%f", &t);
  for (float& v : x) std::scanf("%f", &v);
  const int oh = shgan::upfirdn_out_size(h, 1, 1, py0, py1, fh);
  const int ow = shgan::upfirdn_out_size(w, 1, 1, px0, px1, fw);
  std::printf("%d %d\n", oh, ow);
  switch (shgan::fir_tile_mode(oh, ow, fh, fw)) {
    case 0: run_tile<64, 64>(vec, planes, h, w, px0, py0, fh, fw, taps, x, oh, ow); break;
    case 1: run_tile<32, 32>(vec, planes, h, w, px0, py0, fh, fw, taps, x, oh, ow); break;
    default: run_tile<16, 16>(vec, planes, h, w, px0, py0, fh, fw, taps, x, oh, ow); break;
  }
}

// K2's resampling paths (down = 2, up = 2) emulated item by item, as
// run_tile: the mode's work items, the chunk staging (split by parity for
// down = 2), each thread's strip or quads, through the header's functions.
// Staged words never written hold NaN; an output written twice aborts.
template <bool UP, int G>
static void run_resample(int vec, int planes, int h, int w, int px0, int py0, int fh, int fw,
                         const std::vector<float>& taps, const std::vector<float>& x, int oh,
                         int ow) {
  using M = shgan::ResampleMode<UP, G>;
  const bool fixed = shgan::fir_resample_fixed(UP, fh, fw, px0, py0);
  const int max_taps = fixed ? 4 : shgan::kMaxTaps;
  const int rows = shgan::fir_resample_extent(UP, G, max_taps);
  const int row_f = shgan::fir_chunks(shgan::fir_resample_extent(UP, G, max_taps), vec) * vec;
  const int tiles_x = (ow + G - 1) / G, tiles_y = (oh + G - 1) / G;
  const int groups = (planes + M::kPlanes - 1) / M::kPlanes;
  const int th = shgan::fir_resample_window(UP, 0, G, G, fh, py0);
  const int nch = shgan::fir_chunks(shgan::fir_resample_window(UP, 0, G, G, fw, px0), vec);
  if (th > rows || nch * vec > row_f) std::abort();
  const long long total = (long long)planes * h * w;
  const long long granules = (total + vec - 1) / vec * vec;
  std::vector<float> y((long long)planes * oh * ow, -1e30f);
  std::vector<float> buf(M::kPlanes * rows * row_f);
  auto put = [&](long long plane, int oy, int ox, float v) {
    float& dst = y[(plane * oh + oy) * ow + ox];
    if (dst != -1e30f) std::abort();
    dst = v;
  };
  for (int item = 0; item < groups * tiles_x * tiles_y; ++item) {
    int g, ty0, tx0;
    shgan::fir_item(item, tiles_x, tiles_y, G, G, &g, &ty0, &tx0);
    std::fill(buf.begin(), buf.end(), std::nanf(""));
    const int th_i = shgan::fir_resample_window(UP, ty0, oh, G, fh, py0);
    const int tw_i = shgan::fir_resample_window(UP, tx0, ow, G, fw, px0);
    const int iy0 = shgan::fir_resample_start(UP, ty0, py0);
    const int ix0 = shgan::fir_resample_start(UP, tx0, px0);
    auto row_start = [&](int k, int iy) {
      return (((long long)g * M::kPlanes + k) * h + iy0 + iy) * w + ix0;
    };
    for (int j = 0; j < M::kPlanes * th * nch; ++j) {
      int k, iy, q;
      shgan::fir_stage_role(j, th, nch, &k, &iy, &q);
      if (iy >= th_i) continue;
      const long long plane = (long long)g * M::kPlanes + k;
      const int sy = iy0 + iy;
      const long long start = row_start(k, iy);
      const long long at = shgan::fir_chunk_at(start, q, vec);
      const int cc0 = shgan::fir_chunk_col(start, q, vec);
      if (cc0 >= tw_i) continue;
      float v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (plane < planes && sy >= 0 && sy < h && shgan::fir_chunk_needed(cc0, vec, ix0, w, tw_i)) {
        if (at < 0 || at + vec > granules || at % vec != 0) std::abort();
        for (int e = 0; e < vec; ++e) v[e] = at + e < total ? x[at + e] : std::nanf("");
        if (!shgan::fir_chunk_in_row(cc0, vec, ix0, w))
          for (int e = 0; e < vec; ++e)
            if (!shgan::fir_col_in_row(cc0 + e, ix0, w)) v[e] = 0.0f;
      }
      float* row = &buf[(k * rows + iy) * row_f];
      for (int e = 0; e < vec; ++e)
        row[UP ? q * vec + e : shgan::fir_split_chunk(q, e, row_f, vec)] = v[e];
    }
    for (int t = 0; t < shgan::kFirThreads; ++t) {
      int k, s, c;
      if (UP) shgan::fir_up_thread(t, G, &k, &s, &c);
      else shgan::fir_down_thread(t, G, &k, &s, &c);
      const long long plane = (long long)g * M::kPlanes + k;
      const float* win = &buf[k * rows * row_f];
      const int s0 = shgan::fir_row_shift(row_start(k, 0), vec);
      if (plane >= planes) continue;
      if (UP) {
        const int ox0 = tx0 + 2 * c, oy0 = ty0 + 2 * shgan::kUpStrip * s;
        if (ox0 >= ow || oy0 >= oh) continue;
        auto at = [&](int r, int cc) {
          return win[shgan::fir_staged_pos(r, cc, row_f, s0, w, vec)];
        };
        float out[shgan::kUpStrip][2][shgan::kUpOut];
        if (fixed) {
          auto row = [&](int r, float (&v)[shgan::kUpQuads + 2]) {
            for (int j = 0; j < shgan::kUpQuads + 2; ++j) v[j] = at(r, c + j);
          };
          shgan::fir_up_quads_fixed4(row, taps.data(), shgan::kUpStrip * s, out);
        } else {
          shgan::fir_up_quads(at, taps.data(), fh, fw, px0, py0, shgan::kUpStrip * s, c, out);
        }
        for (int r = 0; r < 2 * shgan::kUpStrip && oy0 + r < oh; ++r)
          for (int e = 0; e < shgan::kUpOut; ++e)
            if (ox0 + e < ow) put(plane, oy0 + r, ox0 + e, out[r / 2][r % 2][e]);
      } else {
        const int ox = tx0 + c, oy0 = ty0 + shgan::kDownStrip * s;
        if (ox >= ow || oy0 >= oh) continue;
        float out[shgan::kDownStrip];
        if (fixed) {
          auto row = [&](int r, float (&v)[4]) {
            shgan::fir_down_row(win, r, c, row_f, s0, w, vec, v);
          };
          shgan::fir_down_strip_fixed<4, 4>(row, taps.data(), 2 * shgan::kDownStrip * s, out);
        } else {
          auto at = [&](int r, int cc) {
            return win[shgan::fir_split_pos(r, cc, row_f, s0, w, vec)];
          };
          shgan::fir_down_strip(at, taps.data(), fh, fw, 2 * shgan::kDownStrip * s, c, out);
        }
        for (int r = 0; r < shgan::kDownStrip && oy0 + r < oh; ++r) put(plane, oy0 + r, ox, out[r]);
      }
    }
  }
  for (float v : y) std::printf("%.9g\n", v);
}

// resample up vec planes h w px0 px1 py0 py1 fh fw taps... x... -> mode,
// out_h, out_w, then the outputs of every plane (up: 1 = up 2, 0 = down 2)
static void resample() {
  int up, vec, planes, h, w, px0, px1, py0, py1, fh, fw;
  std::scanf("%d %d %d %d %d %d %d %d %d %d %d", &up, &vec, &planes, &h, &w, &px0, &px1, &py0,
             &py1, &fh, &fw);
  std::vector<float> taps(fh * fw), x((long)planes * h * w);
  for (float& t : taps) std::scanf("%f", &t);
  for (float& v : x) std::scanf("%f", &v);
  const int f = up ? 2 : 1, d = up ? 1 : 2;
  const int oh = shgan::upfirdn_out_size(h, f, d, py0, py1, fh);
  const int ow = shgan::upfirdn_out_size(w, f, d, px0, px1, fw);
  const int mode = shgan::fir_resample_mode(up, oh, ow, fh, fw, px0, py0);
  std::printf("%d %d %d\n", mode, oh, ow);
  if (up) {
    switch (mode) {
      case 0: run_resample<true, 64>(vec, planes, h, w, px0, py0, fh, fw, taps, x, oh, ow); break;
      case 1: run_resample<true, 32>(vec, planes, h, w, px0, py0, fh, fw, taps, x, oh, ow); break;
      default: run_resample<true, 16>(vec, planes, h, w, px0, py0, fh, fw, taps, x, oh, ow);
    }
  } else {
    switch (mode) {
      case 0: run_resample<false, 32>(vec, planes, h, w, px0, py0, fh, fw, taps, x, oh, ow); break;
      case 1: run_resample<false, 16>(vec, planes, h, w, px0, py0, fh, fw, taps, x, oh, ow); break;
      default: run_resample<false, 8>(vec, planes, h, w, px0, py0, fh, fw, taps, x, oh, ow);
    }
  }
}

// Reads commands from stdin, one per line:
//   philox k0 k1 c0 c1 c2 c3        -> 4 words
//   noise k0 k1 batch res           -> batch*res*res floats, kernel layout
//   fir h w upx upy downx downy px0 px1 py0 py1 fh fw taps... x...
//                                   -> out_h out_w, then the outputs
//   tile vec planes h w px0 px1 py0 py1 fh fw taps... x...
//                                   -> the tiled kernel's outputs (up = down = 1)
//   tilemode out_h out_w fh fw      -> its tile mode
//   resample up vec planes h w px0 px1 py0 py1 fh fw taps... x...
//                                   -> the resampling kernel's mode, out_h,
//                                      out_w and outputs (up 1: up = 2, 0:
//                                      down = 2)
//   route upx upy downx downy aligned fh fw px0 py0
//                                   -> the kernel a call takes (fir_route),
//                                      and whether a resampling call takes
//                                      the unrolled 4x4 code
//   conv3 bf n c o h w weights... x... -> K3 emulated (bf: 0 float32, 1 bf16)
//   tf32dot K a... b...             -> 3xTF32 and single-TF32 dot products
//   tf32 v                          -> TF32 high part and residual of v, both
//                                      splits
//   nbaplan n c res cpt             -> the fused epilogue's launch rule
//   nbamap n c res cpt per          -> the fused epilogue's launch and coverage
//   nba ...                         -> the fused epilogue emulated (nba_run)
//   nbaop alpha gain clamp m x d nz b (m times) -> m results' float32 bits
//   nbagrad ...                     -> the grad kernel emulated (nbagrad_run)
//   nbagradop alpha gain clamp m dy x d nz b (m times) -> act'(pre) * dy bits
//   nbagradplan n c res cpt         -> the grad kernel's launch rule (threads,
//                                      chunks, calls a block, work floats,
//                                      channels a block, groups a row)
//   bf16 m v...                     -> the bf16 bits of m floats
int main() {
  char cmd[16];
  while (std::scanf("%15s", cmd) == 1) {
    std::string c(cmd);
    if (c == "nbaplan") {
      int n, ch, res, cpt;
      std::scanf("%d %d %d %d", &n, &ch, &res, &cpt);
      const nba::Launch L = nba::plan(n, ch, res, cpt, 0);
      std::printf("%d %d %d %d %lld\n", L.per, L.chunks, L.bt, L.bc, L.tiles);
    } else if (c == "nbamap") {
      nbamap();
    } else if (c == "nba") {
      nba_run();
    } else if (c == "nbaop") {
      nba::Act a;
      int m;
      std::scanf("%f %f %f %d", &a.alpha, &a.gain, &a.clamp, &m);
      for (int i = 0; i < m; ++i) {
        float x, d, nz, b;
        std::scanf("%f %f %f %f", &x, &d, &nz, &b);
        std::printf("%u\n", bits(nba::apply(x, d, nz, b, a)));
      }
    } else if (c == "nbagrad") {
      nbagrad_run();
    } else if (c == "nbagradop") {
      nba::Act a;
      int m;
      std::scanf("%f %f %f %d", &a.alpha, &a.gain, &a.clamp, &m);
      for (int i = 0; i < m; ++i) {
        float dy, x, d, nz, b;
        std::scanf("%f %f %f %f %f", &dy, &x, &d, &nz, &b);
        std::printf("%u\n", bits(nba::act_grad(dy, x, d, nz, b, a)));
      }
    } else if (c == "nbagradplan") {
      int n, ch, res, cpt;
      std::scanf("%d %d %d %d", &n, &ch, &res, &cpt);
      const nba::GradLaunch G = nba::grad_plan(n, ch, res, cpt);
      std::printf("%d %d %lld %lld %d %d\n", G.threads, G.chunks, G.calls_per_block,
                  nba::grad_work_floats(n, ch, res), G.group, G.groups);
    } else if (c == "bf16") {
      int m;
      std::scanf("%d", &m);
      for (int i = 0; i < m; ++i) {
        float v;
        std::scanf("%f", &v);
        std::printf("%u\n", (unsigned)nba::to_bf16(v));
      }
    } else if (c == "philox") {
      unsigned k0, k1;
      shgan::U32x4 ctr;
      std::scanf("%u %u %u %u %u %u", &k0, &k1, &ctr.v[0], &ctr.v[1],
                 &ctr.v[2], &ctr.v[3]);
      shgan::U32x4 o = shgan::philox4x32_10(ctr, k0, k1);
      std::printf("%u %u %u %u\n", o.v[0], o.v[1], o.v[2], o.v[3]);
    } else if (c == "noise" || c == "noiserows") {
      // noise k0 k1 batch res; noiserows k0 k1 batch res row0: K1's launch
      unsigned k0, k1;
      int batch, res;
      long long row0 = 0;
      std::scanf("%u %u %d %d", &k0, &k1, &batch, &res);
      if (c == "noiserows") std::scanf("%lld", &row0);
      const long plane = (long)res * res, half = plane / 2;
      std::vector<float> out(batch * plane);
      for (int row = 0; row < batch; ++row)
        for (long call = 0; call < plane / 4; ++call) {
          float cs[2], sn[2];
          shgan::noise_quad((unsigned)call, shgan::noise_row(row0, row), k0, k1, cs, sn);
          float* base = out.data() + row * plane + 2 * call;
          base[0] = cs[0]; base[1] = cs[1];
          base[half] = sn[0]; base[half + 1] = sn[1];
        }
      for (float v : out) std::printf("%.9g\n", v);
    } else if (c == "conv3") {
      conv3();
    } else if (c == "tf32dot") {
      // tf32dot K a... b... -> the 3xTF32 and the single-TF32 sums, taken
      // as K3's mma loop takes them (a split per fragment load, b once):
      // per 8-deep step, residual terms first
      int K;
      std::scanf("%d", &K);
      std::vector<float> av(K), bv(K);
      for (float& v : av) std::scanf("%f", &v);
      for (float& v : bv) std::scanf("%f", &v);
      float three = 0.0f, one = 0.0f;
      for (int k0 = 0; k0 < K; k0 += 8) {
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int k = k0; k < k0 + 8 && k < K; ++k) {
          float ah, al, bh, bl;
          k3::split_tf32_a(av[k], &ah, &al);
          al = tf32_operand(al);
          k3::split_tf32(bv[k], &bh, &bl);
          d[0] += al * bh; d[1] += ah * bl; d[2] += ah * bh;
          d[3] += k3::tf32_rna(av[k]) * k3::tf32_rna(bv[k]);
        }
        three += d[0]; three += d[1]; three += d[2];
        one += d[3];
      }
      std::printf("%.9g %.9g\n", three, one);
    } else if (c == "tf32") {
      float v, h, l, ha, la;
      std::scanf("%f", &v);
      k3::split_tf32(v, &h, &l);
      k3::split_tf32_a(v, &ha, &la);
      std::printf("%.9g %.9g %u %u %.9g %.9g\n", h, l, bits(h), bits(l), ha, la);
    } else if (c == "tile") {
      tile();
    } else if (c == "resample") {
      resample();
    } else if (c == "route") {
      int upx, upy, dx, dy, aligned, fh, fw, px0, py0;
      std::scanf("%d %d %d %d %d %d %d %d %d", &upx, &upy, &dx, &dy, &aligned, &fh, &fw, &px0,
                 &py0);
      const int route = shgan::fir_route(upx, upy, dx, dy, aligned != 0);
      std::printf("%d %d\n", route,
                  (int)shgan::fir_resample_fixed(route == shgan::kRouteUp2, fh, fw, px0, py0));
    } else if (c == "tilemode") {
      int oh, ow, fh, fw;
      std::scanf("%d %d %d %d", &oh, &ow, &fh, &fw);
      std::printf("%d\n", shgan::fir_tile_mode(oh, ow, fh, fw));
    } else if (c == "fir") {
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


TILE_CASES = [
    # (planes, h, w, pads x0 x1 y0 y1, taps) — the FIR_CASES with
    # up = down = 1; several tiles, ragged; packed small planes (8 a tile
    # at <= 16², 2 at <= 32²) with a partial last group; widths not a
    # multiple of 4 or 8 (each row's chunks start at another offset); pads
    # 1 and 2, where the first tile's window starts left of the plane; the
    # (3, 5) and (8, 8) taps
    (1, 9, 9, (1, 1, 1, 1), (4, 4)),
    (1, 8, 8, (2, 2, 2, 2), (4, 4)),
    (1, 8, 9, (-1, 2, 0, -2), (3, 5)),
    (1, 5, 5, (0, 0, 0, 0), (1, 1)),
    (2, 70, 45, (1, 1, 1, 1), (4, 4)),
    (1, 66, 33, (2, 2, 2, 2), (4, 4)),
    (1, 40, 37, (-3, 2, 4, -1), (3, 5)),
    (1, 34, 34, (0, 0, 0, 0), (8, 8)),
    (11, 8, 8, (2, 2, 2, 2), (4, 4)),     # encoder blur at 8²: 9² out
    (19, 9, 9, (1, 1, 1, 1), (4, 4)),     # synthesis up FIR at 8²
    (5, 17, 17, (1, 1, 1, 1), (4, 4)),    # 16² out
    (3, 30, 30, (2, 2, 2, 2), (4, 4)),    # 31² out, two planes a tile
    (3, 13, 13, (1, 1, 1, 1), (8, 8)),
    (4, 10, 11, (2, 1, 1, 2), (3, 5)),
    (3, 33, 65, (1, 1, 1, 1), (4, 4)),
    (2, 20, 130, (2, 2, 2, 2), (4, 4)),
    (2, 21, 77, (2, 2, 1, 1), (4, 4)),
    (2, 36, 100, (1, 2, 2, 1), (8, 8)),
    (2, 129, 129, (1, 1, 1, 1), (4, 4)),  # 64 x 64 tiles
    (1, 129, 189, (1, 2, 1, 1), (4, 4)),
    (1, 135, 135, (0, 0, 0, 0), (8, 8)),
]


@pytest.mark.parametrize("out,mode", [
    (1025, 0), (512, 0), (513, 0), (257, 0), (64, 0), (33, 0), (129, 1),
    (65, 1), (32, 1), (17, 1), (16, 2), (9, 2), (8, 2)])
def test_upfirdn_tile_mode_stages_least(harness, out, mode):
    """The tile mode of a 4x4-tap call on an out x out plane: 64², 32² or 16²
    tiles, whichever stages the fewest input elements (each tile's window
    clipped to the plane) plus a fixed cost per work item."""
    assert int(harness(f"tilemode {out} {out} 4 4")[0]) == mode


def _fir_inputs(seed, taps, shape):
    rng = np.random.RandomState(seed)
    return (rng.randn(*taps).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _run_fir(harness, h, w, up, down, pads, taps):
    t, x = _fir_inputs(h * 31 + w, taps, (h, w))
    cmd = " ".join(map(str, (h, w, up[0], up[1], down[0], down[1]) + pads
                       + taps))
    vals = " ".join(f"{v:.9g}" for v in np.concatenate([t.ravel(),
                                                        x.ravel()]))
    out = harness(f"fir {cmd} {vals}")
    oh, ow = int(out[0]), int(out[1])
    assert oh == out_size(h, up[1], down[1], pads[2], pads[3], taps[0])
    assert ow == out_size(w, up[0], down[0], pads[0], pads[1], taps[1])
    got = np.array(out[2:], np.float32).reshape(oh, ow)
    want = fir_plain(torch.from_numpy(x)[None, None], t, up, down,
                     pads)[0, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("vec", [4, 8])   # 16-byte chunks: float32, bf16
@pytest.mark.parametrize("planes,h,w,pads,taps", TILE_CASES)
def test_upfirdn_tiled_header_matches_plain(harness, planes, h, w, pads,
                                            taps, vec):
    t, x = _fir_inputs(planes * 1000 + h * 31 + w, taps, (planes, h, w))
    if taps == (4, 4) and (planes + h) % 2:   # the main path's taps
        t = correlation_taps(setup_filter([1, 3, 3, 1]), gain=4)
    cmd = " ".join(map(str, (vec, planes, h, w) + pads + taps))
    vals = " ".join(f"{v:.9g}" for v in np.concatenate([t.ravel(),
                                                        x.ravel()]))
    out = harness(f"tile {cmd} {vals}")
    oh, ow = int(out[0]), int(out[1])
    got = np.array(out[2:], np.float32).reshape(planes, oh, ow)
    want = fir_plain(torch.from_numpy(x)[None], t, (1, 1), (1, 1),
                     pads)[0].numpy()
    # every output written once and from staged words only (NaN otherwise)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("h,w,up,down,pads,taps", FIR_CASES)
def test_upfirdn_header_matches_plain(harness, h, w, up, down, pads, taps):
    _run_fir(harness, h, w, up, down, pads, taps)


RESAMPLE_CASES = [
    # (up, planes, h, w, pads x0 x1 y0 y1, taps); up False: down = 2.
    # D's 1x1 skips at every comodgan_d256 resolution (down = 2, pads 1; a
    # few planes each, partial plane groups in the 4- and 16-plane modes),
    # then their backward (up = 2, grad_pads (2, 1, 2, 1)) on the skips'
    # outputs; the skip-image upsample (up = 2) of 3 channels, whose
    # backward is the down = 2 call of the skips
    (False, 1, 256, 256, (1, 1, 1, 1), (4, 4)),
    (False, 2, 128, 128, (1, 1, 1, 1), (4, 4)),
    (False, 3, 64, 64, (1, 1, 1, 1), (4, 4)),
    (False, 5, 32, 32, (1, 1, 1, 1), (4, 4)),
    (False, 9, 16, 16, (1, 1, 1, 1), (4, 4)),
    (False, 17, 8, 8, (1, 1, 1, 1), (4, 4)),
    (True, 1, 128, 128, (2, 1, 2, 1), (4, 4)),
    (True, 2, 64, 64, (2, 1, 2, 1), (4, 4)),
    (True, 3, 32, 32, (2, 1, 2, 1), (4, 4)),
    (True, 5, 16, 16, (2, 1, 2, 1), (4, 4)),
    (True, 9, 8, 8, (2, 1, 2, 1), (4, 4)),
    (True, 17, 4, 4, (2, 1, 2, 1), (4, 4)),
    (True, 3, 2, 2, (2, 1, 2, 1), (4, 4)),
    # odd H and W (rows whose chunks start at another offset, and another
    # parity, in each row), signed pads, several tiles with ragged edges
    (False, 2, 37, 29, (1, 1, 1, 1), (4, 4)),
    (False, 3, 21, 75, (-1, 2, 3, -2), (4, 4)),
    (False, 1, 131, 69, (2, 1, 1, 2), (4, 4)),
    (True, 2, 19, 13, (2, 1, 2, 1), (4, 4)),
    (True, 1, 45, 67, (0, 2, -2, 1), (4, 4)),
    # other taps, and up = 2 with an odd pad: the general tap loop
    (False, 2, 35, 33, (2, 1, 0, 3), (3, 5)),
    (False, 2, 40, 23, (3, 4, 4, 3), (8, 8)),
    (False, 3, 9, 10, (0, 0, 0, 0), (1, 1)),
    (True, 3, 11, 30, (1, 2, 3, 0), (4, 4)),
    (True, 2, 15, 14, (-1, 2, -3, 2), (4, 4)),
    (True, 2, 17, 9, (-2, 3, 0, -1), (3, 5)),
    (True, 1, 33, 40, (4, 3, 3, 4), (8, 8)),
    (True, 2, 20, 21, (0, 0, 0, 0), (1, 1)),
]


@pytest.mark.parametrize("vec", [4, 8])   # 16-byte chunks: float32, bf16
@pytest.mark.parametrize("up,planes,h,w,pads,taps", RESAMPLE_CASES)
def test_upfirdn_resample_header_matches_plain(harness, up, planes, h, w,
                                               pads, taps, vec):
    """K2's down = 2 and up = 2 paths emulated thread by thread (tile mode,
    parity-split staging, the down = 2 strip, the up = 2 polyphase quads)
    against fir_plain: every output written once, from staged words only
    (the staging is NaN until written)."""
    t, x = _fir_inputs(planes * 1000 + h * 31 + w, taps, (planes, h, w))
    if taps == (4, 4) and (planes + h) % 2:   # the main path's taps
        t = correlation_taps(setup_filter([1, 3, 3, 1]), gain=4 if up else 1)
    cmd = " ".join(map(str, (int(up), vec, planes, h, w) + pads + taps))
    vals = " ".join(f"{v:.9g}" for v in np.concatenate([t.ravel(),
                                                        x.ravel()]))
    out = harness(f"resample {cmd} {vals}")
    oh, ow = int(out[1]), int(out[2])
    f = (2, 2) if up else (1, 1)
    d = (1, 1) if up else (2, 2)
    got = np.array(out[3:], np.float32).reshape(planes, oh, ow)
    want = fir_plain(torch.from_numpy(x)[None], t, f, d, pads)[0].numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("up,out,mode", [
    (False, 128, 0), (False, 64, 0), (False, 32, 0), (False, 16, 1),
    (False, 8, 2), (False, 4, 2), (True, 256, 0), (True, 128, 0),
    (True, 64, 0), (True, 32, 1), (True, 16, 2), (True, 8, 2)])
def test_upfirdn_resample_mode_stages_least(harness, up, out, mode):
    """The tile mode of a 4x4-tap resampling call on an out x out plane (D's
    skips and their backward): the fewest staged input elements plus a fixed
    cost per item, as for the stride-1 path."""
    h = out // 2 if up else 2 * out
    pads = (2, 1, 2, 1) if up else (1, 1, 1, 1)
    x = " ".join(["0"] * (h * h))
    got = harness(f"resample {int(up)} 4 1 {h} {h} "
                  + " ".join(map(str, pads)) + " 4 4 " + " ".join(["0"] * 16)
                  + f" {x}")
    assert (int(got[0]), int(got[1])) == (mode, out)


def _route(harness, up, down, pads, taps, aligned=True):
    r = harness(f"route {up[0]} {up[1]} {down[0]} {down[1]} {int(aligned)} "
                f"{taps[0]} {taps[1]} {pads[0]} {pads[2]}")
    return int(r[0]), bool(int(r[1]))


def test_upfirdn_route_sends_the_main_paths_resampling_to_the_tiles(harness):
    """fir_route on every K2 call of one shgan_g256 + comodgan_d256 forward
    at batch 8 (chip_smoke.py's list) and on each call's backward (taps
    reversed, factors swapped, grad_pads): stride 1 takes the stride-1
    tiles, down = 2 and up = 2 the resampling tiles with the unrolled 4x4
    code; an unaligned tensor and up = down = 2 take the generic kernel."""
    import importlib
    import sys

    from shgan_torch.ops.upfirdn2d import grad_pads
    from shgan_torch.runtime.config import model_cfg_bank
    from test_torch_models import REPO

    sys.path.insert(0, REPO)
    smoke = importlib.import_module("chip_smoke")
    bank = model_cfg_bank()
    calls = smoke.train_fir_calls(bank("shgan_g256"), bank("comodgan_d256"),
                                  8)
    taps = correlation_taps(setup_filter([1, 3, 3, 1]))
    want = {1: 1, 2: 3}   # up factor -> route (kRouteTile, kRouteUp2)
    seen = set()
    for _site, _r, shape, up, down, pads, _gain in calls:
        ups, downs = (up, up), (down, down)
        bwd = grad_pads(shape[2], shape[3], taps, ups, downs, pads)
        for u, d, p in ((ups, downs, pads), (downs, ups, bwd)):
            route, fixed = _route(harness, u, d, p, taps.shape)
            assert route == (2 if d == (2, 2) else want[u[0]]), (u, d, p)
            assert fixed or route == 1
            seen.add(route)
    assert seen == {1, 2, 3}
    assert _route(harness, (2, 2), (1, 1), (2, 1, 2, 1), (4, 4),
                  aligned=False)[0] == 0
    assert _route(harness, (2, 2), (2, 2), (2, 2, 2, 2), (4, 4))[0] == 0
    assert _route(harness, (2, 1), (1, 1), (2, 1, 0, 0), (4, 1))[0] == 0
    assert _route(harness, (2, 2), (1, 1), (1, 2, 2, 1), (4, 4)) == (3, False)


CONV3_CASES = [
    # (n, c, o, h, w) — one whole tile; ragged rows and columns; W not a
    # multiple of the 64-wide tile, of 4 or of 8 (the pixel staging path);
    # C not a multiple of the 8- or 16-channel stage; O < 32 (part of an n8
    # tile unused); C = 32 with O < 32; a W that is a multiple of 8 but not
    # of the tile
    (1, 8, 8, 8, 64),
    (2, 32, 32, 9, 70),
    (1, 5, 3, 13, 21),
    (1, 12, 32, 17, 130),
    (1, 32, 7, 3, 5),
    (1, 32, 20, 18, 96),
    (1, 17, 32, 16, 72),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c,o,h,w", CONV3_CASES)
def test_conv3x3_lowch_mma_loop_matches_plain(harness, n, c, o, h, w, dtype):
    """K3's staging, fragment ownership and mma loop, emulated on the host
    block by block, against the plain version."""
    rng = np.random.RandomState(n * 1000 + c * 37 + w)
    wt = (rng.randn(o, c, 3, 3) / np.sqrt(9 * c)).astype(np.float32)
    x = rng.randn(n, c, h, w).astype(np.float32)
    bf = dtype == "bfloat16"
    if bf:   # bf16-exact inputs and weights: the harness reads their bits
        wt = torch.from_numpy(wt).bfloat16().float().numpy()
        x = torch.from_numpy(x).bfloat16().float().numpy()
    vals = " ".join(f"{v:.9g}" for v in np.concatenate([wt.ravel(),
                                                        x.ravel()]))
    got = np.array(harness(f"conv3 {int(bf)} {n} {c} {o} {h} {w} {vals}"),
                   np.float64).reshape(n, o, h, w)
    want = conv3x3_lowch_plain(torch.from_numpy(x),
                               torch.from_numpy(wt)).numpy()
    # every output written once (an unwritten one reads -1e30, a staged
    # word never written reads NaN); the products are exact in bf16 and
    # ~float32 in 3xTF32, the sums in float32 in another order
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def _dot_case(seed, k):
    rng = np.random.RandomState(seed)
    a = rng.randn(k).astype(np.float32)
    b = (rng.randn(k) / np.sqrt(k)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("seed", range(4))
def test_3xtf32_dot_keeps_float32_accuracy(harness, seed):
    """The 3xTF32 sum over K = 9*32 (one output of a C = 32 conv) stays within
    1e-5 of float64; a single TF32 product per term does not."""
    k = 9 * 32
    a, b = _dot_case(seed, k)
    vals = " ".join(f"{v:.9g}" for v in np.concatenate([a, b]))
    three, one = (float(v) for v in harness(f"tf32dot {k} {vals}"))
    exact = float(np.dot(a.astype(np.float64), b.astype(np.float64)))
    assert abs(three - exact) <= 1e-5
    assert abs(one - exact) > 1e-5


@pytest.mark.parametrize("v", [1.0, -3.14159274, 1.00048828, 1.00036621,
                               6.1e-5, 1e30])
def test_tf32_split_is_exact(harness, v):
    """hi is v rounded to 10 mantissa bits (nearest, ties away from zero),
    lo the TF32 rounding of the rest; hi + lo is v to ~2^-22.  The input's
    split in the mma loop has the same hi and keeps the rest exactly."""
    h, lo, hb, lb, ha, la = harness(f"tf32 {v!r}")
    # nine digits give each float32 back exactly
    h, lo, ha, la = (float(np.float32(t)) for t in (h, lo, ha, la))
    hb, lb = int(hb), int(lb)
    f = np.float32(v)
    assert hb & 0x1FFF == 0 and lb & 0x1FFF == 0
    assert abs(np.float32(h) - f) <= abs(np.spacing(f)) * 2 ** 12
    assert abs((np.float64(h) + lo) - np.float64(f)) <= abs(f) * 2 ** -21
    # the mma loop's split of the input: the same high part, the rest exact
    assert ha == h and ha + la == float(f)


# ---- the fused synthesis epilogue (csrc/noise_bias_act.cuh) ----------------

NBA_MAP_CASES = [
    # (n, c, res): the 4² layer (4 Philox calls a row) with C = 512 and one
    # channel past a whole lane group; small C; 64² and 512² planes
    (2, 512, 4), (1, 513, 4), (3, 5, 8), (2, 512, 8), (2, 33, 64),
    (1, 512, 64), (2, 33, 512), (1, 3, 512),
]


@pytest.mark.parametrize("per", [0, 1, 2, 3, 1 << 20])   # 0: the rule's own
@pytest.mark.parametrize("cpt", [1, 2])
@pytest.mark.parametrize("n,c,res", NBA_MAP_CASES)
def test_noise_bias_act_index_map_covers_each_element_once(harness, n, c, res,
                                                           cpt, per):
    """Every (n, c, h, w) is read and written by exactly one thread, for
    each number of channels a thread may walk (the launch rule's pick, 1,
    2, 3 and all of them)."""
    got_per, chunks, bt, bc, tiles, bad = (
        int(v) for v in harness(f"nbamap {n} {c} {res} {cpt} {per}"))
    assert bad == 0
    assert bt * bc == 256 and tiles * bt * cpt >= res * res // 4
    assert (chunks - 1) * got_per * bc < c <= chunks * got_per * bc


@pytest.mark.parametrize("n,c,res,per,chunks", [
    # every synthesis layer shape of shgan_g512 at batch 8: the blocks come
    # from the channels at 4²-32², one chunk at 512²
    (8, 512, 4, 1, 4), (8, 512, 8, 1, 16), (8, 512, 16, 1, 64),
    (8, 512, 32, 2, 128), (8, 512, 64, 8, 64), (8, 256, 128, 16, 16),
    (8, 128, 256, 32, 4), (8, 64, 512, 64, 1),
    # the 1024² layers of shgan_g1024 at batch 4
    (4, 32, 1024, 32, 1),
])
def test_noise_bias_act_launch_rule(harness, n, c, res, per, chunks):
    """The fewest channel chunks that give 1024 blocks."""
    got = [int(v) for v in harness(f"nbaplan {n} {c} {res} 2")]
    assert got[:2] == [per, chunks]
    assert got[4] * n * chunks >= 1024 or chunks * got[0] * got[3] >= c


NBA_ACTS = [
    # (spec, runtime gain, cpt, per): each activation on another launch
    (None, 0.5, 1, 2),
    ("lrelu_agc(alpha=0.2, gain=sqrt_2)", 1.0, 2, 0),
    ("lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)", 0.7, 2, 1),
]


def _f(v):
    return f"{float(v):.9g}"


@pytest.mark.parametrize("act", NBA_ACTS, ids=["linear", "lrelu",
                                               "lrelu_clamp"])
@pytest.mark.parametrize("has_d,has_b", [(True, True), (True, False),
                                         (False, True), (False, False)])
@pytest.mark.parametrize("mode", ["random", "const", "none"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_noise_bias_act_emulation_matches_plain(harness, dtype, mode, has_d,
                                                has_b, act):
    """The kernel's threads emulated on the host against the plain version
    on the CPU: the same bits where the noise is not drawn (const, none;
    bf16: the float32 result rounded once), libm-vs-torch rounding of the
    Philox normals otherwise."""
    spec, gain, cpt, per = act
    n, c, res = 2, 5, 8
    rng = np.random.RandomState(c * 7 + res + cpt)
    x = (rng.randn(n, c, res, res) * 300).astype(np.float32)
    x.flat[3], x.flat[7], x.flat[11] = np.nan, -0.0, 0.0
    dcoef = (rng.rand(n, c) + 0.5).astype(np.float32)
    bias = (rng.randn(c) * 0.1).astype(np.float32)
    cst = rng.randn(res, res).astype(np.float32)
    s = np.float32(0.3)
    key = noise.noise_key(3, 2 * res)
    bf = dtype == "bfloat16"
    xt = torch.from_numpy(x)
    if bf:
        xt = xt.bfloat16().float()
    alpha, g, clamp = epilogue_act(parse_activation(spec), gain)
    head = (f"nba {int(bf)} {cpt} {per} {n} {c} {res} "
            f"{['none', 'random', 'const'].index(mode)} {key[0]} {key[1]} "
            f"{_f(1.0 if alpha is None else alpha)} {_f(g)} "
            f"{'inf' if clamp is None else _f(clamp)} {int(has_d)} "
            f"{int(has_b)} {_f(s)} 0")
    vals = " ".join(_f(v) for v in np.concatenate(
        [dcoef.ravel(), bias, cst.ravel(), xt.numpy().ravel()]))
    got = np.array(harness(f"{head} {vals}"), np.uint64).astype(
        np.uint32).view(np.float32).reshape(n, c, res, res)
    want = noise_bias_act_plain(
        xt, torch.from_numpy(dcoef) if has_d else None,
        torch.from_numpy(bias) if has_b else None, (alpha, g, clamp),
        noise_mode=mode, noise_key=key, noise_const=torch.from_numpy(cst),
        strength=torch.tensor(s))
    if bf:
        want = want.bfloat16().float()
    want = want.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    if mode != "random":
        np.testing.assert_array_equal(got[ok].view(np.uint32),
                                      want[ok].view(np.uint32))
    elif bf:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want[ok]), 1e-30)))
                      - 7)
        assert (np.abs(got[ok] - want[ok]) <= ulp).all()
    else:
        # the normals' last-ulp differences, which can also move the sums'
        # rounding by an ulp of the result (|x| up to ~1e3 here)
        np.testing.assert_allclose(got[ok], want[ok], rtol=2.5e-7,
                                   atol=1e-5)


NBA_SPECIALS = [0.0, -0.0, 1.0, -1.0, 1e-40, -1e-40, 300.0, -300.0, 1e30,
                -1e30, np.inf, -np.inf, np.nan, 3.14159, -2.5]


@pytest.mark.parametrize("alpha,gain,clamp", [
    (0.2, 2 ** 0.5, 256 * 0.7), (0.2, 1.0, np.inf), (1.0, 0.5, np.inf),
    (0.0, 3.0, 1.0)])
def test_noise_bias_act_element_math_matches_numpy(harness, alpha, gain,
                                                   clamp):
    """x·d + noise + bias, leaky ReLU, gain and clamp, one float32 rounding
    per operation, against numpy bit for bit: NaN stays NaN through the
    clamp, ±0 keep their sign, a -0 bias or noise term changes nothing."""
    f32 = np.float32
    cases = [(x, d, nz, b) for x in NBA_SPECIALS
             for d in (1.0, -0.5, 2.0, np.nan)
             for nz in (-0.0, 0.0, 0.7, np.nan)
             for b in (-0.0, 0.3, -0.3)]
    arr = np.array(cases, np.float32)
    vals = " ".join(_f(v) for v in arr.ravel())
    got = np.array(harness(f"nbaop {_f(alpha)} {_f(gain)} {_f(clamp)} "
                           f"{len(cases)} {vals}"), np.uint64).astype(
        np.uint32).view(np.float32)
    x, d, nz, b = arr.T
    with np.errstate(invalid="ignore", over="ignore"):
        y = x * d + nz + b
        y = np.where(y >= 0, y, y * f32(alpha)) * f32(gain)
        y = np.clip(y, -f32(clamp), f32(clamp))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(y))
    ok = ~np.isnan(y)
    np.testing.assert_array_equal(got[ok].view(np.uint32),
                                  y[ok].view(np.uint32))


def test_noise_bias_act_bf16_rounding_matches_torch(harness):
    """One rounding to bf16 at the store: nearest even, as PyTorch's
    float -> bfloat16 (ties, carries into the exponent, ±0, subnormals,
    infinities); NaN stays NaN (PyTorch's own NaN pattern differs between
    its scalar and vector paths)."""
    rng = np.random.RandomState(9)
    ties = [1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8),
            2.0 - 2.0 ** -9, 3.3895313e38, 1e-39]
    vals = np.array(NBA_SPECIALS + ties + list(rng.randn(200) * 1e3),
                    np.float32)
    got = np.array(harness(f"bf16 {vals.size} "
                           + " ".join(_f(v) for v in vals)), np.int64)
    want = torch.from_numpy(vals).bfloat16().view(torch.int16).numpy()
    nan = np.isnan(vals)
    np.testing.assert_array_equal(got[~nan],
                                  want[~nan].astype(np.int64) & 0xFFFF)
    assert ((got[nan] & 0x7F80) == 0x7F80).all() and (got[nan] & 0x7F).all()


# ---------------------------------------------------------------------------
# the epilogue's gradient kernel (noise_bias_act_grad)
# ---------------------------------------------------------------------------

GRAD_SPECIALS = NBA_SPECIALS + [2.0, 2.0000002, -10.0, -10.000001]


def _act_grad_numpy(dy, x, d, nz, b, alpha, gain, clamp):
    """act'(pre) * dy as autograd of the plain chain takes it: the clamp's
    mask (NaN outside), then * gain, then * alpha where pre < 0 (or NaN)."""
    f32 = np.float32
    with np.errstate(invalid="ignore", over="ignore"):
        pre = x * d + nz + b
        g = dy * f32(gain)
        g = np.where(pre >= 0, g, g * f32(alpha))
        if np.isfinite(clamp):
            y = np.where(pre >= 0, pre, pre * f32(alpha)) * f32(gain)
            g = np.where((y >= -f32(clamp)) & (y <= f32(clamp)), g, f32(0))
    return g.astype(np.float32)


@pytest.mark.parametrize("alpha,gain,clamp", [
    (0.2, 2 ** 0.5, 256 * 0.7), (0.2, 1.0, np.inf), (1.0, 0.5, np.inf),
    (0.2, 2.0, 4.0), (0.0, 3.0, 1.0)])
def test_noise_bias_act_grad_element_math_matches_numpy(harness, alpha, gain,
                                                        clamp):
    """The mask at ±0, NaN and the clamp's edges (y == ±clamp passes, the
    next float does not), bit for bit against numpy, and against autograd
    of the port's lrelu_agc."""
    cases = [(dy, x, d, nz, b) for dy in (1.0, -0.75, np.nan)
             for x in GRAD_SPECIALS for d in (1.0, -0.5, 2.0, np.nan)
             for nz in (-0.0, 0.0, 0.7) for b in (-0.0, 0.3)]
    arr = np.array(cases, np.float32)
    got = np.array(harness(
        f"nbagradop {_f(alpha)} {_f(gain)} {_f(clamp)} {len(cases)} "
        + " ".join(_f(v) for v in arr.ravel())), np.uint64).astype(
        np.uint32).view(np.float32)
    dy, x, d, nz, b = arr.T
    want = _act_grad_numpy(dy, x, d, nz, b, alpha, gain, clamp)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.uint32),
                                  want[ok].view(np.uint32))
    # autograd of the plain activation, on the pre-activations numpy made
    with np.errstate(invalid="ignore", over="ignore"):
        pre = torch.from_numpy(x * d + nz + b).requires_grad_(True)
    y = lrelu_agc(pre, alpha, gain=gain,
                  clamp=None if np.isinf(clamp) else clamp)
    ag, = torch.autograd.grad(y, pre, torch.from_numpy(dy))
    ag = ag.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ag))
    # values, not bits: autograd adds the where's two branches, which can
    # turn a -0 gradient into +0
    np.testing.assert_array_equal(got[ok], ag[ok])


@pytest.mark.parametrize("n,c,res,cpt", [(1, 1, 4, 2), (2, 3, 8, 1),
                                         (8, 512, 4, 2), (8, 256, 64, 2),
                                         (4, 32, 256, 2), (1, 2, 1024, 2),
                                         (3, 5, 6, 1), (8, 512, 32, 4),
                                         (8, 128, 256, 4), (1, 1, 4, 4)])
def test_noise_bias_act_grad_launch_rule(harness, n, c, res, cpt):
    """Blocks of a channel group cover its planes' calls once in runs of a
    multiple of max(cpt, 2) (a thread's calls stay together: 4 in bf16);
    the groups (a power of two up to 8 channels) cover each row's channels
    once, as many channels as leave 1024 blocks at the most chunks a plane
    takes; threads a power of two from a warp to kThreads; the work
    buffer's size agrees with the wrapper's."""
    threads, chunks, cpb, work, group, groups = (int(v) for v in harness(
        f"nbagradplan {n} {c} {res} {cpt}"))
    calls = res * res // 4
    kmax = max(-(-calls // 512), 1)
    assert threads in (32, 64, 128, 256)
    assert chunks >= 1 and chunks * cpb >= calls
    assert cpb % max(cpt, 2) == 0
    assert (chunks - 1) * cpb < calls
    assert group in (1, 2, 4, 8) and groups == -(-c // group)
    assert group == 1 or n * groups * kmax >= 1024
    assert group == 8 or n * -(-c // (2 * group)) * kmax < 1024
    assert chunks == max(min(-(-1024 // (n * groups)), kmax), 1)
    assert work == nba_mod.grad_work_floats(n, c, res)


GRAD_CASES = [
    # (mode, act index in NBA_ACTS, has_d, has_b, cpt, n, c, res)
    ("random", 2, True, True, 2, 2, 3, 8),
    ("random", 1, True, False, 1, 1, 2, 6),
    ("const", 2, True, True, 2, 2, 5, 8),
    ("const", 0, False, True, 1, 2, 2, 4),
    ("none", 2, True, True, 2, 3, 4, 4),
    ("none", 1, False, False, 1, 1, 3, 8),
    ("random", 2, True, True, 2, 2, 2, 64),
    # blocks of 8 and of 4 channels, the last group partial
    ("random", 2, True, True, 2, 2, 4091, 4),
    ("const", 1, True, True, 2, 2, 2045, 4),
]


def _grad_case(harness, mode, act_i, has_d, has_b, cpt, n, c, res,
               mask_only=False, vs=None, bf16_in=False, bf16_out=False,
               row0=0):
    spec, gain, _, _ = NBA_ACTS[act_i]
    rng = np.random.RandomState(n * 31 + c * 7 + res)
    x = (rng.randn(n, c, res, res) * 150).astype(np.float32)
    x.flat[1], x.flat[2] = -0.0, 0.0
    dy = rng.randn(n, c, res, res).astype(np.float32)
    if bf16_in:   # bf16 values: the harness reads them widened to float32
        x, dy = (torch.from_numpy(t).bfloat16().float().numpy()
                 for t in (x, dy))
    dcoef = (rng.rand(n, c) + 0.5).astype(np.float32)
    bias = (rng.randn(c) * 0.1).astype(np.float32)
    cst = rng.randn(res, res).astype(np.float32)
    s = np.float32(0.3)
    key = noise.noise_key(3, 2 * res)
    alpha, g, clamp = epilogue_act(parse_activation(spec), gain)
    head = (f"nbagrad {int(bf16_out)} {cpt} {n} {c} {res} "
            f"{['none', 'random', 'const'].index(mode)} {key[0]} {key[1]} "
            f"{_f(1.0 if alpha is None else alpha)} {_f(g)} "
            f"{'inf' if clamp is None else _f(clamp)} {int(has_d)} "
            f"{int(has_b)} {_f(s)} {int(mask_only)} {int(vs is not None)} "
            f"{_f(0.0 if vs is None else vs)} {row0}")
    vals = " ".join(_f(v) for v in np.concatenate(
        [dcoef.ravel(), bias, cst.ravel(), x.ravel(), dy.ravel()]))
    out = np.array(harness(f"{head} {vals}"), np.uint64).astype(
        np.uint32).view(np.float32)
    kw = dict(dcoefs=torch.from_numpy(dcoef) if has_d else None,
              bias=torch.from_numpy(bias) if has_b else None,
              act=(alpha, g, clamp), noise_mode=mode, noise_key=key,
              noise_const=torch.from_numpy(cst), strength=torch.tensor(s),
              row0=row0)
    return out, x, dy, cst, key, kw


@pytest.mark.parametrize("case", GRAD_CASES)
def test_noise_bias_act_grad_emulation_matches_plain(harness, case):
    """The grad kernel's blocks and threads emulated on the host: dx bit for
    bit the plain version's where the noise is not drawn (libm-vs-torch
    normals otherwise); the noise each element used is K1's own bits (the
    `noise` command) or the const plane; the sums, in the kernel's fixed
    order, within 1e-5 of the sum of their terms' magnitudes."""
    mode, _, has_d, has_b, cpt, n, c, res = case
    out, x, dy, cst, key, kw = _grad_case(harness, *case)
    plane = res * res
    size = n * c * plane
    dx, nus = out[:size].reshape(n, c, res, res), out[size:size + n * plane]
    dd, db, ds = (out[size + n * plane:size + n * plane + n * c],
                  out[-1 - c:-1], out[-1])
    want = nba_mod.noise_bias_act_grad_plain(
        torch.from_numpy(dy), torch.from_numpy(x), **kw)
    if mode == "random":
        k1 = np.array(harness(f"noise {key[0]} {key[1]} {n} {res}"),
                      np.float32)
        np.testing.assert_array_equal(nus.view(np.uint32), k1.view(np.uint32))
        np.testing.assert_allclose(dx, want[0].numpy(), rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(dx.view(np.uint32),
                                      want[0].numpy().view(np.uint32))
        ref = cst.ravel() if mode == "const" else np.zeros(plane, np.float32)
        np.testing.assert_array_equal(nus, np.tile(ref, n))
    g = nba_mod.noise_bias_act_mask_plain(torch.from_numpy(dy),
                                          torch.from_numpy(x),
                                          **kw).numpy().astype(np.float64)
    nu = nus.reshape(n, 1, res, res).astype(np.float64)
    for got, terms, axes in ((dd, g * x, (2, 3)), (db, g, (0, 2, 3)),
                             (np.array([ds]), g * nu, None)):
        ref = terms.sum(axis=axes)
        mag = np.abs(terms).sum(axis=axes)
        assert (np.abs(got - np.ravel(ref)) <= 1e-5 * np.ravel(mag)
                + 1e-30).all()


@pytest.mark.parametrize("vs", [None, 0.6])
@pytest.mark.parametrize("mode", ["random", "const", "none"])
def test_noise_bias_act_grad_mask_mode_matches_plain(harness, mode, vs):
    """The mask-only mode (the double backward): act'(pre) * (v + vs * nu),
    no sums."""
    case = (mode, 2, True, True, 2, 2, 3, 8)
    out, x, v, cst, key, kw = _grad_case(harness, *case, mask_only=True,
                                         vs=vs)
    n, c, res = case[5:]
    got = out[:n * c * res * res].reshape(n, c, res, res)
    assert out.size == n * c * res * res + n * res * res
    want = nba_mod.noise_bias_act_mask_plain(
        torch.from_numpy(v), torch.from_numpy(x),
        vs=None if vs is None else torch.tensor(np.float32(vs)), **kw).numpy()
    if mode == "random" and vs is not None:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


BF16_GRAD_CASES = [GRAD_CASES[0], GRAD_CASES[2], GRAD_CASES[4],
                   GRAD_CASES[5], GRAD_CASES[6]]


@pytest.mark.parametrize("case", BF16_GRAD_CASES)
def test_noise_bias_act_grad_bf16_emulation_matches_plain(harness, case):
    """The grad kernel with bf16 I/O, emulated at its launch (4 Philox
    calls a thread on the 16-byte path, where float32 takes 2): dx is the
    float32 arithmetic's dx on the widened bf16 pair, rounded once to bf16
    (nearest even), and the float32 sums are that arithmetic's on the same
    values in the same launch, bit for bit; against the plain version's
    bf16 mode: dx the same bits where the noise is not drawn (within one
    bf16 ulp of libm-vs-torch normals otherwise), the sums within 1e-5 of
    the sum of their terms' magnitudes."""
    mode, act_i, has_d, has_b, cpt, n, c, res = case
    case = (mode, act_i, has_d, has_b, 4 if cpt == 2 else cpt, n, c, res)
    size = n * c * res * res
    out, x, dy, cst, key, kw = _grad_case(harness, *case, bf16_in=True,
                                          bf16_out=True)
    f32, _, _, _, _, _ = _grad_case(harness, *case, bf16_in=True)
    rounded = torch.from_numpy(f32[:size]).bfloat16().float().numpy()
    np.testing.assert_array_equal(out[:size].view(np.uint32),
                                  rounded.view(np.uint32))
    np.testing.assert_array_equal(out[size:].view(np.uint32),
                                  f32[size:].view(np.uint32))
    want = nba_mod.noise_bias_act_grad_plain(
        torch.from_numpy(dy).bfloat16(), torch.from_numpy(x).bfloat16(),
        **kw)
    assert want[0].dtype == torch.bfloat16
    assert all(w is None or w.dtype == torch.float32 for w in want[1:])
    dx = out[:size].reshape(n, c, res, res)
    wdx = want[0].float().numpy()
    if mode == "random":
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(wdx), 1e-30))) - 7)
        assert (np.abs(dx - wdx) <= ulp).all()
    else:
        np.testing.assert_array_equal(dx.view(np.uint32), wdx.view(np.uint32))
    g = nba_mod.noise_bias_act_mask_plain(
        torch.from_numpy(dy), torch.from_numpy(x), **kw).numpy().astype(
        np.float64)
    nu = out[size:size + n * res * res].reshape(n, 1, res, res).astype(
        np.float64)
    tail = out[size + n * res * res:]
    for got, w, terms, axes in ((tail[:n * c], want[1], g * x, (2, 3)),
                                (tail[n * c:n * c + c], want[2], g,
                                 (0, 2, 3)),
                                (tail[-1:], want[3], g * nu, None)):
        if w is None:
            continue
        mag = np.ravel(np.abs(terms).sum(axis=axes))
        assert (np.abs(got - np.ravel(w.numpy())) <= 1e-5 * mag
                + 1e-30).all()


@pytest.mark.parametrize("vs", [None, 0.6])
@pytest.mark.parametrize("mode", ["random", "const"])
def test_noise_bias_act_grad_bf16_mask_mode(harness, mode, vs):
    """The mask-only mode with bf16 I/O (4 calls a thread): the float32
    result on the widened values rounded once to bf16, against the
    emulated float32 arithmetic bit for bit and the plain version's bf16
    mode (bits, or one bf16 ulp of the normals' differences)."""
    case = (mode, 2, True, True, 4, 2, 3, 8)
    n, c, res = case[5:]
    size = n * c * res * res
    out, x, v, cst, key, kw = _grad_case(harness, *case, mask_only=True,
                                         vs=vs, bf16_in=True, bf16_out=True)
    f32, _, _, _, _, _ = _grad_case(harness, *case, mask_only=True, vs=vs,
                                    bf16_in=True)
    rounded = torch.from_numpy(f32[:size]).bfloat16().float().numpy()
    np.testing.assert_array_equal(out[:size].view(np.uint32),
                                  rounded.view(np.uint32))
    want = nba_mod.noise_bias_act_mask_plain(
        torch.from_numpy(v).bfloat16(), torch.from_numpy(x).bfloat16(),
        vs=None if vs is None else torch.tensor(np.float32(vs)), **kw)
    assert want.dtype == torch.bfloat16
    got, want = out[:size], want.float().numpy().ravel()
    if mode == "random":
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all()
    else:
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("row0", [3, 7, 4_000_000_000])
def test_noise_row_offset_draws_the_larger_batchs_rows(harness, row0):
    """The header's counter row (shgan::noise_row): a launch over rows
    row0... draws what rows row0... of a launch from row 0 draw, bit for
    bit, and the plain version's rows at row0 (libm vs torch rounding)."""
    key = noise.noise_key(9, 8)
    got = np.array(harness(f"noiserows {key[0]} {key[1]} 2 8 {row0}"),
                   np.float32).reshape(2, 8, 8)
    if row0 < 100:
        big = np.array(harness(f"noise {key[0]} {key[1]} {row0 + 2} 8"),
                       np.float32).reshape(row0 + 2, 8, 8)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      big[row0:].view(np.uint32))
    want = noise.philox_normal_plain(key, 2, 8, row0=row0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not np.array_equal(got, noise.philox_normal_plain(key, 2, 8)
                              .numpy())


@pytest.mark.parametrize("mask_only", [False, True])
def test_noise_bias_act_grad_row_offset_emulation(harness, mask_only):
    """The grad kernel emulated at row0 = 3: its normals are rows 3... of
    K1's draw, and its output the plain version's at row0 = 3."""
    out, x, dy, cst, key, kw = _grad_case(
        harness, "random", 2, True, True, 2, 2, 3, 8, mask_only=mask_only,
        row0=3)
    size, plane = x.size, 64
    nus = out[size:size + 2 * plane]
    k1 = np.array(harness(f"noise {key[0]} {key[1]} 5 8"), np.float32)
    np.testing.assert_array_equal(nus.view(np.uint32),
                                  k1[3 * plane:].view(np.uint32))
    fn = (nba_mod.noise_bias_act_mask_plain if mask_only
          else nba_mod.noise_bias_act_grad_plain)
    want = fn(torch.from_numpy(dy), torch.from_numpy(x), **kw)
    want = want if mask_only else want[0]
    np.testing.assert_allclose(out[:size].reshape(x.shape), want.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_noise_bias_act_row_offset_emulation(harness):
    """The fused epilogue emulated at row0 = 3 against the plain version
    at row0 = 3 (libm vs torch rounding of the normals), and unlike row 0."""
    n, c, res = 2, 3, 8
    rng = np.random.RandomState(12)
    x = (rng.randn(n, c, res, res) * 3).astype(np.float32)
    key = noise.noise_key(3, 2 * res)
    alpha, g, clamp = epilogue_act(parse_activation(NBA_ACTS[2][0]),
                                   NBA_ACTS[2][1])
    zeros = np.zeros(n * c + c + res * res, np.float32)
    outs = {}
    for row0 in (0, 3):
        head = (f"nba 0 2 1 {n} {c} {res} 1 {key[0]} {key[1]} {_f(alpha)} "
                f"{_f(g)} {_f(clamp)} 0 0 {_f(0.3)} {row0}")
        vals = " ".join(_f(v) for v in np.concatenate([zeros, x.ravel()]))
        outs[row0] = np.array(harness(f"{head} {vals}"), np.uint64).astype(
            np.uint32).view(np.float32).reshape(x.shape)
    want = noise_bias_act_plain(
        torch.from_numpy(x), act=(alpha, g, clamp), noise_mode="random",
        noise_key=key, strength=torch.tensor(np.float32(0.3)), row0=3)
    np.testing.assert_allclose(outs[3], want.numpy(), rtol=2.5e-7, atol=1e-5)
    assert not np.array_equal(outs[3], outs[0])
