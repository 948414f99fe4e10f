"""StyleGAN2 and CoModGAN synthesis networks (port of the direct path of
``shgan_tpu/models/synthesis.py``: ``StyleGANSynthesisBlock``,
``StyleGANSynthesis``, ``CoModSynthesisBlockFirst``, ``CoModSynthesisBlock``,
``CoModSynthesis`` and the pluralistic ``CoModSynthesisPlur``).

Co-modulation: every affine reads ``concat[w_i, w0]``, the mapping style
beside the encoder's global code.  Random noise: synthesis layer
``conv0``/``conv1`` of the block at resolution ``r`` has layer id ``2r`` /
``2r + 1`` and the 4² block's conv has ``8``, so each noise layer draws its
own stream under the forward's ``noise_seed``.  A block above
``use_fp16_after_res`` runs in bfloat16; the image pyramid stays float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..data.rng import derive_seed
from ..ops.upfirdn2d import setup_filter, upsample2d
from .layers import Conv2dLayer, Dense, SynthesisLayer, ToRGBLayer, randn

PLUR_SALT = 0x9E3779B9   # keys the pluralistic w0 noise off the noise seed


class StyleGANSynthesisBlock(nn.Module):
    """One resolution level of StyleGAN2 synthesis: a learned ``const``
    input (``ic_n == 0``) or ``conv0`` (up 2), then ``conv1``, the skip
    image upsampled and ``torgb`` added; ``res_link`` adds the 1×1 up-2
    skip with gain sqrt(1/2) on both branches."""

    def __init__(self, ic_n, oc_n, w_dim, resolution, rgb_n=None,
                 resample_filter=(1, 3, 3, 1),
                 activation="lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)",
                 res_link=False, use_fp16=False, generator=None):
        super().__init__()
        g = generator
        self.resolution = resolution
        self.res_link = res_link
        self.dtype = torch.bfloat16 if use_fp16 else torch.float32
        self.resample_filter = setup_filter(resample_filter)
        self.has_const = ic_n == 0
        self.num_conv = 1
        if self.has_const:
            self.const = nn.Parameter(randn((oc_n, resolution, resolution),
                                            g))
            self.conv0 = None
        else:
            self.conv0 = SynthesisLayer(
                ic_n, oc_n, 3, w_dim=w_dim, resolution=resolution, up=2,
                activation=activation, resample_filter=resample_filter,
                layer_id=2 * resolution, generator=g)
            self.num_conv += 1
        self.conv1 = SynthesisLayer(
            oc_n, oc_n, 3, w_dim=w_dim, resolution=resolution, up=1,
            activation=activation, resample_filter=None,
            layer_id=2 * resolution + 1, generator=g)
        self.torgb = (ToRGBLayer(oc_n, rgb_n, 1, w_dim=w_dim, generator=g)
                      if rgb_n is not None else None)
        self.num_torgb = 1 if rgb_n is not None else 0
        self.skip = (Conv2dLayer(ic_n, oc_n, 1, bias=False, up=2,
                                 resample_filter=resample_filter, generator=g)
                     if ic_n != 0 and res_link else None)

    def forward(self, x, img, ws, noise_mode="random", noise_seed=None,
                row0=0, rows=None):
        if self.has_const:
            x = self.const.to(self.dtype)[None].expand(
                ws.shape[0], -1, -1, -1)
        else:
            x = x.to(self.dtype)
        y = self.skip(x, gain=np.sqrt(0.5)) if self.skip is not None \
            else None
        w_idx = 0
        if self.conv0 is not None:
            x = self.conv0(x, ws[:, 0], noise_mode=noise_mode,
                           noise_seed=noise_seed, row0=row0, rows=rows)
            w_idx = 1
        x = self.conv1(x, ws[:, w_idx], gain=np.sqrt(0.5) if self.res_link
                       else 1.0, noise_mode=noise_mode,
                       noise_seed=noise_seed, row0=row0, rows=rows)
        if y is not None:
            x = y + x
        if img is not None:
            img = upsample2d(img, self.resample_filter)
        if self.torgb is not None:
            y = self.torgb(x, ws[:, w_idx + 1]).float()
            img = img + y if img is not None else y
        return x, img


class StyleGANSynthesis(nn.Module):
    """StyleGAN2 synthesis pyramid 4² → resolution from ``ws`` [N, num_ws,
    w_dim]; blocks are attributes ``b{res}`` (``b4.const``, ``b8.conv0``,
    ... as in the JAX tree)."""

    def __init__(self, w_dim=512, resolution=256, rgb_n=3, ch_base=16384,
                 ch_max=512, use_fp16_after_res=16,
                 resample_filter=(1, 3, 3, 1),
                 activation="lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)",
                 generator=None):
        super().__init__()
        log2res = int(np.log2(resolution))
        if 2 ** log2res != resolution:
            raise ValueError(resolution)
        self.w_dim = w_dim
        self.resolution = resolution
        self.rgb_n = rgb_n
        self.block_res = [2 ** i for i in range(2, log2res + 1)]
        self.num_ws = 0
        for resi, resj in zip([None] + self.block_res[:-1], self.block_res):
            ch_i = min(ch_base // resi, ch_max) if resi is not None else 0
            ch_j = min(ch_base // resj, ch_max)
            use_fp16 = (use_fp16_after_res is not None
                        and resj > use_fp16_after_res)
            block = StyleGANSynthesisBlock(
                ch_i, ch_j, w_dim=w_dim, resolution=resj, rgb_n=rgb_n,
                resample_filter=resample_filter, activation=activation,
                res_link=False, use_fp16=use_fp16, generator=generator)
            self.num_ws += block.num_conv
            if resj == self.block_res[-1]:
                self.num_ws += block.num_torgb
            setattr(self, f"b{resj}", block)

    def forward(self, ws, noise_mode="random", noise_seed=None, row0=0,
                rows=None):
        ws = ws.float()
        x = img = None
        w_idx = 0
        for res in self.block_res:
            block = getattr(self, f"b{res}")
            cur_ws = ws[:, w_idx: w_idx + block.num_conv + block.num_torgb]
            w_idx += block.num_conv
            x, img = block(x, img, cur_ws, noise_mode=noise_mode,
                           noise_seed=noise_seed, row0=row0, rows=rows)
        return img


class CoModSynthesisBlockFirst(nn.Module):
    """4×4 block: fc(global code) → grid, plus the encoder skip."""

    def __init__(self, w0_dim, oc_n, w_dim, resolution=4, rgb_n=None,
                 activation="lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)",
                 generator=None):
        super().__init__()
        self.resolution = resolution
        g = generator
        self.fc = Dense(w0_dim, oc_n * resolution ** 2, activation=activation,
                        generator=g)
        self.num_conv = 1
        self.conv = SynthesisLayer(oc_n, oc_n, 3, w0_dim + w_dim,
                                   resolution=resolution, bias=True,
                                   activation=activation,
                                   layer_id=2 * resolution, generator=g)
        self.torgb = (ToRGBLayer(oc_n, rgb_n, 1, w0_dim + w_dim, generator=g)
                      if rgb_n is not None else None)
        self.num_torgb = 1 if rgb_n is not None else 0

    def forward(self, x, x0, ws, noise_mode="random", noise_seed=None,
                row0=0, rows=None):
        x = x.float()
        w0 = x
        x = self.fc(x).reshape(x.shape[0], -1, self.resolution,
                               self.resolution)
        x = x + x0.float()
        x = self.conv(x, torch.cat([ws[:, 0], w0], dim=1),
                      noise_mode=noise_mode, noise_seed=noise_seed,
                      row0=row0, rows=rows)
        img = None
        if self.torgb is not None:
            img = self.torgb(x, torch.cat([ws[:, 1], w0], dim=1))
        return x, img


class CoModSynthesisBlock(nn.Module):
    """Upsampling co-modulated block with the encoder skip added."""

    def __init__(self, ic_n, oc_n, w_dim, w0_dim, resolution, rgb_n,
                 resample_filter=(1, 3, 3, 1),
                 activation="lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)",
                 use_fp16=False, generator=None):
        super().__init__()
        if ic_n == 0:
            raise ValueError("CoModSynthesisBlock needs input channels")
        self.dtype = torch.bfloat16 if use_fp16 else torch.float32
        self.resample_filter = setup_filter(resample_filter)
        self.num_conv = 2
        g = generator
        self.conv0 = SynthesisLayer(
            ic_n, oc_n, 3, w_dim=w_dim + w0_dim, resolution=resolution, up=2,
            activation=activation, resample_filter=resample_filter,
            layer_id=2 * resolution, generator=g)
        self.conv1 = SynthesisLayer(
            oc_n, oc_n, 3, w_dim=w_dim + w0_dim, resolution=resolution, up=1,
            activation=activation, resample_filter=None,
            layer_id=2 * resolution + 1, generator=g)
        self.torgb = (ToRGBLayer(oc_n, rgb_n, 1, w_dim=w_dim + w0_dim,
                                 generator=g)
                      if rgb_n is not None else None)
        self.num_torgb = 1 if rgb_n is not None else 0

    def forward(self, x, x0, img, ws, w0, noise_mode="random",
                noise_seed=None, row0=0, rows=None):
        x = x.to(self.dtype)
        x0 = x0.to(self.dtype)
        x = self.conv0(x, torch.cat([ws[:, 0], w0], dim=1),
                       noise_mode=noise_mode, noise_seed=noise_seed,
                       row0=row0, rows=rows)
        x = x + x0
        x = self.conv1(x, torch.cat([ws[:, 1], w0], dim=1),
                       noise_mode=noise_mode, noise_seed=noise_seed,
                       row0=row0, rows=rows)
        if img is not None:
            img = upsample2d(img, self.resample_filter)
        if self.torgb is not None:
            y = self.torgb(x, torch.cat([ws[:, 2], w0], dim=1)).float()
            img = img + y if img is not None else y
        return x, img


class CoModSynthesis(nn.Module):
    """CoModGAN synthesis pyramid 4² → resolution; blocks are attributes
    ``b{res}``."""

    plural = False   # CoModSynthesisPlur sets it

    def __init__(self, w_dim=512, w0_dim=1024, resolution=256, rgb_n=3,
                 ch_base=16384, ch_max=512, use_fp16_after_res=16,
                 resample_filter=(1, 3, 3, 1),
                 activation="lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)",
                 remat=False, fold_above_res=None, generator=None):
        # remat / fold_above_res are TPU formulations: accepted, not used
        super().__init__()
        log2res = int(np.log2(resolution))
        if 2 ** log2res != resolution:
            raise ValueError(resolution)
        self.resolution = resolution
        self.rgb_n = rgb_n
        self.block_res = [2 ** i for i in range(2, log2res + 1)]
        # b4 takes one conv w and the final torgb w, every other block two
        self.num_ws = 2 * len(self.block_res)
        g = generator
        hidden_ch = min(ch_base // self.block_res[0], ch_max)
        self.b4 = CoModSynthesisBlockFirst(w0_dim, hidden_ch, w_dim,
                                           resolution=4, rgb_n=rgb_n,
                                           activation=activation, generator=g)
        for resi, resj in zip(self.block_res[:-1], self.block_res[1:]):
            ch_i = min(ch_base // resi, ch_max)
            ch_j = min(ch_base // resj, ch_max)
            use_fp16 = (use_fp16_after_res is not None
                        and resj > use_fp16_after_res)
            setattr(self, f"b{resj}", CoModSynthesisBlock(
                ch_i, ch_j, w_dim=w_dim, w0_dim=w0_dim, resolution=resj,
                rgb_n=rgb_n, resample_filter=resample_filter,
                activation=activation, use_fp16=use_fp16, generator=g))

    def forward(self, x, feats, ws, noise_mode="random", noise_seed=None,
                w0_noise=None, row0=0, rows=None):
        """``w0_noise``: the pluralistic variant's N(0, 1) draw [N, w0_dim],
        given as a tensor instead of drawn.  ``row0``: the random noise's
        first row (the batch's place in a larger one); ``rows``: this
        worker's :class:`~shgan_torch.parallel.Rows` of a global batch whose
        style statistics the layers read (None: the batch is whole)."""
        ws = ws.float()
        w_idx, block_ws = 0, []
        for res in self.block_res:
            block = getattr(self, f"b{res}")
            block_ws.append(ws[:, w_idx: w_idx + block.num_conv
                               + block.num_torgb])
            w_idx += block.num_conv
        w0 = x
        if self.plural:
            # multiplicative noise on the global code of the blocks after
            # b4; b4 keeps the clean code
            if w0_noise is None:
                w0_noise = plural_noise(w0, noise_mode, noise_seed, row0)
            w0 = w0 + w0_noise.to(w0.device, w0.dtype) * w0
        x, img = self.b4(x, feats[4], block_ws[0], noise_mode=noise_mode,
                         noise_seed=noise_seed, row0=row0, rows=rows)
        for res, cur_ws in zip(self.block_res[1:], block_ws[1:]):
            x, img = getattr(self, f"b{res}")(
                x, feats[res], img, cur_ws, w0, noise_mode=noise_mode,
                noise_seed=noise_seed, row0=row0, rows=rows)
        return img


def plural_noise(w0, noise_mode, noise_seed, row0=0):
    """The pluralistic N(0, 1) draw of ``w0``'s shape, on the CPU: row
    ``i`` of the batch draws from its own generator, keyed by ``noise_seed``
    with random noise (else a constant key, so that const / none eval is
    deterministic) and its row ``row0 + i``, so a batch's rows draw what the
    same rows of a larger batch draw."""
    seed = 0
    if noise_mode == "random":
        if noise_seed is None:
            raise ValueError("noise_mode='random' requires a noise_seed")
        seed = (int(noise_seed) ^ PLUR_SALT) & 0x7FFFFFFFFFFFFFFF
    return torch.stack([
        torch.randn(tuple(w0.shape[1:]), generator=torch.Generator()
                    .manual_seed(derive_seed(seed, row0 + i, PLUR_SALT)))
        for i in range(w0.shape[0])])


class CoModSynthesisPlur(CoModSynthesis):
    """The pluralistic-inpainting variant: ``w0 + N(0, 1) * w0`` for the
    co-modulation of every block after b4."""

    plural = True
