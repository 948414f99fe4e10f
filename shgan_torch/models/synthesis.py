"""StyleGAN2 and CoModGAN synthesis networks (port of the direct path of
``shgan_tpu/models/synthesis.py``: ``StyleGANSynthesisBlock``,
``StyleGANSynthesis``, ``CoModSynthesisBlockFirst``, ``CoModSynthesisBlock``,
``CoModSynthesis`` and the pluralistic ``CoModSynthesisPlur``).

Co-modulation: every affine reads ``concat[w_i, w0]``, the mapping style
beside the encoder's global code.  Random noise: synthesis layer
``conv0``/``conv1`` of the block at resolution ``r`` has layer id ``2r`` /
``2r + 1`` and the 4² block's conv has ``8``, so each noise layer draws its
own stream under the forward's ``noise_seed`` (an integer, or a noise
table: ``ops/noise.noise_table``, row ``layer_id`` a layer's key and
counter row).  A block above
``use_fp16_after_res`` runs in bfloat16; the image pyramid stays float32.
With ``remat`` each co-modulated block after ``b4`` is checkpointed
(:mod:`.remat`); as in the JAX package, ``StyleGANSynthesis`` has no
``remat``.

The no-grad route of ``CoModSynthesis``: on a forward that records no
gradient (grad mode off, or neither the parameters nor the inputs need one)
with no level sharded, which is serving's, the eval stage's and training's
D-phase generator forward (``train/loss.d_main_loss`` runs G under
``no_grad``), every layer's styles are computed first (the same
affine matmuls, in another order) and each synthesis layer's epilogue
writes its consumers' inputs: ``conv0``'s the encoder skip added and
scaled by ``conv1``'s styles, ``conv1``'s (and ``b4.conv``'s) scaled by
``torgb``'s and by the next block's ``conv0``'s (``ops/noise_bias_act``:
the fold).  Those consumers then skip their own multiply (``prescaled``);
``b4.conv`` scales its own input.  Where the next block's type differs
from this one's (a bf16 block after a float32 one) the block's last
epilogue folds nothing, and its consumers multiply for themselves: the
chain casts before it multiplies there.  Every output is the chain's,
rounded where it rounds.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn

from ..data.rng import derive_seed
from ..ops.upfirdn2d import setup_filter, upsample2d
from ..parallel.spatial import level
from .layers import Conv2dLayer, Dense, SynthesisLayer, ToRGBLayer, randn
from .remat import remat_call

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
        """Under spatial sharding a sharded level's ``x`` and ``img`` are
        this rank's slabs (the input's level's layout in, this level's
        out)."""
        s = level(self.resolution)
        src = level(self.resolution // 2)
        if self.has_const:
            x = self.const.to(self.dtype)[None].expand(
                ws.shape[0], -1, -1, -1)
            if s is not None:
                x = s.take(x)
        else:
            x = x.to(self.dtype)
        y = self.skip(x, gain=np.sqrt(0.5), slab=s, src=src) \
            if self.skip is not None else None
        w_idx = 0
        if self.conv0 is not None:
            x = self.conv0(x, ws[:, 0], noise_mode=noise_mode,
                           noise_seed=noise_seed, row0=row0, rows=rows,
                           slab=s, src=src)
            w_idx = 1
        x = self.conv1(x, ws[:, w_idx], gain=np.sqrt(0.5) if self.res_link
                       else 1.0, noise_mode=noise_mode,
                       noise_seed=noise_seed, row0=row0, rows=rows, slab=s,
                       src=s)
        if y is not None:
            x = y + x
        if img is not None:
            img = upsample2d(img, self.resample_filter, slab=s, src=src)
        if self.torgb is not None:
            y = self.torgb(x, ws[:, w_idx + 1], slab=s).float()
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
        s = level(self.resolution)
        return img if s is None else s.gather(img)


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
                row0=0, rows=None, fold=None):
        """``fold``: this block's :class:`Fold` on the no-grad route."""
        f = fold or NO_FOLD
        x = x.float()
        w0 = x
        x = self.fc(x).reshape(x.shape[0], -1, self.resolution,
                               self.resolution)
        # the encoder's feature first: the sum takes its memory layout
        x = x0.float() + x
        x, rgb_in = f.split(self.conv(
            x, torch.cat([ws[:, 0], w0], dim=1), noise_mode=noise_mode,
            noise_seed=noise_seed, row0=row0, rows=rows,
            scales=f.scales.get("conv", ())))
        img = None
        if self.torgb is not None:
            img = self.torgb(rgb_in, **f.w_or_styles("torgb", ws, 1, w0))
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
        self.resolution = resolution
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
                noise_seed=None, row0=0, rows=None, fold=None):
        """``fold``: this block's :class:`Fold` on the no-grad route."""
        # under spatial sharding a sharded level's x, x0 and img are this
        # rank's slabs (the input's level's layout in, this level's out)
        s, src = level(self.resolution), level(self.resolution // 2)
        x = x.to(self.dtype)
        x0 = x0.to(self.dtype)
        f = fold or NO_FOLD
        kw = dict(noise_mode=noise_mode, noise_seed=noise_seed, row0=row0,
                  rows=rows)
        # on the route conv0's epilogue adds the skip (the fold), else here
        skip = f.scales.get("conv0", ())
        x, _ = f.split(self.conv0(
            x, **f.w_or_styles("conv0", ws, 0, w0), slab=s, src=src,
            addend=x0 if skip else None, scales=skip, **kw))
        if not skip:
            x = x + x0
        x, rgb_in = f.split(self.conv1(
            x, **f.w_or_styles("conv1", ws, 1, w0), slab=s, src=s,
            scales=f.scales.get("conv1", ()), **kw))
        if img is not None:
            img = upsample2d(img, self.resample_filter, slab=s, src=src)
        if self.torgb is not None:
            y = self.torgb(rgb_in, **f.w_or_styles("torgb", ws, 2, w0),
                           slab=s).float()
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
        # remat: each block after b4 checkpointed (models/remat.py);
        # fold_above_res, a layout for the TPU's MXU: accepted, not used
        super().__init__()
        log2res = int(np.log2(resolution))
        if 2 ** log2res != resolution:
            raise ValueError(resolution)
        self.remat = remat
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
        folds = (self.fold_plan(block_ws, x.float(), w0, rows)
                 if self.on_route(x, feats, ws, w0)
                 else [None] * len(self.block_res))
        x, img = self.b4(x, feats[4], block_ws[0], noise_mode=noise_mode,
                         noise_seed=noise_seed, row0=row0, rows=rows,
                         fold=folds[0])
        for res, cur_ws, fold in zip(self.block_res[1:], block_ws[1:],
                                     folds[1:]):
            x, img = remat_call(
                self.remat, getattr(self, f"b{res}"), x, feats[res], img,
                cur_ws, w0, noise_mode=noise_mode, noise_seed=noise_seed,
                row0=row0, rows=rows, fold=fold)
        s = level(self.resolution)
        return img if s is None else s.gather(img)

    def on_route(self, x, feats, ws, w0):
        """Whether this forward takes the no-grad route (the module
        docstring): it records no gradient and no level is sharded."""
        if any(level(r) is not None for r in self.block_res):
            return False
        if not torch.is_grad_enabled():
            return True
        return not any(t.requires_grad for t in (
            x, ws, w0, *feats.values(), *self.parameters()))

    def fold_plan(self, block_ws, w0_first, w0, rows=None):
        """Each block's :class:`Fold`: the styles of every prescaled
        consumer, and each synthesis layer's consumers' styles in the
        order its epilogue writes them (``torgb``'s, then the next block's
        ``conv0``'s)."""
        blocks = [getattr(self, f"b{r}") for r in self.block_res]
        dtypes = [torch.float32] + [b.dtype for b in blocks[1:]]
        plan = [Fold({}, {}) for _ in blocks]
        for i, (b, cur) in enumerate(zip(blocks, block_ws)):
            code = w0_first if i == 0 else w0
            f = plan[i]
            if i:
                f.styles["conv1"] = b.conv1.input_scale(
                    torch.cat([cur[:, 1], code], dim=1), rows)
                f.scales["conv0"] = (f.styles["conv1"],)
            last = i + 1 == len(blocks)
            if not (last or dtypes[i + 1] == dtypes[i]):
                continue   # the next block casts first: no fold here
            out = []
            if b.torgb is not None:
                f.styles["torgb"] = b.torgb.input_scale(
                    torch.cat([cur[:, b.num_conv], code], dim=1))
                out.append(f.styles["torgb"])
            if not last:
                nxt = blocks[i + 1].conv0.input_scale(
                    torch.cat([block_ws[i + 1][:, 0], w0], dim=1), rows)
                plan[i + 1].styles["conv0"] = nxt
                out.append(nxt)
            f.scales["conv" if i == 0 else "conv1"] = tuple(out)
        return plan


class Fold(NamedTuple):
    """A block's part of the no-grad route: ``styles``, the styles that a
    prescaled layer's input holds, by layer name (a layer not named
    multiplies for itself); ``scales``, by synthesis layer, its
    consumers' styles in the order its epilogue writes their inputs
    (``torgb``'s, then the next block's ``conv0``'s)."""
    styles: dict
    scales: dict

    def w_or_styles(self, layer, ws, j, w0):
        """``layer``'s ``w`` and ``styles`` arguments: its prescaled
        input's styles and no w, or its w (``concat[ws[:, j], w0]``) and no
        styles."""
        st = self.styles.get(layer)
        if st is not None:
            return {"w": None, "styles": st}
        return {"w": torch.cat([ws[:, j], w0], dim=1), "styles": None}

    @staticmethod
    def split(y):
        """``(the next layer's input, torgb's input)`` from a synthesis
        layer's result: its outputs where it folds (torgb's first, the
        next conv0's last; after the last block both are torgb's), else
        ``y`` for both."""
        y = y if isinstance(y, tuple) else (y,)
        return y[-1], y[0]


NO_FOLD = Fold({}, {})


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
        if isinstance(noise_seed, torch.Tensor):
            # a noise table keys the layers' noise on the device; this draw
            # is the host's, from an integer seed (the compiled forward
            # runs this synthesis eagerly: runtime/compiled.py)
            raise ValueError("the pluralistic w0 draw takes an integer "
                             "noise_seed, not a noise table")
        seed = (int(noise_seed) ^ PLUR_SALT) & 0x7FFFFFFFFFFFFFFF
    return torch.stack([
        torch.randn(tuple(w0.shape[1:]), generator=torch.Generator()
                    .manual_seed(derive_seed(seed, row0 + i, PLUR_SALT)))
        for i in range(w0.shape[0])])


class CoModSynthesisPlur(CoModSynthesis):
    """The pluralistic-inpainting variant: ``w0 + N(0, 1) * w0`` for the
    co-modulation of every block after b4."""

    plural = True
