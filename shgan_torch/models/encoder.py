"""CoModGAN encoder: resolution pyramid down to 4², global code and skip
features (port of the direct path of ``shgan_tpu/models/encoder.py``).

The epilogue's dropout (p = 0.5, kept values scaled by 2) acts only in a
training forward (``train=True``), drawn from the ``torch.Generator`` the
caller passes (``shgan_tpu/models/encoder.py:160-163``).  The JAX package
builds every block without the residual link; the port has none.  With
``mbstd_c_n > 0`` the epilogue appends the minibatch-stddev channels
before its conv; with ``c_dim > 0`` a ``mapping`` network (``z_dim`` 0)
maps the label to ``cmap``, which the epilogue, built without
``cmap_dim`` as in the JAX package, does not read.  With ``remat`` each
block above 4² is checkpointed (:mod:`.remat`); the epilogue, with its
dropout and minibatch stddev, is not.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..ops.minibatch_std import minibatch_std
from ..parallel.spatial import constrain, level
from .layers import Conv2dLayer, Dense
from .mapping import Mapping
from .remat import remat_call


class EncoderBlock(nn.Module):
    """fromrgb? → conv0 (feat out) → conv1 down=2."""

    def __init__(self, ic_n, mc_n, oc_n, rgb_n=None,
                 resample_filter=(1, 3, 3, 1),
                 activation="lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)",
                 use_fp16=False, generator=None):
        super().__init__()
        self.dtype = torch.bfloat16 if use_fp16 else torch.float32
        g = generator
        self.conv0 = Conv2dLayer(ic_n, mc_n, 3, bias=True,
                                 activation=activation, resample_filter=None,
                                 generator=g)
        self.conv1 = Conv2dLayer(mc_n, oc_n, 3, bias=True,
                                 activation=activation, down=2,
                                 resample_filter=resample_filter, generator=g)
        self.fromrgb = (Conv2dLayer(rgb_n, mc_n, 1, bias=True,
                                    activation=activation,
                                    resample_filter=None, generator=g)
                        if rgb_n is not None else None)

    def forward(self, x, img):
        """(x_downsampled, feat); feat is conv0's output, the synthesis
        skip.  Under spatial sharding a sharded level's ``x``, ``img`` and
        ``feat`` are this rank's slabs, and so is the result where its level
        is sharded (else it is gathered)."""
        s = level((x if x is not None else img).shape[3])
        if x is not None:
            x = x.to(self.dtype)
        if self.fromrgb is not None:
            y = self.fromrgb(img.to(self.dtype), slab=s, src=s)
            x = x + y if x is not None else y
        feat = self.conv0(x, slab=s, src=s)
        if s is None:
            return self.conv1(feat), feat
        out = s.scaled(s.H // 2)
        x = self.conv1(feat, slab=out, src=s)
        return (x if level(out.H) is not None else out.gather(x)), feat


class EncoderEpilogue(nn.Module):
    """4² epilogue producing the global co-modulation code."""

    def __init__(self, ic_n, oc_n, resolution=4, cmap_dim=None,
                 mbstd_group_size=4, mbstd_c_n=1,
                 activation="lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)",
                 has_extra_final_layer=True, use_dropout=True, generator=None):
        super().__init__()
        self.use_dropout = use_dropout
        self.cmap_dim = cmap_dim
        self.mbstd_group_size = mbstd_group_size
        self.mbstd_c_n = mbstd_c_n
        g = generator
        self.conv = Conv2dLayer(ic_n + mbstd_c_n, ic_n, 3, bias=True,
                                activation=activation, resample_filter=None,
                                generator=g)
        self.fc = Dense(ic_n * resolution ** 2, oc_n, activation=activation,
                        generator=g)
        self.out = (Dense(oc_n, oc_n, generator=g) if has_extra_final_layer
                    else None)

    def forward(self, x, cmap=None, train=False, generator=None, rows=None):
        x = x.float()
        if self.mbstd_c_n > 0:
            x = minibatch_std(x, self.mbstd_group_size, self.mbstd_c_n,
                              rows=rows)
        feat = self.conv(x)
        x = self.fc(feat.reshape(feat.shape[0], -1))
        if self.out is not None:
            x = self.out(x)
        if self.use_dropout and train:
            if generator is None:
                raise ValueError("encoder dropout in training needs a "
                                 "torch.Generator")
            def uniform(shape):
                return torch.rand(shape, generator=generator,
                                  device=generator.device)
            keep = (uniform(x.shape) if rows is None
                    else rows.draw(uniform, x.shape)) < 0.5
            x = torch.where(keep.to(x.device), x * 2.0, torch.zeros_like(x))
        if self.cmap_dim is not None:
            x = (x * cmap).sum(dim=1, keepdim=True) / np.sqrt(self.cmap_dim)
        return x, feat


class Encoder(nn.Module):
    """CoModGAN encoder: the global code and the {res: skip feature} dict.

    Blocks are attributes ``b{res}`` so parameter names read
    ``b512.conv0.weight`` as in the JAX package."""

    def __init__(self, resolution=256, ic_n=3, oc_n=1024, ch_base=16384,
                 ch_max=512, use_fp16_before_res=16,
                 resample_filter=(1, 3, 3, 1),
                 activation="lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)",
                 mbstd_group_size=4, mbstd_c_n=1, c_dim=None, cmap_dim=None,
                 use_dropout=True, has_extra_final_layer=True, remat=False,
                 fold_above_res=None, generator=None):
        # remat: each block above 4² checkpointed (models/remat.py);
        # fold_above_res, a layout for the TPU's MXU: accepted, not used
        super().__init__()
        self.remat = remat
        log2res = int(np.log2(resolution))
        if 2 ** log2res != resolution:
            raise ValueError(resolution)
        self.resolution = resolution
        self.encode_res = [2 ** i for i in range(log2res, 1, -1)]
        self.ic_n = ic_n
        self.oc_n = oc_n
        g = generator
        for idx, (resi, resj) in enumerate(zip(self.encode_res[:-1],
                                               self.encode_res[1:])):
            ch_i = min(ch_base // resi, ch_max)
            ch_j = min(ch_base // resj, ch_max)
            use_fp16 = (use_fp16_before_res is not None
                        and resi > use_fp16_before_res)
            setattr(self, f"b{resi}", EncoderBlock(
                ch_i, ch_i, ch_j, rgb_n=ic_n if idx == 0 else None,
                resample_filter=resample_filter, activation=activation,
                use_fp16=use_fp16, generator=g))
        self.mapping = (Mapping(z_dim=0, c_dim=c_dim, w_dim=cmap_dim,
                                num_ws=None, w_avg_beta=None, generator=g)
                        if c_dim is not None and c_dim > 0 else None)
        hidden_ch = min(ch_base // self.encode_res[-1], ch_max)
        self.b4 = EncoderEpilogue(
            hidden_ch, oc_n, resolution=4, cmap_dim=None,
            mbstd_group_size=mbstd_group_size, mbstd_c_n=mbstd_c_n,
            activation=activation,
            has_extra_final_layer=has_extra_final_layer,
            use_dropout=use_dropout, generator=g)

    def forward(self, img, c=None, train=False, generator=None, rows=None):
        """``train`` turns the epilogue's dropout on, drawn from
        ``generator``; ``c`` feeds the label mapping where there is one.
        ``rows``: this rank's :class:`~shgan_torch.parallel.Rows` of a
        global batch: the dropout draws the global batch's mask and keeps
        its rows, the minibatch stddev spans the batch."""
        x = None
        feats = {}
        img = constrain(img)   # a slab where the top level is sharded
        for resi in self.encode_res[:-1]:
            x, feats[resi] = remat_call(self.remat,
                                        getattr(self, f"b{resi}"), x, img)
            img = None
        cmap = self.mapping(None, c) if self.mapping is not None else None
        x, feats[4] = self.b4(x, cmap, train=train, generator=generator,
                              rows=rows)
        return x, feats
