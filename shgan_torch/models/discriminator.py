"""StyleGAN2 / CoModGAN discriminator (port of
``shgan_tpu/models/discriminator.py``): a resolution pyramid of residual
blocks, then minibatch stddev, a conv and two dense layers.  The CoModGAN D
is the same network with a 4-channel input (mask - 0.5 || RGB).

Blocks are attributes ``b{res}`` so parameter names read
``b256.conv0.weight`` as in the JAX package.  ``remat`` is a TPU
formulation: accepted, not used.  A class-conditional D (``c_dim > 0``)
maps the label to ``cmap`` with a ``mapping`` network (``z_dim`` 0); as in
the JAX package its epilogue is built without ``cmap_dim``, so the logits
do not read ``cmap`` (an epilogue built with ``cmap_dim`` projects onto
it).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..ops.minibatch_std import minibatch_std
from .layers import Conv2dLayer, Dense
from .mapping import Mapping


class DiscrimBlock(nn.Module):
    """fromrgb? -> conv0 -> conv1 (down 2), with the residual skip."""

    def __init__(self, ic_n, mc_n, oc_n, rgb_n=None,
                 resample_filter=(1, 3, 3, 1),
                 activation="lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)",
                 reslink=True, use_fp16=False, generator=None):
        super().__init__()
        g = generator
        self.reslink = reslink
        self.dtype = torch.bfloat16 if use_fp16 else torch.float32
        self.fromrgb = (Conv2dLayer(rgb_n, mc_n, 1, bias=True,
                                    activation=activation,
                                    resample_filter=None, generator=g)
                        if rgb_n is not None else None)
        self.conv0 = Conv2dLayer(ic_n, mc_n, 3, bias=True,
                                 activation=activation, resample_filter=None,
                                 generator=g)
        self.conv1 = Conv2dLayer(mc_n, oc_n, 3, bias=True,
                                 activation=activation, down=2,
                                 resample_filter=resample_filter, generator=g)
        self.skip = (Conv2dLayer(mc_n, oc_n, 1, bias=False, down=2,
                                 resample_filter=resample_filter, generator=g)
                     if reslink else None)

    def forward(self, x, img):
        if x is not None:
            x = x.to(self.dtype)
        if self.fromrgb is not None:
            y = self.fromrgb(img.to(self.dtype))
            x = x + y if x is not None else y
        if self.reslink:
            y = self.skip(x, gain=np.sqrt(0.5))
            x = self.conv0(x)
            x = self.conv1(x, gain=np.sqrt(0.5))
            return y + x
        return self.conv1(self.conv0(x))


class DiscrimEpilogue(nn.Module):
    """mbstd -> conv -> fc -> out; with ``cmap_dim`` the output is
    ``cmap_dim`` wide and projected onto ``cmap``."""

    def __init__(self, ic_n, resolution=4, cmap_dim=None, mbstd_group_size=4,
                 mbstd_c_n=1,
                 activation="lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)",
                 generator=None):
        super().__init__()
        g = generator
        self.cmap_dim = cmap_dim
        self.mbstd_group_size = mbstd_group_size
        self.mbstd_c_n = mbstd_c_n
        self.conv = Conv2dLayer(ic_n + mbstd_c_n, ic_n, 3, bias=True,
                                activation=activation, resample_filter=None,
                                generator=g)
        self.fc = Dense(ic_n * resolution ** 2, ic_n, activation=activation,
                        generator=g)
        self.out = Dense(ic_n, 1 if cmap_dim is None else cmap_dim,
                         generator=g)

    def forward(self, x, cmap=None, rows=None):
        x = x.float()
        if self.mbstd_c_n > 0:
            x = minibatch_std(x, self.mbstd_group_size, self.mbstd_c_n,
                              rows=rows)
        x = self.conv(x)
        x = self.fc(x.reshape(x.shape[0], -1))
        x = self.out(x)
        if self.cmap_dim is not None:
            x = (x * cmap).sum(dim=1, keepdim=True) / np.sqrt(self.cmap_dim)
        return x


class Discriminator(nn.Module):
    """Resolution pyramid + epilogue; returns logits [N, 1]."""

    def __init__(self, resolution=256, ic_n=3, ch_base=16384, ch_max=512,
                 use_fp16_before_res=16, resample_filter=(1, 3, 3, 1),
                 activation="lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)",
                 mbstd_group_size=4, mbstd_c_n=1, c_dim=None, cmap_dim=None,
                 remat=False, generator=None):
        super().__init__()
        log2res = int(np.log2(resolution))
        if 2 ** log2res != resolution:
            raise ValueError(resolution)
        self.resolution = resolution
        self.encode_res = [2 ** i for i in range(log2res, 1, -1)]
        self.ic_n = ic_n
        g = generator
        for idx, (resi, resj) in enumerate(zip(self.encode_res[:-1],
                                               self.encode_res[1:])):
            ch_i = min(ch_base // resi, ch_max)
            ch_j = min(ch_base // resj, ch_max)
            use_fp16 = (use_fp16_before_res is not None
                        and resi > use_fp16_before_res)
            setattr(self, f"b{resi}", DiscrimBlock(
                ch_i, ch_i, ch_j, rgb_n=ic_n if idx == 0 else None,
                resample_filter=resample_filter, activation=activation,
                reslink=True, use_fp16=use_fp16, generator=g))
        self.mapping = (Mapping(z_dim=0, c_dim=c_dim, w_dim=cmap_dim,
                                num_ws=None, w_avg_beta=None, generator=g)
                        if c_dim is not None and c_dim > 0 else None)
        hidden_ch = min(ch_base // self.encode_res[-1], ch_max)
        self.b4 = DiscrimEpilogue(hidden_ch, resolution=4, cmap_dim=None,
                                  mbstd_group_size=mbstd_group_size,
                                  mbstd_c_n=mbstd_c_n, activation=activation,
                                  generator=g)

    def forward(self, img, c=None, rows=None):
        """Logits [N, 1]; ``c`` [N, c_dim] feeds the label mapping of a
        class-conditional D.  ``rows``: this rank's
        :class:`~shgan_torch.parallel.Rows` of a global batch, whose
        minibatch stddev spans it (None: the batch is whole)."""
        x = None
        for resi in self.encode_res[:-1]:
            x = getattr(self, f"b{resi}")(x, img)
            img = None
        cmap = self.mapping(None, c) if self.mapping is not None else None
        return self.b4(x, cmap, rows=rows)
