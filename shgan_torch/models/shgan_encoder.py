"""SH-GAN encoder: CoModGAN encoder + SHU spectral hints on the skip
features (port of the direct path of ``shgan_tpu/models/shgan_encoder.py``).

The SHU runs over the last ``shu_channels`` channels of
``feats[shu_input_res]``; each per-resolution hint is added into the last
``shu_channels`` channels of that resolution's skip feature.
"""

from __future__ import annotations

import torch

from ..parallel.spatial import level
from .encoder import Encoder
from .shu import SHU


class ShganEncoder(Encoder):
    def __init__(self, *, shu_input_res=64, shu_lowest_res=4, shu_channels=32,
                 shu_df_freedom=(2, 3), shu_df_type="piecewise_linear",
                 shu_tail_sigma_mult=3, shu_gaussian_at_input_res=False,
                 generator=None, **kwargs):
        super().__init__(generator=generator, **kwargs)
        self.shu_input_res = shu_input_res
        self.shu_channels = shu_channels
        self.shu = SHU(shu_channels, shu_channels,
                       dfilter_freedom=shu_df_freedom,
                       dfilter_type=shu_df_type, input_res=shu_input_res,
                       lowest_res=shu_lowest_res,
                       tail_sigma_mult=shu_tail_sigma_mult,
                       gaussian_at_input_res=shu_gaussian_at_input_res,
                       generator=generator)

    def forward(self, img, train=False, generator=None, rows=None):
        x, feats = super().forward(img, train=train, generator=generator,
                                   rows=rows)
        ch = self.shu_channels
        # the SHU reads the whole plane's spectrum: a sharded level's
        # channels are gathered, and each hint added to the slab's rows
        src = feats[self.shu_input_res][:, -ch:]
        s = level(self.shu_input_res)
        hints = self.shu(src if s is None else s.gather(src))
        for res, hint in hints.items():
            s = level(res)
            if s is not None:
                hint = s.take(hint)
            feat = feats[res]
            feats[res] = torch.cat(
                [feat[:, :-ch], feat[:, -ch:] + hint.to(feat.dtype)], dim=1)
        return x, feats
