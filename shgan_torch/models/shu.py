"""SHU, the Spectral Hint Unit (port of ``shgan_tpu/models/shu.py``).

rfft2(norm='forward') → shift-by-concat along H → [real ‖ imag] channels →
1×1 conv → ReLU → heterogeneous filter against the cweight basis → complex
recombine → per resolution: crop the centered ``[res, res//2+1]`` window,
multiply by its Gaussian-split map, unshift, irfft2 → {res: spatial hint}.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..ops.layout import like
from ..spectral.cweight import make_cweight
from ..spectral.dft import irfft2, rfft2
from ..spectral.gaussian import build_gaussian_split_maps
from ..spectral.shu_ops import (heterogeneous_filter_apply, spectral_shift,
                                spectral_unshift)
from .layers import Conv2d, randn


class _Weight(nn.Module):
    """Holds one parameter named ``weight`` (the ``df1.weight`` name)."""

    def __init__(self, value):
        super().__init__()
        self.weight = nn.Parameter(value)


class SHU(nn.Module):
    def __init__(self, in_channels, out_channels, dfilter_freedom=(3, 2),
                 dfilter_type="piecewise_linear", input_res=256, lowest_res=4,
                 tail_sigma_mult=3, gaussian_at_input_res=False,
                 generator=None):
        super().__init__()
        self.out_channels = out_channels
        self.input_res = input_res
        fh, fw = (int(v) for v in dfilter_freedom)
        self.conv0 = Conv2d(in_channels * 2, in_channels * 2, 1, 1, 0,
                            generator=generator)
        oc2 = out_channels * 2
        # df1 init N(1/(2·out), 0.1/(2·out))
        self.df1 = _Weight(1.0 / oc2 + randn(
            (in_channels * 2, oc2 * fh * fw), generator) * (0.1 / oc2))
        self.reslist = [2 ** i for i in range(int(np.log2(lowest_res)),
                                              int(np.log2(input_res)) + 1)]
        # constants: move with the module, stay out of the state_dict
        maps = build_gaussian_split_maps(input_res, lowest_res,
                                         tail_sigma_mult,
                                         gaussian_at_input_res)
        for res in self.reslist:
            self.register_buffer(f"gmap{res}", torch.from_numpy(maps[res]),
                                 persistent=False)
        self.register_buffer("cweight", torch.from_numpy(make_cweight(
            half_size=[fh, fw], half_sample=[input_res, input_res // 2 + 1],
            type=dfilter_type)), persistent=False)

    def forward(self, x):
        """x: [N, in_channels, input_res, input_res] →
        {res: [N, out_channels, res, res]}."""
        re, im = rfft2(x.float())
        # the spectrum in the input's layout (a slice of channels-last
        # features in the compiled forward), for the conv that reads it
        ff = like(torch.cat([spectral_shift(re), spectral_shift(im)], dim=1),
                  x)
        ff = torch.relu(self.conv0(ff))
        ff = heterogeneous_filter_apply(self.df1.weight, ff, self.cweight,
                                        self.out_channels * 2)
        oc = self.out_channels
        re, im = ff[:, :oc], ff[:, oc:]

        output = {}
        half = self.input_res // 2
        for resi in self.reslist:
            rows = slice(half - resi // 2, half + resi // 2)
            cols = slice(0, resi // 2 + 1)
            gmap = getattr(self, f"gmap{resi}")[None, None]
            sp_re = spectral_unshift(re[:, :, rows, cols] * gmap, resi)
            sp_im = spectral_unshift(im[:, :, rows, cols] * gmap, resi)
            output[resi] = irfft2(sp_re, sp_im, s=(resi, resi))
        return output
