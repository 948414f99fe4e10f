"""PSNR evaluator (port of ``shgan_tpu/eval/psnr.py``): −10·log10(mse) per
image, in float64, with the reference's shave modes.

It reads the device views (``pred_dev`` / ``gt_dev``) where the stage gives
them, so a compose of device-fed metrics needs no full-image copy to the
host.  The views hold the host views' float32 [0, 1] values (on the CPU
exactly; a CUDA division by a scalar multiplies by its reciprocal, which
may differ in the last bit), and the float64 sums run in another order.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import BaseEvaluator, register_evaluator

_GRAY = (65.738, 129.057, 25.064)


def _unit(x):
    """[0, 1] float64 tensor of a [0, 1] float view or a uint8 0..255 one
    (rescaled in float32 first, as the host view is)."""
    x = torch.as_tensor(x)
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
    return x.double()


@register_evaluator("psnr")
class PSNREvaluator(BaseEvaluator):
    consumes_host_pixels = False
    consumes_device_views = True

    def __init__(self, for_dataset=None, scale=None, rgb_range=1):
        super().__init__()
        self.for_dataset = for_dataset
        self.scale = scale
        self.rgb_range = rgb_range
        self.data_psnr = []

    def add_batch(self, pred, gt, valid=None, pred_dev=None, gt_dev=None,
                  **_):
        pred = _unit(pred_dev if pred_dev is not None else pred)
        gt = _unit(gt_dev if gt_dev is not None else gt).to(pred.device)
        if pred.ndim != 4 or pred.shape[1] != 3:
            raise ValueError(f"psnr takes [N, 3, H, W], got "
                             f"{tuple(pred.shape)}")
        diff = (pred - gt) / self.rgb_range
        if self.for_dataset is None:
            v = diff
        elif self.for_dataset == "benchmark":
            shave = self.scale
            gray = torch.tensor(_GRAY, dtype=torch.float64,
                                device=diff.device) / 256
            diff = (diff * gray[None, :, None, None]).sum(1)
            v = diff[:, shave:-shave, shave:-shave]
        elif self.for_dataset == "div2k":
            shave = self.scale + 6
            v = diff[:, :, shave:-shave, shave:-shave]
        else:
            raise NotImplementedError(self.for_dataset)
        mse = v.square().mean(dim=tuple(range(1, v.ndim))).cpu().numpy()
        psnr = -10 * np.log10(mse)
        (psnr,) = self._apply_valid([psnr], valid)
        self.data_psnr.append(psnr)

    def compute(self):
        psnr = np.concatenate(self.data_psnr, axis=0)
        if self.sample_n is not None:
            psnr = psnr[: self.sample_n]
        self.final["psnr"] = float(psnr.mean())
        return self.final["psnr"]

    def one_line_summary(self):
        self._log("Evaluator psnr: {:.4f}".format(self.final["psnr"]))

    def clear_data(self):
        self.data_psnr = []
