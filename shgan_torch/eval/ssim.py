"""SSIM evaluator, 11×11 Gaussian window, per image (port of
``shgan_tpu/eval/ssim.py``): σ=1.5, C1=0.01², C2=0.03², a depthwise
Gaussian convolution in torch on the device that holds the images."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .base import BaseEvaluator, register_evaluator


def _gaussian_window(window_size=11, sigma=1.5):
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
               / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def compute_ssim(img1, img2, window_size=11):
    """Per-image SSIM of NCHW inputs in [0, 1] (uint8 0..255 tensors are
    rescaled first); returns a float32 [N] tensor."""
    def to01(x):
        x = torch.as_tensor(x)
        if x.dtype == torch.uint8:
            return x.float() / 255.0
        return x.float()
    img1, img2 = to01(img1), to01(img2).to(img1.device)
    c = img1.shape[1]
    w = torch.from_numpy(_gaussian_window(window_size)).to(img1.device)
    kernel = w[None, None].expand(c, 1, window_size, window_size)
    pad = window_size // 2

    def filt(x):
        return F.conv2d(x, kernel, padding=pad, groups=c)

    with torch.inference_mode():
        mu1, mu2 = filt(img1), filt(img2)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        sigma1_sq = filt(img1 * img1) - mu1_sq
        sigma2_sq = filt(img2 * img2) - mu2_sq
        sigma12 = filt(img1 * img2) - mu1_mu2
        c1, c2 = 0.01 ** 2, 0.03 ** 2
        ssim_map = (((2 * mu1_mu2 + c1) * (2 * sigma12 + c2))
                    / ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)))
        return ssim_map.mean(dim=(1, 2, 3))


@register_evaluator("ssim")
class SSIMEvaluator(BaseEvaluator):
    # reads pred_dev/gt_dev where given: a compose holding SSIM needs no
    # host pixels for it
    consumes_host_pixels = False
    consumes_device_views = True

    def __init__(self, window_size=11):
        super().__init__()
        self.window_size = window_size
        self.data_ssim = []

    def add_batch(self, pred, gt, valid=None, pred_dev=None, gt_dev=None,
                  **_):
        a = pred_dev if pred_dev is not None else torch.from_numpy(
            np.asarray(pred, np.float32))
        b = gt_dev if gt_dev is not None else torch.from_numpy(
            np.asarray(gt, np.float32))
        s = compute_ssim(a, b, self.window_size).cpu().numpy().astype(
            np.float64)
        (s,) = self._apply_valid([s], valid)
        self.data_ssim.append(s)

    def compute(self):
        s = np.concatenate(self.data_ssim, axis=0)
        if self.sample_n is not None:
            s = s[: self.sample_n]
        self.final["ssim"] = float(s.mean())
        return self.final["ssim"]

    def one_line_summary(self):
        self._log("Evaluator ssim: {:.4f}".format(self.final["ssim"]))

    def clear_data(self):
        self.data_ssim = []
