"""Evaluators: FID, KID, precision/recall and IS (Inception), LPIPS, PPL,
PSNR and SSIM; importing the package registers them."""

from . import feature_metrics, fid, lpips, ppl, psnr, ssim  # noqa: F401  (registration)
from .base import get_evaluator, register_evaluator  # noqa: F401
