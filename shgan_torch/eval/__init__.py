"""Evaluators: FID (Inception), PSNR and SSIM; importing the package
registers them."""

from . import fid, psnr, ssim  # noqa: F401  (registration)
from .base import get_evaluator, register_evaluator  # noqa: F401
