"""shgan_torch — SH-GAN image completion in PyTorch, with hand-written CUDA
kernels for an NVIDIA Hopper GPU.

A port of ``shgan_tpu`` (JAX on a TPU), which stays the reference: module
names match, parameter names match, and the tests hold each module to its
JAX counterpart.  The package imports torch, numpy and yaml, never JAX.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on the CPU every kernel runs its plain PyTorch version.
"""

from .serve import InpaintEngine

__all__ = ["InpaintEngine"]
