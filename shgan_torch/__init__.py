"""shgan_torch — SH-GAN image completion in PyTorch, with hand-written CUDA
kernels for an NVIDIA Hopper GPU.

A port of ``shgan_tpu`` (JAX on a TPU), which stays the reference: module
names match, parameter names match, and the tests hold each module to its
JAX counterpart.  The package imports torch, numpy and yaml, never JAX.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on the CPU every kernel runs its plain PyTorch version.
"""

import importlib

# the public names of shgan_tpu/__init__.py, resolved at first use
_TOP_LEVEL = {
    "get_model": ("shgan_torch.models", "get_model"),
    "get_dataset": ("shgan_torch.data", "get_dataset"),
    "get_evaluator": ("shgan_torch.eval", "get_evaluator"),
    "InpaintEngine": ("shgan_torch.serve", "InpaintEngine"),
    "generate_to_dir": ("shgan_torch.serve", "generate_to_dir"),
}

__all__ = sorted(_TOP_LEVEL)


def __getattr__(name):
    try:
        mod, attr = _TOP_LEVEL[name]
    except KeyError:
        raise AttributeError(name) from None
    return getattr(importlib.import_module(mod), attr)
