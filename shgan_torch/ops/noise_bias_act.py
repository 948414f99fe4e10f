"""The fused epilogue of a synthesis layer: noise, demodulation, bias and
activation in one pass over the conv output.

For the conv output ``x`` [N, C, R, R] (before demodulation) this computes::

    y = x * dcoefs[n, c] + noise[n, h, w] * strength + bias[c]
    y = lrelu_agc(y)       # or y * gain for a linear layer

where the noise is K1's Philox stream keyed by ``noise_key`` (``"random"``),
the layer's ``noise_const`` plane (``"const"``) or nothing (``"none"``).

:func:`noise_bias_act_plain` is the chain the layers ran before the kernel
existed, op for op: ``random_noise(...) * strength`` (or ``noise_const *
strength``), ``addcmul`` with the dcoefs, ``+ bias``, then ``lrelu_agc``.
:func:`noise_bias_act_cuda` launches ``csrc/noise_bias_act.cu``, which draws
the noise in registers (the same bits as K1) and updates ``x`` in place, so
the noise never reaches device memory.  :func:`noise_bias_act` runs the
kernel on a CUDA tensor and the plain version on a CPU tensor.

The activation is a tuple ``(alpha, gain, clamp)``: :func:`epilogue_act`
parses a layer's spec at its runtime gain (``alpha`` None is linear, ``clamp``
None is no clamp).
"""

from __future__ import annotations

import math

import torch

from ..kernels import build as _kb
from .bias_act import lrelu_agc, lrelu_agc_params
from .noise import philox_normal_plain

NOISE_MODES = {"none": 0, "random": 1, "const": 2}
LINEAR = (None, 1.0, None)
_U32 = 0xFFFFFFFF


def epilogue_act(parsed, gain=1.0):
    """``(alpha, act_gain, act_clamp)`` of a parsed activation spec
    (:func:`~shgan_torch.ops.bias_act.parse_activation`) at runtime
    ``gain``; ``(None, gain, None)`` for a linear layer."""
    if parsed is None:
        return (None, gain, None)
    name, kwargs = parsed
    if name != "lrelu_agc":
        raise ValueError(f"the fused epilogue takes lrelu_agc or a linear "
                         f"activation, not {name!r}")
    return lrelu_agc_params(**kwargs, extra_gain=gain)


def _check(x, noise_mode, noise_key, noise_const, strength):
    if x.ndim != 4 or x.shape[2] != x.shape[3]:
        raise ValueError(f"noise_bias_act takes NCHW x with H == W, got "
                         f"{tuple(x.shape)}")
    if noise_mode not in NOISE_MODES:
        raise ValueError(f"noise_mode {noise_mode!r}")
    if noise_mode != "none" and strength is None:
        raise ValueError(f"noise_mode {noise_mode!r} needs a strength")
    if noise_mode == "random" and noise_key is None:
        raise ValueError("noise_mode 'random' needs a noise_key")
    if noise_mode == "const" and noise_const is None:
        raise ValueError("noise_mode 'const' needs noise_const")


def noise_bias_act_plain(x, dcoefs=None, bias=None, act=LINEAR,
                         noise_mode="none", noise_key=None, noise_const=None,
                         strength=None):
    """Plain PyTorch version: the layer's chain after the conv, op for op."""
    _check(x, noise_mode, noise_key, noise_const, strength)
    noise = None
    if noise_mode == "random":
        n, _, r, _ = x.shape
        noise = philox_normal_plain(noise_key, n, r, x.device)[:, None] \
            * strength
    elif noise_mode == "const":
        noise = noise_const * strength
    if dcoefs is not None:
        d = dcoefs.to(x.dtype)[:, :, None, None]
        x = torch.addcmul(noise.to(x.dtype), x, d) if noise is not None \
            else x * d
    elif noise is not None:
        x = x + noise.to(x.dtype)
    if bias is not None:
        x = x + bias.to(x.dtype)[None, :, None, None]
    alpha, gain, clamp = act
    if alpha is not None:
        return lrelu_agc(x, alpha, gain=gain, clamp=clamp)
    return x * gain if gain != 1.0 else x


def noise_bias_act_cuda(x, dcoefs=None, bias=None, act=LINEAR,
                        noise_mode="none", noise_key=None, noise_const=None,
                        strength=None):
    """Launch ``csrc/noise_bias_act.cu`` on a CUDA tensor: ``x`` is updated
    in place and returned."""
    _check(x, noise_mode, noise_key, noise_const, strength)
    if not x.is_cuda:
        raise ValueError("noise_bias_act_cuda needs a CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"noise_bias_act kernel takes float32/bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("noise_bias_act kernel needs a contiguous NCHW x")
    n, c, r, _ = x.shape
    if r % 2 or x.data_ptr() % (2 * x.element_size()):
        raise ValueError(f"noise_bias_act kernel needs an even resolution "
                         f"and a 2-element aligned x, got R={r}")
    mode = NOISE_MODES[noise_mode]
    aux = {"dcoefs": (dcoefs, (n, c)), "bias": (bias, (c,)),
           "strength": (strength if mode else None, ()),
           "noise_const": (noise_const if mode == 2 else None, (r, r))}
    for name, (t, shape) in aux.items():
        if t is None:
            continue
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"noise_bias_act kernel: {name} must be a "
                             f"contiguous float32 {shape} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    needs_grad = x.requires_grad or any(
        t is not None and t.requires_grad for t, _ in aux.values())
    if torch.is_grad_enabled() and needs_grad:
        raise RuntimeError("the noise_bias_act kernel is forward-only; run "
                           "under torch.inference_mode()")
    if mode == 2 and noise_const.data_ptr() % 8:
        raise ValueError("noise_bias_act kernel needs an 8-byte aligned "
                         "noise_const")
    alpha, gain, clamp = act
    k0, k1 = noise_key if mode == 1 else (0, 0)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = _kb.launch(
        _kb.library("noise_bias_act").shgan_noise_bias_act, x.device,
        x.data_ptr(), 0 if x.dtype == torch.float32 else 1, n, c, r,
        ptr(dcoefs), ptr(bias), ptr(aux["strength"][0]),
        ptr(aux["noise_const"][0]), mode, int(k0) & _U32, int(k1) & _U32,
        1.0 if alpha is None else alpha, gain,
        math.inf if clamp is None else clamp)
    _kb.check(rc, "noise_bias_act kernel")
    _kb.launches["noise_bias_act"] += 1
    return x


def noise_bias_act(x, dcoefs=None, bias=None, act=LINEAR, noise_mode="none",
                   noise_key=None, noise_const=None, strength=None):
    """The synthesis epilogue: the kernel on a CUDA tensor (``x`` updated in
    place) or raise, the plain version on a CPU tensor."""
    kw = dict(dcoefs=dcoefs, bias=bias, act=act, noise_mode=noise_mode,
              noise_key=noise_key, noise_const=noise_const,
              strength=strength)
    if x.is_cuda:
        return noise_bias_act_cuda(x, **kw)
    if x.device.type != "cpu":
        raise ValueError(f"noise_bias_act runs on CUDA or the CPU, not "
                         f"{x.device}")
    return noise_bias_act_plain(x, **kw)
