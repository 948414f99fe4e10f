"""The fused epilogue of a synthesis layer: noise, demodulation, bias and
activation in one pass over the conv output.

For the conv output ``x`` [N, C, R, R] (before demodulation) this computes::

    y = x * dcoefs[n, c] + noise[n, h, w] * strength + bias[c]
    y = lrelu_agc(y)       # or y * gain for a linear layer

where the noise is K1's Philox stream keyed by ``noise_key`` (``"random"``)
at counter rows ``row0 ... row0 + N - 1`` (``row0`` places the batch in a
larger one: a rank's block of a global batch draws what those rows of the
global batch draw), the layer's ``noise_const`` plane (``"const"``) or
nothing (``"none"``).

:func:`noise_bias_act_plain` is the chain the layers ran before the kernel
existed, op for op: ``random_noise(...) * strength`` (or ``noise_const *
strength``), ``addcmul`` with the dcoefs, ``+ bias``, then ``lrelu_agc``.
:func:`noise_bias_act_cuda` launches ``csrc/noise_bias_act.cu``, which draws
the noise in registers (the same bits as K1) and updates ``x`` in place (or
writes ``out``), so the noise never reaches device memory.
:func:`noise_bias_act` runs the kernel on a CUDA tensor and the plain version
on a CPU tensor, through :class:`_Epilogue` where a gradient is needed.

The gradient.  With ``pre`` the activation's input and ``g = dy *
act'(pre)`` (the activation's gain, times alpha where ``pre < 0``, 0 where a
finite clamp is active), the backward is ``dx = g * dcoefs``, ``d dcoefs =
sum_hw g * x``, ``d bias = sum_{n,hw} g`` and ``d strength = sum g * nu``
(``nu`` the noise before the strength; the noise itself has no gradient).
:func:`noise_bias_act_grad_cuda` computes all four in one launch of the
grad kernel, regenerating ``nu``; its double backward (the path-length
penalty) is the grad kernel in a mask-only mode, ``act'(pre) * v``
(:func:`noise_bias_act_mask_cuda`), and tensor products and sums.  The plain
versions :func:`noise_bias_act_grad_plain` and
:func:`noise_bias_act_mask_plain` compute the same in PyTorch.  Both modes
take float32 or bfloat16 ``x`` and cotangent (a bf16 block of a training
run): a bf16 pair is widened to float32, the float32 arithmetic runs on it
and the tensor result is rounded once to bf16; the sums stay float32.

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
                         strength=None, row0=0):
    """Plain PyTorch version: the layer's chain after the conv, op for op."""
    _check(x, noise_mode, noise_key, noise_const, strength)
    noise = None
    if noise_mode == "random":
        n, _, r, _ = x.shape
        noise = philox_normal_plain(noise_key, n, r, x.device, row0)[:, None] \
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


def _kernel_args(x, dcoefs, bias, noise_mode, noise_key, noise_const,
                 strength, row0, what):
    """Check the kernel's operands; the (mode, k0, k1, row0, pointers) it
    takes."""
    if not x.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor")
    if not x.is_contiguous():
        raise ValueError(f"{what} needs a contiguous NCHW x")
    n, c, r, _ = x.shape
    if r % 2 or x.data_ptr() % (2 * x.element_size()):
        raise ValueError(f"{what} needs an even resolution and a 2-element "
                         f"aligned x, got R={r}")
    mode = NOISE_MODES[noise_mode]
    aux = {"dcoefs": (dcoefs, (n, c)), "bias": (bias, (c,)),
           "strength": (strength if mode else None, ()),
           "noise_const": (noise_const if mode == 2 else None, (r, r))}
    for name, (t, shape) in aux.items():
        if t is None:
            continue
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous float32 "
                             f"{shape} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if mode == 2 and noise_const.data_ptr() % 8:
        raise ValueError(f"{what} needs an 8-byte aligned noise_const")
    k0, k1 = noise_key if mode == 1 else (0, 0)
    if row0 < 0 or row0 + n > _U32 + 1:
        raise ValueError(f"{what}: noise rows {row0}..{row0 + n} leave the "
                         "32-bit counter")
    ptrs = tuple(None if t is None else t.data_ptr()
                 for t, _ in aux.values())
    return aux, (mode, int(k0) & _U32, int(k1) & _U32, int(row0)), ptrs


def _act_args(act):
    alpha, gain, clamp = act
    return (1.0 if alpha is None else alpha, gain,
            math.inf if clamp is None else clamp)


def noise_bias_act_cuda(x, dcoefs=None, bias=None, act=LINEAR,
                        noise_mode="none", noise_key=None, noise_const=None,
                        strength=None, row0=0, out=None):
    """Launch ``csrc/noise_bias_act.cu`` on a CUDA tensor: ``x`` is updated
    in place and returned, or the result goes to ``out`` (a tensor of x's
    shape and layout) and ``out`` is returned."""
    _check(x, noise_mode, noise_key, noise_const, strength)
    if x.is_cuda and x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"noise_bias_act kernel takes float32/bfloat16, got "
                        f"{x.dtype}")
    aux, margs, ptrs = _kernel_args(
        x, dcoefs, bias, noise_mode, noise_key, noise_const, strength, row0,
        "noise_bias_act kernel")
    needs_grad = x.requires_grad or any(
        t is not None and t.requires_grad for t, _ in aux.values())
    if out is None and torch.is_grad_enabled() and needs_grad:
        raise RuntimeError("the in-place noise_bias_act launch takes no "
                           "tensor that needs a gradient; call "
                           "noise_bias_act, which differentiates")
    y = x if out is None else out
    if y is not x and (y.shape != x.shape or y.dtype != x.dtype
                       or y.device != x.device or not y.is_contiguous()
                       or y.data_ptr() % (2 * y.element_size())):
        raise ValueError("noise_bias_act kernel: out must be a contiguous, "
                         "2-element aligned tensor like x")
    n, c, r, _ = x.shape
    rc = _kb.launch(
        _kb.library("noise_bias_act").shgan_noise_bias_act, x.device,
        x.data_ptr(), y.data_ptr(), 0 if x.dtype == torch.float32 else 1, n,
        c, r, *ptrs, *margs, *_act_args(act))
    _kb.check(rc, "noise_bias_act kernel")
    _kb.count("noise_bias_act")
    return y


# ---------------------------------------------------------------------------
# the gradient: the grad kernel (both modes) and its plain versions
# ---------------------------------------------------------------------------


def grad_work_floats(n, c, res):
    """Floats of the grad kernel's work buffer (noise_bias_act.cuh:
    grad_group, grad_chunks and grad_work_floats, the same rules)."""
    kmax = max(-(-(res * res // 4) // 512), 1)
    group = 8
    while group > 1 and n * -(-c // group) * kmax < 1024:
        group //= 2
    k = max(min(-(-1024 // (n * -(-c // group))), kmax), 1)
    return 3 * n * c * k + 2 * n * c


def _grad_launch(v, x, dcoefs, bias, act, noise_mode, noise_key, noise_const,
                 strength, mask_only, vs=None, row0=0):
    what = "noise_bias_act_grad kernel"
    _check(x, noise_mode, noise_key, noise_const, strength)
    if x.dtype not in (torch.float32, torch.bfloat16) or v.dtype != x.dtype:
        raise TypeError(f"{what} takes a float32 or bfloat16 x and a "
                        f"cotangent of its type, got {v.dtype} / {x.dtype}")
    _, margs, ptrs = _kernel_args(
        x, dcoefs, bias, noise_mode, noise_key, noise_const, strength, row0,
        what)
    if (v.shape != x.shape or v.device != x.device or not v.is_contiguous()
            or v.data_ptr() % (2 * v.element_size())):
        raise ValueError(f"{what}: the cotangent must be a contiguous, "
                         f"2-element aligned tensor like x")
    if vs is not None and (vs.shape != () or vs.dtype != torch.float32
                           or vs.device != x.device):
        raise ValueError(f"{what}: vs must be a float32 scalar on {x.device}")
    n, c, r, _ = x.shape
    out = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    sums = (None, None, None, None) if mask_only else (
        torch.empty((n, c), **f32), torch.empty((c,), **f32),
        torch.empty((), **f32),
        torch.empty((grad_work_floats(n, c, r),), **f32))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = _kb.launch(
        _kb.library("noise_bias_act").shgan_noise_bias_act_grad, x.device,
        v.data_ptr(), x.data_ptr(), out.data_ptr(),
        0 if x.dtype == torch.float32 else 1, n, c, r, *ptrs, *margs,
        *_act_args(act), int(mask_only), ptr(vs), *map(ptr, sums))
    _kb.check(rc, what)
    _kb.count("noise_bias_act_grad")
    return out, sums[:3]


def noise_bias_act_grad_cuda(dy, x, dcoefs=None, bias=None, act=LINEAR,
                             noise_mode="none", noise_key=None,
                             noise_const=None, strength=None, row0=0):
    """The grad kernel's full mode: ``(dx, d dcoefs, d bias, d strength)``
    at the forward's input ``x`` for the cotangent ``dy``; None for an
    operand the forward did not have."""
    dx, (dd, db, ds) = _grad_launch(dy, x, dcoefs, bias, act, noise_mode,
                                    noise_key, noise_const, strength, False,
                                    row0=row0)
    return (dx, dd if dcoefs is not None else None,
            db if bias is not None else None,
            ds if noise_mode != "none" else None)


def noise_bias_act_mask_cuda(v, x, dcoefs=None, bias=None, act=LINEAR,
                             noise_mode="none", noise_key=None,
                             noise_const=None, strength=None, vs=None,
                             row0=0):
    """The grad kernel's mask-only mode: ``act'(pre) * (v + vs * nu)``."""
    return _grad_launch(v, x, dcoefs, bias, act, noise_mode, noise_key,
                        noise_const, strength, True, vs, row0=row0)[0]


def _noise_plain(x, noise_mode, noise_key, noise_const, row0=0):
    """nu, the noise before the strength, broadcastable to x (None for
    'none')."""
    if noise_mode == "random":
        n, _, r, _ = x.shape
        return philox_normal_plain(noise_key, n, r, x.device, row0)[:, None]
    if noise_mode == "const":
        return noise_const
    return None


def noise_bias_act_mask_plain(v, x, dcoefs=None, bias=None, act=LINEAR,
                              noise_mode="none", noise_key=None,
                              noise_const=None, strength=None, vs=None,
                              row0=0):
    """Plain version of the mask-only mode: ``act'(pre) * (v + vs * nu)``,
    in the order autograd of the plain chain takes it; a bf16 ``v`` and
    ``x`` are widened to float32 and the result rounded once to bf16."""
    _check(x, noise_mode, noise_key, noise_const, strength)
    if x.dtype != torch.float32:
        return noise_bias_act_mask_plain(
            v.float(), x.float(), dcoefs, bias, act, noise_mode, noise_key,
            noise_const, strength, vs, row0).to(x.dtype)
    nu = _noise_plain(x, noise_mode, noise_key, noise_const, row0)
    if vs is not None and nu is not None:
        v = v + vs * nu
    pre = noise_bias_act_plain(x, dcoefs, bias, LINEAR, noise_mode,
                               noise_key, noise_const, strength, row0)
    alpha, gain, clamp = act
    g = v * gain if gain != 1.0 else v
    if alpha is None:
        return g
    g = torch.where(pre >= 0, g, g * alpha)
    if clamp is None:
        return g
    y = torch.where(pre >= 0, pre, pre * alpha)
    if gain != 1.0:
        y = y * gain
    return torch.where((y >= -clamp) & (y <= clamp), g, torch.zeros_like(g))


def noise_bias_act_grad_plain(dy, x, dcoefs=None, bias=None, act=LINEAR,
                              noise_mode="none", noise_key=None,
                              noise_const=None, strength=None, row0=0):
    """Plain version of the grad kernel's full mode; for a bf16 ``dy`` and
    ``x``, the float32 version on the widened pair with dx rounded once to
    bf16 (the sums stay float32)."""
    if x.dtype != torch.float32:
        dx, *sums = noise_bias_act_grad_plain(
            dy.float(), x.float(), dcoefs, bias, act, noise_mode, noise_key,
            noise_const, strength, row0)
        return (dx.to(x.dtype), *sums)
    g = noise_bias_act_mask_plain(dy, x, dcoefs, bias, act, noise_mode,
                                  noise_key, noise_const, strength,
                                  row0=row0)
    nu = _noise_plain(x, noise_mode, noise_key, noise_const, row0)
    dx = g * dcoefs[:, :, None, None] if dcoefs is not None else g
    return (dx,
            (g * x).sum((2, 3)) if dcoefs is not None else None,
            g.sum((0, 2, 3)) if bias is not None else None,
            (g * nu).sum() if nu is not None else None)


def _on(x, cuda_fn, plain_fn):
    if x.is_cuda:
        return cuda_fn
    if x.device.type != "cpu":
        raise ValueError(f"noise_bias_act runs on CUDA or the CPU, not "
                         f"{x.device}")
    return plain_fn


class _Epilogue(torch.autograd.Function):
    """The epilogue with a gradient: the forward writes a new tensor and
    keeps ``x`` (not the noise); the backward is :class:`_EpilogueGrad`.
    ``x`` is float32 or bfloat16; the kernels raise on any other type."""

    @staticmethod
    def forward(ctx, x, dcoefs, bias, strength, noise_const, spec):
        act, noise_mode, noise_key, row0 = spec
        kw = dict(dcoefs=dcoefs, bias=bias, act=act, noise_mode=noise_mode,
                  noise_key=noise_key, noise_const=noise_const,
                  strength=strength, row0=row0)
        if x.is_cuda:
            y = noise_bias_act_cuda(x, out=torch.empty_like(x), **kw)
        else:
            y = _on(x, None, noise_bias_act_plain)(x, **kw)
        ctx.save_for_backward(x, dcoefs, bias, strength, noise_const)
        ctx.spec = spec
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dcoefs, bias, strength, noise_const = ctx.saved_tensors
        dx, dd, db, ds = _EpilogueGrad.apply(dy.contiguous(), x, dcoefs,
                                             bias, strength, noise_const,
                                             ctx.spec)
        return dx, dd, db, ds, None, None


class _EpilogueGrad(torch.autograd.Function):
    """The grad kernel's full mode as a Function, so the path-length
    penalty can differentiate the epilogue's backward once more; a third
    order raises."""

    @staticmethod
    def forward(ctx, dy, x, dcoefs, bias, strength, noise_const, spec):
        act, noise_mode, noise_key, row0 = spec
        fn = _on(dy, noise_bias_act_grad_cuda, noise_bias_act_grad_plain)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dy, x, dcoefs, bias, strength, noise_const)
        ctx.spec = spec
        return fn(dy, x, dcoefs, bias, act, noise_mode, noise_key,
                  noise_const, strength, row0)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gdx, gdd, gdb, gds):
        dy, x, dcoefs, bias, strength, noise_const = ctx.saved_tensors
        act, noise_mode, noise_key, row0 = ctx.spec
        mask = _on(dy, noise_bias_act_mask_cuda, noise_bias_act_mask_plain)
        kw = dict(dcoefs=dcoefs, bias=bias, act=act, noise_mode=noise_mode,
                  noise_key=noise_key, noise_const=noise_const,
                  strength=strength, row0=row0)
        # d/d dy = act'(pre) * v, v = gdx * dcoefs + gdd * x + gdb + gds * nu
        v = None
        if gdx is not None:
            v = gdx * dcoefs[:, :, None, None] if dcoefs is not None else gdx
        if gdd is not None:
            t = gdd[:, :, None, None] * x
            v = t if v is None else v + t
        if gdb is not None:
            t = gdb[None, :, None, None].expand_as(x)
            v = t if v is None else v + t
        if gds is not None and v is None:
            v = torch.zeros_like(x)
        # v is float32 where a float32 factor met a bf16 one: the mask
        # takes it in x's type, as autograd of the bf16 chain would hold it
        g_dy = None if v is None else mask(v.to(x.dtype).contiguous(), x,
                                           vs=gds, **kw)
        # d/dx = gdd * g and d/d dcoefs = sum_hw gdx * g, g = dy * act'(pre);
        # the bias and strength enter g only through the piecewise-constant
        # act': their second derivatives are 0
        g_x = g_d = None
        if gdd is not None or (gdx is not None and dcoefs is not None):
            g = mask(dy, x, **kw)
            if gdd is not None:
                g_x = (gdd[:, :, None, None] * g).to(x.dtype)
            if gdx is not None and dcoefs is not None:
                g_d = (gdx.float() * g.float()).sum((2, 3))
        return g_dy, g_x, g_d, None, None, None, None


def noise_bias_act(x, dcoefs=None, bias=None, act=LINEAR, noise_mode="none",
                   noise_key=None, noise_const=None, strength=None, row0=0):
    """The synthesis epilogue: the kernel on a CUDA tensor (``x`` updated in
    place) or raise, the plain version on a CPU tensor.  Where grad mode is
    on and an operand needs a gradient, the result is a new tensor with a
    gradient (:class:`_Epilogue`, the grad kernel on the card).  ``row0``:
    the random noise's first counter row."""
    kw = dict(dcoefs=dcoefs, bias=bias, act=act, noise_mode=noise_mode,
              noise_key=noise_key, noise_const=noise_const,
              strength=strength, row0=row0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dcoefs, bias, strength, noise_const)):
        _check(x, noise_mode, noise_key, noise_const, strength)
        used = lambda t, on: t if on else None  # noqa: E731
        return _Epilogue.apply(
            x, dcoefs, bias, used(strength, noise_mode != "none"),
            used(noise_const, noise_mode == "const"),
            (act, noise_mode, noise_key, row0))
    return _on(x, noise_bias_act_cuda, noise_bias_act_plain)(x, **kw)
