"""Leaky-ReLU with gain and clamp, the string-configured activation factory,
and ``fma`` (port of ``shgan_tpu/ops/bias_act.py`` and ``ops/fma.py``).

Plain PyTorch: the chain is elementwise and no TPU kernel stood behind it.
Specs read like ``"lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)"``.
"""

from __future__ import annotations

import math
import re
from functools import partial

import torch

from ..parallel.spatial import replicated


def lrelu_agc_params(alpha=0.1, gain=1.0, clamp=None, extra_gain=1.0):
    """``(alpha, act_gain, act_clamp)``: the gain and the clamp scaled by
    the runtime gain (``act_clamp`` None for no clamp)."""
    return (alpha, gain * extra_gain,
            None if clamp is None else clamp * extra_gain)


def lrelu_agc(x, alpha=0.1, gain=1.0, clamp=None, extra_gain=1.0):
    """Leaky-ReLU, then gain, then clamp; ``clamp`` scales with the runtime
    gain (shgan_tpu/ops/bias_act.py:21-31)."""
    alpha, act_gain, act_clamp = lrelu_agc_params(alpha, gain, clamp,
                                                  extra_gain)
    x = torch.where(x >= 0, x, x * alpha)
    if act_gain != 1:
        x = x * act_gain
    if act_clamp is not None:
        x = torch.clamp(x, -act_clamp, act_clamp)
    return x


def _sine(x, freq=30.0, gain=1.0, extra_gain=1.0):
    return torch.sin(freq * x) * (gain * extra_gain)


def _relu(x, extra_gain=1.0):
    y = torch.relu(x)
    return y if extra_gain == 1.0 else y * extra_gain


_SPEC_RE = re.compile(r"^(\w+)\s*(?:\((.*)\))?$")


def _parse_value(v):
    v = v.strip()
    if v == "sqrt_2":
        return math.sqrt(2.0)
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v in ("True", "true"):
        return True
    if v in ("False", "false"):
        return False
    if v in ("None", "null"):
        return None
    return v


def parse_activation(spec):
    """``(name, kwargs)`` of an activation spec; None for
    ``None``/``"none"``."""
    if spec is None or spec == "none":
        return None
    m = _SPEC_RE.match(spec.strip())
    if m is None:
        raise ValueError(f"bad activation spec: {spec!r}")
    name, argstr = m.group(1), m.group(2)
    kwargs = {}
    if argstr:
        for part in argstr.split(","):
            k, v = part.split("=")
            kwargs[k.strip()] = _parse_value(v)
    return name, kwargs


def get_activation(spec):
    """Parse an activation spec into ``fn(x, gain=1) -> x`` (None for
    ``None``/``"none"``); units ``lrelu_agc(...)``, ``sine(...)``, ``relu``."""
    parsed = parse_activation(spec)
    if parsed is None:
        return None
    name, kwargs = parsed
    if name == "lrelu_agc":
        base = partial(lrelu_agc, **kwargs)
    elif name == "sine":
        base = partial(_sine, **kwargs)
    elif name == "relu":
        base = _relu
    else:
        raise ValueError(f"unknown activation: {name!r}")

    def act(x, gain=1.0):
        return base(x, extra_gain=gain)

    return act


def add_bias(x, b, slab=None):
    """``x + b`` over the channels of NCHW ``x``, ``b`` in ``x``'s type;
    where ``x`` is a slab (``slab``), ``b``'s gradient is summed over the
    model group."""
    return x + replicated(b, slab).to(x.dtype)[None, :, None, None]


def fma(a, b, c):
    """a * b + c."""
    return torch.addcmul(c, a, b)
