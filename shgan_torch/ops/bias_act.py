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


def lrelu_agc(x, alpha=0.1, gain=1.0, clamp=None, extra_gain=1.0):
    """Leaky-ReLU, then gain, then clamp; ``clamp`` scales with the runtime
    gain (shgan_tpu/ops/bias_act.py:21-31)."""
    x = torch.where(x >= 0, x, x * alpha)
    act_gain = gain * extra_gain
    if act_gain != 1:
        x = x * act_gain
    if clamp is not None:
        act_clamp = clamp * extra_gain
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


def get_activation(spec):
    """Parse an activation spec into ``fn(x, gain=1) -> x`` (None for
    ``None``/``"none"``); units ``lrelu_agc(...)``, ``sine(...)``, ``relu``."""
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


def fma(a, b, c):
    """a * b + c."""
    return torch.addcmul(c, a, b)
