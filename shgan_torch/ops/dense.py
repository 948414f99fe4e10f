"""Equalized-learning-rate dense layer (port of ``shgan_tpu/ops/dense.py``).

Weights are drawn N(0, 1)/lr_multi and rescaled at run time by
``lr_multi / sqrt(in_features)``; the bias is scaled by ``lr_multi``.
"""

from __future__ import annotations

import numpy as np

from .bias_act import get_activation


def dense_apply(weight, bias, x, lr_multi=1.0, activation=None):
    """y = x @ (w * lr_multi/sqrt(in)).T + b * lr_multi, then activation
    (a spec string or a callable from :func:`get_activation`)."""
    weight_gain = lr_multi / np.sqrt(weight.shape[1])
    y = x @ (weight * weight_gain).t().to(x.dtype)
    if bias is not None:
        if lr_multi != 1.0:
            bias = bias * lr_multi
        y = y + bias.to(y.dtype)
    if isinstance(activation, str):
        activation = get_activation(activation)
    if activation is not None:
        y = activation(y)
    return y
