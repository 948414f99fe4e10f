"""StyleGAN2 mapping network (port of ``shgan_tpu/models/mapping.py``):
equalized-LR dense layers with lr multiplier 0.01, input 2nd-moment
normalization, the ``w_avg`` buffer with the truncation trick, broadcast to
``num_ws``.  The ``w_avg`` EMA update is returned (``update_w_avg=True``),
not applied: the train step chains it through its phases as the JAX step
does.  With ``c_dim > 0`` the class label goes through the ``embed`` dense
layer and its own 2nd-moment normalization and joins z (or stands alone
with ``z_dim == 0``, the discriminator's and encoder's label mapping)."""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import Dense, normalize_2nd_moment


class Mapping(nn.Module):
    def __init__(self, z_dim=512, c_dim=0, w_dim=512, num_ws=14, num_layers=8,
                 embed_features=None, layer_features=None,
                 activation="lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)",
                 lr_multiplier=0.01, w_avg_beta=0.995, generator=None):
        super().__init__()
        self.z_dim = z_dim
        self.c_dim = c_dim
        self.w_dim = w_dim
        self.num_ws = num_ws
        self.num_layers = num_layers
        self.w_avg_beta = w_avg_beta

        if embed_features is None:
            embed_features = w_dim
        if c_dim == 0:
            embed_features = 0
        if layer_features is None:
            layer_features = w_dim
        features = ([z_dim + embed_features]
                    + [layer_features] * (num_layers - 1) + [w_dim])
        self.embed = (Dense(c_dim, embed_features, generator=generator)
                      if c_dim > 0 else None)
        for idx in range(num_layers):
            setattr(self, f"fc{idx}",
                    Dense(features[idx], features[idx + 1],
                          activation=activation, lr_multi=lr_multiplier,
                          generator=generator))
        if num_ws is not None and w_avg_beta is not None:
            self.register_buffer("w_avg", torch.zeros(w_dim))
        else:
            self.w_avg = None

    def forward(self, z, c=None, truncation_psi=1.0, truncation_cutoff=None,
                update_w_avg=False, rows=None):
        """``ws`` [N, num_ws, w_dim] (or [N, w_dim] when num_ws is None)
        from ``z`` [N, z_dim] and, with ``c_dim > 0``, the label ``c`` [N,
        c_dim].  With ``update_w_avg`` returns ``(ws, new_w_avg)``,
        ``new_w_avg`` the lerp ``x_mean + beta * (w_avg - x_mean)`` of the
        batch mean (``shgan_tpu/models/mapping.py:76-79``; no gradient),
        over the global batch where ``rows`` places this batch in one."""
        x = None
        if self.z_dim > 0:
            x = normalize_2nd_moment(z.float())
        if self.c_dim > 0:
            if c is None:
                raise ValueError(f"a mapping with c_dim {self.c_dim} needs c")
            y = normalize_2nd_moment(self.embed(c.float()))
            x = torch.cat([x, y], dim=1) if x is not None else y
        for idx in range(self.num_layers):
            x = getattr(self, f"fc{idx}")(x)

        new_w_avg = None
        if update_w_avg and self.w_avg is not None:
            xd = x.detach()
            x_mean = (xd if rows is None else rows.gather(xd)).mean(dim=0)
            new_w_avg = x_mean + self.w_avg_beta * (self.w_avg - x_mean)

        if self.num_ws is not None:
            x = x[:, None].repeat(1, self.num_ws, 1)

        if truncation_psi != 1:
            if self.w_avg is None:
                raise ValueError("truncation needs w_avg (w_avg_beta)")
            w_avg = self.w_avg
            if self.num_ws is None or truncation_cutoff is None:
                x = w_avg + truncation_psi * (x - w_avg)
            else:
                head = w_avg + truncation_psi * (
                    x[:, :truncation_cutoff] - w_avg)
                x = torch.cat([head, x[:, truncation_cutoff:]], dim=1)
        if update_w_avg:
            return x, new_w_avg
        return x
