"""Generator assemblies (port of ``shgan_tpu/models/generator.py``, direct
path; the folded-layout matching is a TPU formulation and is not ported):
StyleGAN2 (mapping → synthesis) and CoModGAN (mapping → encoder →
co-modulated synthesis)."""

from __future__ import annotations

import torch.nn as nn


class StyleGANGenerator(nn.Module):
    """Unconditional StyleGAN2: ``img = synthesis(mapping(z, c))``."""

    def __init__(self, mapping, synthesis):
        super().__init__()
        if synthesis.num_ws != mapping.num_ws:
            raise ValueError((synthesis.num_ws, mapping.num_ws))
        self.mapping = mapping
        self.synthesis = synthesis
        self.num_ws = mapping.num_ws
        self.z_dim = mapping.z_dim
        self.c_dim = mapping.c_dim
        self.w_dim = mapping.w_dim
        self.img_resolution = synthesis.resolution
        self.img_channels = synthesis.rgb_n

    def forward(self, z, c=None, truncation_psi=1.0, truncation_cutoff=None,
                noise_mode="random", noise_seed=None, row0=0, rows=None):
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff)
        return self.synthesis(ws, noise_mode=noise_mode,
                              noise_seed=noise_seed, row0=row0, rows=rows)


class CoModGANGenerator(nn.Module):
    """``x`` is the 4-channel (mask−0.5 ‖ masked RGB) conditioning image."""

    def __init__(self, mapping, encoder, synthesis):
        super().__init__()
        if synthesis.num_ws != mapping.num_ws:
            raise ValueError((synthesis.num_ws, mapping.num_ws))
        self.mapping = mapping
        self.encoder = encoder
        self.synthesis = synthesis
        self.num_ws = mapping.num_ws
        self.z_dim = mapping.z_dim
        self.c_dim = mapping.c_dim
        self.w_dim = mapping.w_dim
        self.ic_n = encoder.ic_n
        self.img_resolution = synthesis.resolution
        self.img_channels = synthesis.rgb_n

    def forward(self, x, z, c=None, truncation_psi=1.0,
                truncation_cutoff=None, noise_mode="random", noise_seed=None,
                row0=0, rows=None):
        """``noise_seed`` keys the random noise of every synthesis layer
        (``noise_mode='random'``), ``row0`` its first counter row (the
        batch's place in a larger one); ``rows``: this rank's
        :class:`~shgan_torch.parallel.Rows` of a global batch, whose
        batch-wide statistics the layers read (None: the batch is whole)."""
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff)
        return self.forward_ws(x, ws, noise_mode=noise_mode,
                               noise_seed=noise_seed, row0=row0, rows=rows)

    def forward_ws(self, x, ws, noise_mode="random", noise_seed=None,
                   train=False, generator=None, row0=0, rows=None):
        """Encoder and synthesis for styles ``ws`` [N, num_ws, w_dim] the
        caller made (the training losses mix them); ``train`` turns the
        encoder's dropout on, drawn from ``generator``."""
        x_global, feats = self.encoder(x, train=train, generator=generator,
                                       rows=rows)
        return self.synthesis(x_global, feats, ws, noise_mode=noise_mode,
                              noise_seed=noise_seed, row0=row0, rows=rows)
