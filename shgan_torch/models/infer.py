"""The inference forward: generate → composite → uint8 (port of
``shgan_tpu/models/infer.py``).

    x      = cat([mask - 0.5, real * mask])          # network input
    img    = G(x, z)                                 # inpainting forward
    out    = real * mask + img * (1 - mask)          # keep known pixels
    uint8  = clip(out * 127.5 + 127.5, 0, 255)       # scoring quantization

``memory_format`` is the layout the generator's activations are held in:
the network input is made in it and every later activation follows it (the
compiled forward runs ``torch.channels_last`` on CUDA); the generated image
is made NCHW-contiguous before the composite, so the composite and its
uint8 result are NCHW-contiguous whatever it is.

``z_for_positions`` draws the latent of dataset position ``i`` exactly as
the JAX package does, so both packages give the same z for (seed, i).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.rng import derive_seed

Z_SALT = 0x5EED  # epoch slot used to derive per-position z seeds


def composite_forward(G, real, mask, z, noise_mode="random", noise_seed=None,
                      row0=0, rows=None, memory_format=torch.contiguous_format):
    """Run the generator on (real, mask) and return the uint8 composite.

    ``real`` in [-1, 1] NCHW float, or uint8 0..255 (normalized here, on the
    tensor's device); ``mask`` {0=hole, 1=keep} [N,1,H,W], float or uint8.
    ``noise_seed`` (an integer or a noise table), ``row0`` and ``rows`` as
    in the generator's forward; ``memory_format`` the activations' layout
    (the module docstring)."""
    if real.dtype == torch.uint8:
        real = real.float() / 127.5 - 1.0
    if mask.dtype != torch.float32:
        mask = mask.float()
    return composite(G, real, mask, z, noise_mode, noise_seed, row0,
                     rows, memory_format).to(torch.uint8)


def composite(G, real, mask, z, noise_mode="random", noise_seed=None, row0=0,
              rows=None, memory_format=torch.contiguous_format):
    """The composite of float ``real`` [-1, 1] and ``mask`` before the
    uint8 cast: ``clip(out * 127.5 + 127.5, 0, 255)`` in float, NCHW."""
    real, mask = real.contiguous(), mask.contiguous()
    x = torch.cat([mask - 0.5, real * mask], dim=1)
    img = G(x.contiguous(memory_format=memory_format), z,
            noise_mode=noise_mode, noise_seed=noise_seed, row0=row0,
            rows=rows).contiguous()
    combined = real * mask + img * (1 - mask)
    return torch.clamp(combined * 127.5 + 127.5, 0, 255)


def z_for_positions(seed, z_dim, positions):
    """Per-dataset-position latents: position ``i`` always gets the same z
    for a given seed, independent of batch layout."""
    return np.stack([
        np.random.RandomState(derive_seed(seed, int(i), Z_SALT))
        .randn(z_dim).astype(np.float32) for i in positions])
