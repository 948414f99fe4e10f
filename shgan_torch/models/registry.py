"""Model registry: build modules from the same config dicts as
``shgan_tpu/models/registry.py``.  A model config is
``{'type': <registered name>, 'args': {...}}``; nested sub-model configs
inside ``args`` are built first.  Every module draws its parameters from
one CPU ``torch.Generator`` seeded with ``seed``."""

from __future__ import annotations

import torch

from .discriminator import Discriminator
from .encoder import Encoder
from .generator import CoModGANGenerator, StyleGANGenerator
from .mapping import Mapping
from .shgan_encoder import ShganEncoder
from .synthesis import CoModSynthesis, CoModSynthesisPlur, StyleGANSynthesis

MODEL_REGISTRY = {
    "stylegan2_mapping": Mapping,
    "comodgan_mapping": Mapping,
    "stylegan2_synthesis": StyleGANSynthesis,
    "comodgan_synthesis": CoModSynthesis,
    "comodgan_synthesis_plur": CoModSynthesisPlur,
    "comodgan_encoder": Encoder,
    "shgan_encoder": ShganEncoder,
    "stylegan2_discriminator": Discriminator,
    "comodgan_discriminator": Discriminator,
}
_ASSEMBLIES = {"stylegan2_generator": StyleGANGenerator,
               "comodgan_generator": CoModGANGenerator}


def _is_model_cfg(v):
    return isinstance(v, dict) and "type" in v


def get_model(cfg, seed=0, generator=None):
    """Instantiate a model from a config dict.  ``generator`` (a CPU
    ``torch.Generator``) wins over ``seed``."""
    if not _is_model_cfg(cfg):
        raise ValueError(f"not a model config: {cfg!r}")
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    typ = cfg["type"]
    args = dict(cfg.get("args") or {})
    for k, v in list(args.items()):
        if _is_model_cfg(v):
            args[k] = get_model(v, generator=generator)
    if typ in _ASSEMBLIES:
        return _ASSEMBLIES[typ](**args)
    if typ not in MODEL_REGISTRY:
        raise KeyError(f"unknown model type {typ!r}; known: "
                       f"{sorted(MODEL_REGISTRY) + sorted(_ASSEMBLIES)}")
    return MODEL_REGISTRY[typ](**args, generator=generator)
