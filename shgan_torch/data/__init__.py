"""Host-side helpers copied from ``shgan_tpu.data`` (no JAX there either),
with its package's names (``shgan_tpu/data/__init__.py``), each resolved
from its module at first use."""

import importlib

_NAMES = {
    "masks": ("random_mask", "random_brush", "MixedMaskGenerator",
              "LAMA_SETTINGS", "make_random_irregular_mask",
              "make_random_rectangle_mask", "make_random_superres_mask"),
    "datasets": ("FFHQZipDataset", "Places2Dataset", "ImageDirDataset",
                 "SyntheticDataset", "get_dataset"),
    "formatters": ("RandomMaskFormatter", "LamaMaskFormatter",
                   "CenterMaskFormatter", "NoMaskFormatter"),
    "sampler": ("shard_indices", "DataShard"),
    "pipeline": ("EvalPipeline", "TrainPipeline"),
}
_MODULE_OF = {name: mod for mod, names in _NAMES.items() for name in names}

__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    try:
        mod = _MODULE_OF[name]
    except KeyError:
        raise AttributeError(name) from None
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
