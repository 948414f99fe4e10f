"""JAX parameter trees and released ``.pth`` files → the port's state_dict.

The JAX package's parameter trees mirror the reference ``state_dict`` names
(``shgan_tpu/checkpoint/convert.py:1-14``) and the port's modules carry the
same names, so conversion is a flatten: ``params['encoder']['b64']['conv0']
['weight']`` → ``"encoder.b64.conv0.weight"``.  Layouts agree (OIHW convs,
[out, in] dense weights): nothing is transposed.  ``resample_filter``
buffers are constants in the port's modules and are dropped, after a check
that they hold the expected ``setup_filter([1, 3, 3, 1])``.
"""

from __future__ import annotations

import numpy as np
import torch

_EXPECTED_FILTER = (np.outer([1, 3, 3, 1], [1, 3, 3, 1])
                    / np.outer([1, 3, 3, 1], [1, 3, 3, 1]).sum())


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, prefix=name + "."))
        else:
            out[name] = v
    return out


def params_from_jax(params, verify_filters=True):
    """Nested (or flat) ``{name: array}`` → flat float32 torch state_dict."""
    sd = {}
    for name, value in _flatten(params).items():
        v = np.asarray(value)
        if name.split(".")[-1] == "resample_filter":
            if verify_filters and v.shape == (4, 4):
                np.testing.assert_allclose(v, _EXPECTED_FILTER, atol=1e-6)
            continue
        sd[name] = torch.from_numpy(np.array(v, dtype=np.float32))
    return sd


def load_pth(path):
    """A released ``.pth`` state_dict as the port's state_dict (tensors are
    loaded with ``weights_only=True``)."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    return params_from_jax({k: v.float().numpy() for k, v in raw.items()})

