"""The port's small host helpers against shgan_tpu's ``utils``:
``assert_shape`` (the same messages), ``constant_cache`` and
``device_timeit`` on the CPU (its CUDA-event path is held on the card by
tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from shgan_tpu.utils import assert_shape as j_assert_shape
from shgan_tpu.utils import constant_cache as j_constant_cache
from shgan_torch.utils import assert_shape, constant_cache, device_timeit


@pytest.mark.parametrize("ref", [(2, None, 4), (2, 3), (2, 5, 4),
                                 (None, None, None)])
def test_assert_shape_matches_jax(ref):
    x = np.zeros((2, 3, 4), np.float32)
    outcomes = []
    for fn, arr in ((assert_shape, torch.from_numpy(x)),
                    (j_assert_shape, x)):
        try:
            fn(arr, ref)
            outcomes.append(None)
        except AssertionError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


def test_constant_cache_memoizes_like_jax():
    calls = []

    def make(n):
        calls.append(n)
        return torch.arange(n)

    for cache in (constant_cache, j_constant_cache):
        calls.clear()
        f = cache(make)
        assert f(3) is f(3) and calls == [3]


def test_device_timeit_on_the_cpu():
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": x + 1}

    t = device_timeit(fn, torch.ones(4), iters=3, warmup=0)
    assert t >= 0 and len(calls) == 4   # one call finds the device
