"""shgan_torch noise RNG (the module of kernel K1): Philox4x32-10 known-answer
vectors, the N(0,1) statistics, determinism, stream independence, layout.

No JAX comparison: the noise streams differ between implementations by
design (shgan_tpu/ops/noise.py:17-20)."""

import numpy as np
import pytest
import torch

from shgan_torch.ops import noise

# Random123 known-answer vectors for philox4x32_10
KAT = [
    ((0, 0), (0, 0, 0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF,) * 4,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0xA4093822, 0x299F31D0),
     (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("key,ctr,want", KAT)
def test_philox_known_answers(key, ctr, want):
    words = [torch.tensor([c], dtype=torch.int64) for c in ctr]
    got = noise.philox4x32_10(*words, *key)
    assert tuple(int(w) for w in got) == want


def test_mulhilo_matches_python_ints():
    rng = np.random.RandomState(0)
    b = rng.randint(0, 2 ** 32, size=1000, dtype=np.int64)
    b[:3] = [0, 1, 2 ** 32 - 1]
    for a in (noise._M0, noise._M1, 0xFFFFFFFF):
        hi, lo = noise._mulhilo(a, torch.from_numpy(b))
        prod = [a * int(v) for v in b]
        assert hi.tolist() == [p >> 32 for p in prod]
        assert lo.tolist() == [p & 0xFFFFFFFF for p in prod]


def test_normal_stats():
    x = noise.philox_normal((3, 4), 8, 128, "cpu").numpy()
    assert x.shape == (8, 128, 128)
    assert abs(x.mean()) < 0.02 and abs(x.std() - 1) < 0.02
    kurt = ((x - x.mean()) ** 4).mean() / x.std() ** 4
    assert abs(kurt - 3.0) < 0.1
    # each half alone (the cos half, the sin half) is N(0,1) too
    for half in (x[:, :64], x[:, 64:]):
        assert abs(half.mean()) < 0.03 and abs(half.std() - 1) < 0.03


def test_deterministic_per_key():
    a = noise.random_noise(11, 17, 4, 32, "cpu")
    b = noise.random_noise(11, 17, 4, 32, "cpu")
    assert torch.equal(a, b)


def test_element_independent_of_batch():
    """An element is a function of (key, row, index): a smaller batch gives
    the same leading rows."""
    a = noise.philox_normal((5, 6), 4, 16, "cpu")
    b = noise.philox_normal((5, 6), 2, 16, "cpu")
    assert torch.equal(a[:2], b)


def test_streams_distinct_across_rows_layers_seeds():
    x = noise.random_noise(1, 8, 4, 16, "cpu").reshape(4, -1)
    for i in range(4):
        for j in range(i + 1, 4):
            assert abs(float(torch.corrcoef(x[[i, j]])[0, 1])) < 0.25
            assert not torch.equal(x[i], x[j])
    y = noise.random_noise(1, 9, 4, 16, "cpu").reshape(4, -1)
    z = noise.random_noise(2, 8, 4, 16, "cpu").reshape(4, -1)
    assert not torch.equal(x, y) and not torch.equal(x, z)
    assert noise.noise_key(1, 8) != noise.noise_key(1, 9)


def test_layout_cos_then_sin_halves():
    """Pair p of row i: cos normal at flat index p, sin at R²/2 + p, both
    from the same radius — so cos² + sin² pairs up as r²."""
    key, res = (7, 9), 8
    x = noise.philox_normal(key, 2, res, "cpu").reshape(2, -1)
    half = res * res // 2
    calls = torch.arange(res * res // 4)
    o = noise.philox4x32_10(calls, torch.ones_like(calls), calls * 0,
                            calls * 0, *key)
    u1 = 2.0 - noise._bits_to_unit(o[0])
    r2 = -2.0 * torch.log(u1)
    got = x[1, 0:half:2] ** 2 + x[1, half::2] ** 2
    torch.testing.assert_close(got, r2, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("res", [4, 8, 64])
def test_random_noise_shape_dtype(res):
    x = noise.random_noise(0, 3, 3, res, "cpu")
    assert x.shape == (3, 1, res, res) and x.dtype == torch.float32
    assert torch.isfinite(x).all()


def test_odd_resolution_rejected():
    with pytest.raises(ValueError):
        noise.philox_normal((0, 0), 1, 5, "cpu")
