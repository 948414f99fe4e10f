"""LPIPS and PPL: the port against shgan_tpu on the CPU.  LPIPS with the
alex and vgg16 backbones on JAX's random parameters carried across, the
two ``.pth`` loaders, the uint8 device-view path; the PPL sampler on a tiny
SH-GAN with JAX weights (every noise strength 0, the same x, z and t), the
exact ε = 0 distance with the noise on, and the evaluator's loop."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from shgan_tpu.checkpoint import torch_state_dict_to_params
from shgan_tpu.eval import lpips as jlp
from shgan_tpu.eval.ppl import make_ppl_sampler as j_sampler
from shgan_tpu.models import get_model as jax_get_model
from shgan_torch.checkpoint import params_from_jax
from shgan_torch.eval import lpips as tlp
from shgan_torch.eval.ppl import PPLEvaluator, make_ppl_sampler
from shgan_torch.models import get_model

from test_torch_models import _nonzero_noise_and_bias, tiny_cfg

LPIPS_RTOL = 1e-5
PPL_RTOL = 1e-3
PPL_EPS = 1e-2   # 1e-4 would compare float32 rounding divided by 1e-8


def _jax_params(net, seed):
    key = jax.random.key(seed)
    tree = (jlp.random_vgg16_lpips_params(key) if net == "vgg16"
            else jlp.random_lpips_params(key))
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=["alex", "vgg16"])
def lpips_pair(request):
    return request.param, _jax_params(request.param, 3)


def _images(seed, n=3, res=64):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-1, 1, (n, 3, res, res)).astype(np.float32)
            for _ in range(2)]


def test_lpips_distance_matches_jax(lpips_pair):
    net, params = lpips_pair
    x0, x1 = _images(0)
    want = np.asarray(jax.jit(
        lambda p, a, b: jlp.lpips_distance(p, a, b, net=net))(
            params, jnp.asarray(x0), jnp.asarray(x1)))
    got = tlp.lpips_distance(tlp.lpips_params_to(params, "cpu"),
                             torch.from_numpy(x0), torch.from_numpy(x1),
                             net=net).numpy()
    assert got.shape == want.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=LPIPS_RTOL, atol=0)


def test_loaders_read_the_same_pth(lpips_pair, tmp_path):
    """A torchvision-layout backbone and an lpips-layout lin file, written
    once, load to the same parameters in both packages."""
    net, params = lpips_pair
    backbone, lin = tlp.torchvision_state_dicts(params, net)
    bp, lp = str(tmp_path / "backbone.pth"), str(tmp_path / "lin.pth")
    torch.save(backbone, bp)
    torch.save(lin, lp)
    if net == "alex":
        got = tlp.load_lpips_params(bp, lp)
        want = jlp.load_lpips_params(bp, lp)
    else:
        got = tlp.load_vgg16_lpips_params(bp, lp)
        want = jlp.load_vgg16_lpips_params(bp, lp)
        flat = {f"conv{k}.{n}": backbone[f"features.{j}.{n}"]
                for k, j in enumerate(tlp._VGG_TV_IDX)
                for n in ("weight", "bias")}
        torch.save(flat, bp)      # the flat conv{k} dump reads the same
        got_flat = tlp.load_vgg16_lpips_params(bp, lp)
        for name in got:
            for k in got[name]:
                np.testing.assert_array_equal(got_flat[name][k],
                                              got[name][k])
    assert set(got) == set(want) == set(params)
    for name in params:
        for k in params[name]:
            np.testing.assert_array_equal(got[name][k], params[name][k])
            np.testing.assert_array_equal(got[name][k],
                                          np.asarray(want[name][k]))


def test_resolve_reads_the_environment(tmp_path, monkeypatch):
    params = _jax_params("alex", 1)
    backbone, lin = tlp.torchvision_state_dicts(params, "alex")
    torch.save(backbone, tmp_path / "a.pth")
    torch.save(lin, tmp_path / "l.pth")
    for var in ("SHGAN_TPU_ALEXNET", "SHGAN_TPU_LPIPS_LIN",
                "SHGAN_TPU_VGG16", "SHGAN_TPU_LPIPS_LIN_VGG"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(FileNotFoundError, match="SHGAN_TPU_ALEXNET"):
        tlp.resolve_lpips_params("alex")
    with pytest.raises(FileNotFoundError, match="SHGAN_TPU_VGG16"):
        tlp.resolve_lpips_params("vgg16")
    with pytest.raises(ValueError):
        tlp.resolve_lpips_params("squeeze")
    monkeypatch.setenv("SHGAN_TPU_ALEXNET", str(tmp_path / "a.pth"))
    monkeypatch.setenv("SHGAN_TPU_LPIPS_LIN", str(tmp_path / "l.pth"))
    got = tlp.resolve_lpips_params("alex")
    np.testing.assert_array_equal(got["conv2"]["weight"],
                                  params["conv2"]["weight"])


def test_evaluator_uint8_views_and_valid_rows():
    """The uint8 device views give the distances of the [0, 1] host views
    of the same pixels, and padded rows are dropped."""
    params = _jax_params("alex", 2)
    rng = np.random.RandomState(4)
    fake = rng.randint(0, 256, (3, 3, 64, 64), dtype=np.uint8)
    real = rng.randint(0, 256, (3, 3, 64, 64), dtype=np.uint8)
    a = tlp.LPIPSEvaluator(params=params)
    a.add_batch(pred=fake.astype(np.float32) / 255.0,
                gt=real.astype(np.float32) / 255.0)
    b = tlp.LPIPSEvaluator(params=params)
    b.add_batch(pred=None, gt=None, pred_dev=torch.from_numpy(fake),
                gt_dev=torch.from_numpy(real),
                valid=np.array([True, False, True]))
    da, db = a.data[0].numpy(), b.data[0].numpy()
    np.testing.assert_allclose(db, da[[0, 2]], rtol=1e-5)
    j = jlp.LPIPSEvaluator(params=params)
    j.add_batch(pred=None, gt=None, pred_dev=jnp.asarray(fake),
                gt_dev=jnp.asarray(real))
    np.testing.assert_allclose(da, j.data[0], rtol=LPIPS_RTOL)
    b.set_sample_n(2)
    assert b.compute() == pytest.approx(float(np.mean(db.astype(np.float64))),
                                      rel=1e-12)


def test_missing_weights_raise_and_ppl_falls_back(tmp_path, monkeypatch):
    for var in ("SHGAN_TPU_ALEXNET", "SHGAN_TPU_LPIPS_LIN",
                "SHGAN_TPU_VGG16", "SHGAN_TPU_LPIPS_LIN_VGG"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(FileNotFoundError):
        tlp.LPIPSEvaluator(net="alex")
    with pytest.raises(FileNotFoundError):
        PPLEvaluator(net="vgg16")
    backbone, lin = tlp.torchvision_state_dicts(_jax_params("alex", 0))
    torch.save(backbone, tmp_path / "a.pth")
    torch.save(lin, tmp_path / "l.pth")
    monkeypatch.setenv("SHGAN_TPU_ALEXNET", str(tmp_path / "a.pth"))
    monkeypatch.setenv("SHGAN_TPU_LPIPS_LIN", str(tmp_path / "l.pth"))
    logged = []
    monkeypatch.setattr(PPLEvaluator, "_log", staticmethod(logged.append))
    ev = PPLEvaluator()
    assert ev.net == "alex" and len(logged) == 1
    assert "falling back to net=alex" in logged[0]
    with pytest.raises(FileNotFoundError):
        PPLEvaluator(net="alex", alexnet_weights=str(tmp_path / "none"))


def _tiny_generators(res, seed=1, strength=0.0):
    cfg = tiny_cfg(res)
    for part in ("encoder", "synthesis"):   # 8 channels at every level
        cfg["args"][part]["args"]["ch_base"] = 8 * res
    # the port's random init carried to JAX by name (JAX's own init of a
    # 512² generator costs more than the test)
    tg = get_model(cfg, seed=seed)
    flat = _nonzero_noise_and_bias(
        {k: v.numpy() for k, v in tg.state_dict().items()})
    flat = {k: (np.float32(strength) if k.endswith("noise_strength") else v)
            for k, v in flat.items()}
    tg.load_state_dict(params_from_jax(flat), strict=True)
    return (jax_get_model(cfg), torch_state_dict_to_params(flat),
            tg.eval())


def _ppl_inputs(res, n=2, seed=5):
    rng = np.random.RandomState(seed)
    real = rng.uniform(-1, 1, (n, 3, res, res)).astype(np.float32)
    mask = (rng.rand(n, 1, res, res) > 0.4).astype(np.float32)
    x = np.concatenate([mask - 0.5, real * mask], axis=1)
    z = rng.randn(2 * n, 32).astype(np.float32)
    t = rng.uniform(0, 1, n).astype(np.float32)
    return x, z[:n], z[n:], t


@pytest.mark.parametrize("res,space,sampling,crop", [
    (32, "w", "end", False),
    (128, "z", "full", True),      # the crop: 64² into alexnet
    (512, "w", "full", False),     # a box-downsample by 2 to 256²
])
def test_ppl_sampler_matches_jax(res, space, sampling, crop):
    jg, jp, tg = _tiny_generators(res)
    lp = _jax_params("alex", 7)
    x, z0, z1, t = _ppl_inputs(res)
    if sampling == "end":
        t = np.zeros_like(t)
    want = np.asarray(j_sampler(jg, lp, PPL_EPS, space, sampling, crop,
                                net="alex")(
        jp, jnp.asarray(x), jnp.asarray(z0), jnp.asarray(z1),
        jnp.asarray(t), jax.random.key(0)))
    got = make_ppl_sampler(tg, tlp.lpips_params_to(lp, "cpu"), PPL_EPS,
                           space, sampling, crop, net="alex")(
        *(torch.from_numpy(a) for a in (x, z0, z1, t)), 11).numpy()
    assert got.shape == want.shape == (2,)
    assert np.all(want > 0)
    np.testing.assert_allclose(got, want, rtol=PPL_RTOL, atol=0)


@pytest.mark.parametrize("space", ["w", "z"])
def test_ppl_zero_step_is_exactly_zero_with_noise(space):
    """ε = 0 with the noise on: both images share the noise seed, so the
    distance is exactly 0; a seed per image would not give 0."""
    _, _, tg = _tiny_generators(32, strength=0.3)
    lp = tlp.lpips_params_to(_jax_params("alex", 7), "cpu")
    x, z0, z1, t = (torch.from_numpy(a) for a in _ppl_inputs(32))
    d = make_ppl_sampler(tg, lp, 0.0, space, "full", False,
                         net="alex").distance(x, z0, z1, t, 123)
    assert torch.equal(d, torch.zeros_like(d))
    with torch.inference_mode():
        ws = tg.mapping(z0)
        xg, feats = tg.encoder(x)
        a = tg.synthesis(xg, feats, ws, noise_mode="random", noise_seed=1)
        b = tg.synthesis(xg, feats, ws, noise_mode="random", noise_seed=2)
    assert not torch.equal(a, b)   # the noise reaches the image


def test_ppl_evaluator_contexts_and_loop():
    """Contexts from the device views (uint8 or 0..255 floats), the loop's
    sample count, the seed's determinism and the tail-filtered mean."""
    _, _, tg = _tiny_generators(32, strength=0.3)
    lp = _jax_params("alex", 7)
    rng = np.random.RandomState(2)
    real = rng.randint(0, 256, (3, 3, 32, 32), dtype=np.uint8)
    mask = (rng.rand(3, 1, 32, 32) > 0.5).astype(np.float32)

    def run(seed, views):
        ev = PPLEvaluator(num_samples=6, batch_size=4, lpips_params=lp,
                          net="alex", max_contexts=5)
        for _ in range(2):
            ev.add_batch(mask=torch.from_numpy(mask), **views)
        assert len(ev._contexts) == 5
        ev.run_generator_metrics(tg, seed=seed)
        assert [len(d) for d in ev.data_dist] == [4, 4]
        return ev, ev.compute()

    ev, p = run(0, {"real_dev": torch.from_numpy(real)})
    _, p_f = run(0, {"real": real.astype(np.float32)})
    _, p2 = run(1, {"real_dev": torch.from_numpy(real)})
    assert np.isfinite(p) and p > 0 and p == p_f and p != p2
    want = np.concatenate([mask - 0.5,
                           (real / 127.5 - 1.0) * mask], 1)[0]
    np.testing.assert_allclose(ev._contexts[0].numpy(), want, atol=1e-6)
    assert ev.needs_generator
