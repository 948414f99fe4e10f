"""The port's evaluators against shgan_tpu's on the CPU: Inception features at
the committed golden fixture, Fréchet distance and feature statistics,
PSNR, SSIM, the FID cache name, the detector's weight resolution and the
evaluator compose."""

import json
import os.path as osp
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from shgan_tpu.eval import feature_metrics as jfm
from shgan_tpu.eval.fid import feature_stats as j_stats
from shgan_tpu.eval.fid import frechet_distance as j_fd
from shgan_tpu.eval.inception import \
    random_inception_state_dict as j_random_sd
from shgan_tpu.eval.psnr import PSNREvaluator as JPSNR
from shgan_tpu.eval.ssim import compute_ssim as j_ssim
from shgan_torch.eval import detector as tdet
from shgan_torch.eval import get_evaluator
from shgan_torch.eval.feature_metrics import real_feature_cache_file
from shgan_torch.eval.fid import feature_stats, frechet_distance
from shgan_torch.eval.inception import (inception_features_and_probs,
                                        load_inception_params,
                                        random_inception_state_dict)
from shgan_torch.eval.psnr import PSNREvaluator
from shgan_torch.eval.ssim import compute_ssim

HERE = osp.dirname(osp.abspath(__file__))
sys.path.insert(0, osp.join(osp.dirname(HERE), "tools"))
from validate_fid import fixed_batch  # noqa: E402

FIXTURE = osp.join(HERE, "fixtures", "inception_golden_random.npz")


@pytest.fixture(scope="module")
def fixture_params():
    fx = np.load(FIXTURE)
    return fx, load_inception_params(random_inception_state_dict(
        int(fx["seed"])))


def test_random_state_dict_is_the_jax_one():
    j, t = j_random_sd(3), random_inception_state_dict(3)
    assert list(t) == list(j)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])


@pytest.mark.parametrize("res", [256, 299, 512])
@pytest.mark.parametrize("policy", ["ts", "bilinear"])
def test_inception_matches_golden_fixture(fixture_params, res, policy):
    """The limits of tests/test_fid_fixture.py: 1e-3 on the features
    against both recorded ones, 1e-4 on the probabilities."""
    fx, params = fixture_params
    x = torch.from_numpy(fixed_batch(int(fx["n"]), res))
    feat, probs = inception_features_and_probs(params, x, policy)
    feat = feat.double().numpy()
    for src in ("pth", "jax"):
        d = np.abs(feat - fx[f"feat_{src}_{policy}_{res}"].astype(np.float64))
        assert d.max() <= 1e-3, (src, d.max())
    if policy == "ts":
        np.testing.assert_allclose(probs.numpy(), fx[f"probs_jax_{res}"],
                                   rtol=0, atol=1e-4)


def test_inception_loads_a_pth_and_refuses_unknown_policy(tmp_path,
                                                          fixture_params):
    fx, params = fixture_params
    path = str(tmp_path / "inc.pth")
    torch.save({k: torch.from_numpy(v) for k, v in
                random_inception_state_dict(int(fx["seed"])).items()}, path)
    loaded = load_inception_params(path)
    for k in ("Conv2d_1a_3x3", "fc"):
        for leaf in ("w", "b"):
            torch.testing.assert_close(loaded[k][leaf], params[k][leaf],
                                       rtol=0, atol=0)
    torch.testing.assert_close(loaded["Mixed_7c"]["branch_pool"]["w"],
                               params["Mixed_7c"]["branch_pool"]["w"])
    with pytest.raises(ValueError, match="resize_policy"):
        inception_features_and_probs(params, torch.zeros(1, 3, 64, 64),
                                     "area")


def _features(seed, n=40, d=16):
    r = np.random.RandomState(seed)
    return r.randn(n, d) * r.rand(d) + r.randn(d)


@pytest.mark.parametrize("n_req", [None, 40, 50])
def test_frechet_distance_and_stats_match_jax(n_req):
    a, b = _features(1), _features(2)
    mu1, s1 = feature_stats(a, n_req)
    mu2, s2 = feature_stats(b, n_req)
    jmu1, js1 = j_stats(a, n_req)
    np.testing.assert_allclose(mu1, jmu1, rtol=1e-12, atol=0)
    np.testing.assert_allclose(s1, js1, rtol=1e-12, atol=1e-15)
    got = frechet_distance(mu1, s1, mu2, s2)
    want = j_fd(*j_stats(a, n_req), *j_stats(b, n_req))
    assert got == pytest.approx(want, rel=1e-9)
    if n_req != 50:   # an underfull bank's biased sigma is not PSD
        assert frechet_distance(mu1, s1, mu1, s1) == pytest.approx(
            0, abs=1e-6)


def _u8_pair(seed, n=3, res=24):
    r = np.random.RandomState(seed)
    a = r.randint(0, 256, (n, 3, res, res)).astype(np.uint8)
    b = np.clip(a.astype(int) + r.randint(-40, 41, a.shape), 0,
                255).astype(np.uint8)
    return a, b


def test_psnr_matches_jax():
    a, b = _u8_pair(3)
    valid = np.array([True, True, False])
    got, want = PSNREvaluator(), JPSNR()
    for ev in (got, want):
        ev.add_batch(pred=a / 255.0, gt=b / 255.0, valid=valid)
        ev.set_sample_n(2)
    assert got.compute() == pytest.approx(want.compute(), abs=1e-4)


@pytest.mark.parametrize("transport", ["f32", "u8"])
@pytest.mark.parametrize("for_dataset,scale", [(None, None),
                                               ("benchmark", 2),
                                               ("div2k", 2)])
def test_psnr_device_views_match_jax_host_views(transport, for_dataset,
                                                scale):
    """The stage's device views give the JAX package's host-view PSNR."""
    from shgan_torch.runtime.stages import _views
    a, b = _u8_pair(5, n=2, res=32)
    fake = torch.from_numpy(a)
    real = torch.from_numpy(b) if transport == "u8" else torch.from_numpy(
        b.astype(np.float32) / 127.5 - 1.0)
    host, dev = _views(fake, real)
    got, want = PSNREvaluator(for_dataset, scale), JPSNR(for_dataset, scale)
    got.add_batch(pred=None, gt=None, **dev)
    want.add_batch(**host())
    np.testing.assert_allclose(got.data_psnr[0], want.data_psnr[0],
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("as_u8", [False, True])
def test_ssim_matches_jax(as_u8):
    a, b = _u8_pair(4)
    if as_u8:
        ta, tb, ja, jb = (torch.from_numpy(a), torch.from_numpy(b),
                          jnp.asarray(a), jnp.asarray(b))
    else:
        fa, fb = (a / 255.0).astype(np.float32), (b / 255.0).astype(
            np.float32)
        ta, tb, ja, jb = (torch.from_numpy(fa), torch.from_numpy(fb),
                          jnp.asarray(fa), jnp.asarray(fb))
    got = compute_ssim(ta, tb).numpy()
    want = np.asarray(j_ssim(ja, jb))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_fid_cache_name_matches_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("SHGAN_TPU_FID_RESIZE", raising=False)
    params = load_inception_params(random_inception_state_dict(0))
    for policy in (None, "bilinear"):
        ev = get_evaluator([{"type": "fid", "args": {
            "dsstat_cachefile_tag": "ffhq_val", "cache_dir": str(tmp_path),
            "detector_params": params, "resize_policy": policy}}])
        want = osp.join(str(tmp_path), f"ffhq_val_{policy or 'ts'}"
                        "_real_feat.npy")
        assert ev.evaluators[0].dsstat_cache_file == want
        assert real_feature_cache_file(str(tmp_path), "ffhq_val",
                                       policy) == want
    # the JAX package names it the same way
    jev = jfm.FeatureBankEvaluator(dsstat_cachefile_tag="ffhq_val",
                                   cache_dir=str(tmp_path),
                                   detector_params={"x": 0})
    assert jev.dsstat_cache_file == osp.join(str(tmp_path),
                                             "ffhq_val_ts_real_feat.npy")


def test_detector_weight_resolution(tmp_path, monkeypatch):
    monkeypatch.delenv("SHGAN_TPU_INCEPTION", raising=False)
    with pytest.raises(FileNotFoundError):
        tdet.get_detector()
    sd = random_inception_state_dict(1)
    path = str(tmp_path / "inc.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    monkeypatch.setenv("SHGAN_TPU_INCEPTION", path)
    by_env = tdet.get_detector()
    assert tdet.get_detector(detector_weights=path) is by_env
    params = load_inception_params(sd)
    by_params = tdet.get_detector(detector_params=params,
                                  detector_weights="/nonexistent")
    assert by_params is not by_env and by_params.params is params
    assert tdet.get_detector(detector_params=params) is by_params


def test_fid_compose_memoizes_and_saves(tmp_path, monkeypatch):
    """FID on fake == real is 0, the detector runs once per tensor, padding
    rows are dropped, and save merges into result.json; LPIPS without its
    weights raises FileNotFoundError, as in JAX."""
    params = load_inception_params(random_inception_state_dict(2))
    ev = get_evaluator([
        {"type": "fid", "args": {"detector_params": params}},
        {"type": "psnr"}, {"type": "ssim"}])
    det = ev.evaluators[0].detector
    calls = []
    run = det._run
    det._run = lambda x, want_probs: calls.append(x.shape) or run(
        x, want_probs)
    r = np.random.RandomState(0)
    for valid in ([True, True, True], [True, False, False]):
        img = torch.from_numpy(r.randint(0, 256, (3, 3, 32, 32)).astype(
            np.uint8))
        host = img.numpy().astype(np.float32)
        ev.add_batch(pred=host / 255, gt=host / 255, fake=host, real=host,
                     valid=np.array(valid), fake_dev=img, real_dev=img,
                     pred_dev=img, gt_dev=img)
    assert len(calls) == 2   # fake_dev is real_dev: one forward per batch
    ev.set_sample_n(4)
    rv = ev.compute()
    assert rv["fid"] == pytest.approx(0, abs=1e-6)
    assert rv["ssim"] == pytest.approx(1, abs=1e-6)
    assert np.isinf(rv["psnr"])
    assert ev.evaluators[0]._gather()[0].shape == (4, 2048)
    with open(ev.save(str(tmp_path)), "w") as f:
        json.dump({"lpips": {"lpips": 0.5}}, f)
    ev.save(str(tmp_path))
    with open(tmp_path / "result.json") as f:
        saved = json.load(f)
    assert set(saved) == {"lpips", "fid", "psnr", "ssim"}
    assert saved["fid"]["fid"] == pytest.approx(0, abs=1e-6)
    for var in ("SHGAN_TPU_ALEXNET", "SHGAN_TPU_LPIPS_LIN"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(FileNotFoundError):
        get_evaluator([{"type": "lpips"}])
