"""KID, precision/recall and IS: the port's metric math equal to shgan_tpu's
on the same features, its evaluators equal to JAX's on the same batches
(both fed by one stand-in detector, so the comparison holds the banks, the
cache and the sample counts, not Inception, which tests/test_torch_eval.py
holds at its golden fixture), the compose's one detector pass a batch, and
the real-feature cache shared by the two packages."""

import numpy as np
import pytest
import torch

from shgan_tpu.eval import base as jbase
from shgan_tpu.eval import feature_metrics as jfm
from shgan_tpu.eval import stylegan_metrics as jsm
from shgan_torch.eval import base as tbase
from shgan_torch.eval import detector as tdet
from shgan_torch.eval import feature_metrics as tfm
from shgan_torch.eval import stylegan_metrics as tsm


def _feats(seed, n, d=64):
    rng = np.random.RandomState(seed)
    return rng.randn(n, d) * rng.rand(d) + rng.randn(d)


@pytest.mark.parametrize("seed", [0, 1])
def test_metric_math_equals_jax(seed):
    real, fake = _feats(seed, 40), _feats(seed + 10, 33)
    kw = dict(num_subsets=7, max_subset_size=25, seed=seed)
    assert tsm.compute_kid(real, fake, **kw) == jsm.compute_kid(
        real, fake, **kw)
    for nb in (3, 5):
        assert tsm.compute_precision_recall(
            real, fake, nhood_size=nb, batch=16) == \
            jsm.compute_precision_recall(real, fake, nhood_size=nb, batch=16)
    p = np.random.RandomState(seed).dirichlet(np.ones(12), 50)
    assert tsm.compute_inception_score(p, 5) == \
        jsm.compute_inception_score(p, 5)
    a, b = _feats(seed, 6, 8), _feats(seed + 1, 6, 8)
    t = np.random.RandomState(seed).rand(6, 1)
    np.testing.assert_array_equal(tsm.slerp(a, b, t), jsm.slerp(a, b, t))
    d = np.random.RandomState(seed).exponential(size=500)
    assert tsm.ppl_from_distances(d) == jsm.ppl_from_distances(d)


class _StandIn:
    """One detector for both packages: a fixed projection of the 8×8
    box-downsampled pixels, and a softmax of a second projection."""

    has_probs = True

    def __init__(self):
        rng = np.random.RandomState(0)
        self.w = rng.randn(3 * 64, 24).astype(np.float32) / 4e3
        self.v = rng.randn(24, 10).astype(np.float32) / 8
        self.calls = 0

    def features(self, x):
        self.calls += 1
        x = np.asarray(x, np.float32)
        n, c, h, w = x.shape
        x = x.reshape(n, c, 8, h // 8, 8, w // 8).mean((3, 5))
        return x.reshape(n, -1) @ self.w

    def features_and_probs(self, x):
        f = self.features(x)
        e = np.exp(f @ self.v - (f @ self.v).max(1, keepdims=True))
        return f, e / e.sum(1, keepdims=True)


EVALUATORS = [
    {"type": "fid", "args": {"dsstat_cachefile_tag": "t"}},
    {"type": "kid", "args": {"dsstat_cachefile_tag": "t", "num_subsets": 9,
                             "max_subset_size": 8, "kid_seed": 3}},
    {"type": "pr", "args": {"dsstat_cachefile_tag": "t", "nhood_size": 3}},
    {"type": "is", "args": {"num_splits": 3}},
]


def _run(base_mod, fm_mod, cache_dir, monkeypatch, n_batches=3, drop=2):
    det = _StandIn()
    monkeypatch.setattr(fm_mod, "get_detector", lambda *a, **k: det)
    cfg = [dict(c, args=dict(c["args"], cache_dir=str(cache_dir)))
           for c in EVALUATORS]
    ev = base_mod.get_evaluator(cfg)
    rng = np.random.RandomState(5)
    for b in range(n_batches):
        fake = rng.randint(0, 256, (4, 3, 16, 16)).astype(np.float32)
        real = rng.randint(0, 256, (4, 3, 16, 16)).astype(np.float32)
        valid = np.ones(4, bool)
        if b == n_batches - 1:
            valid[4 - drop:] = False
        ev.add_batch(fake=fake, real=real, pred=fake / 255, gt=real / 255,
                     valid=valid)
    ev.set_sample_n(4 * n_batches - drop)
    return ev.compute(), det.calls


def test_evaluators_equal_jax_and_share_the_cache(tmp_path, monkeypatch):
    import shgan_tpu.eval.fid  # noqa: F401  (JAX registration)
    j, j_calls = _run(jbase, jfm, tmp_path / "j", monkeypatch)
    t, t_calls = _run(tbase, tfm, tmp_path / "t", monkeypatch)
    assert set(t) == set(j) == {"fid", "kid", "pr", "is"}
    assert t["kid"] == j["kid"] and t["pr"] == j["pr"]
    assert t["is"] == j["is"] and np.isfinite(t["is"]["is_mean"])
    assert t["fid"] == pytest.approx(j["fid"], rel=1e-12)
    # the stand-in has no memo: fid, kid and pr read fake and real, is the
    # fakes, each batch
    assert t_calls == j_calls == 21
    cache = tmp_path / "t" / "t_ts_real_feat.npy"
    assert cache.is_file()
    # the port's cache, read by JAX: the same values, no real features
    # computed; and the port reads it back too
    j2, j2_calls = _run(jbase, jfm, tmp_path / "t", monkeypatch)
    t2, t2_calls = _run(tbase, tfm, tmp_path / "t", monkeypatch)
    assert j2_calls == t2_calls == 12
    for rv in (j2, t2):
        assert rv["kid"] == t["kid"] and rv["pr"] == t["pr"]
        assert rv["fid"] == pytest.approx(t["fid"], rel=1e-12)


def test_compose_runs_inception_once_a_batch(tmp_path, monkeypatch):
    """fid + kid + pr + is on the port's Inception detector: one backbone
    pass for the fakes and one for the reals a batch, the probabilities
    from the fakes' features (the classifier head alone)."""
    params = {"fc": {"weight": torch.zeros(16, 2048)}}   # stands in
    passes, heads = [], []

    def features(p, x, policy):   # 24 features: FID's sqrtm stays cheap
        passes.append(tuple(x.shape))
        return x.float().mean((2, 3)).repeat(1, 8)

    def probs(p, feat):
        heads.append(tuple(feat.shape))
        return torch.softmax(feat[:, :16], 1)

    monkeypatch.setattr(tdet, "inception_features", features)
    monkeypatch.setattr(tdet, "inception_probs_from_features", probs)
    ev = tbase.get_evaluator(
        [dict(c, args=dict(c["args"], detector_params=params,
                           cache_dir=str(tmp_path)))
         for c in EVALUATORS])
    assert len({id(e.detector) for e in ev.evaluators}) == 1
    rng = np.random.RandomState(0)
    for _ in range(2):
        fake = torch.from_numpy(rng.randint(0, 256, (4, 3, 8, 8)).astype(
            np.uint8))
        real = torch.from_numpy(rng.randint(0, 256, (4, 3, 8, 8)).astype(
            np.uint8))
        ev.add_batch(fake=None, real=None, fake_dev=fake, real_dev=real,
                     pred_dev=fake, gt_dev=real)
    assert len(passes) == 4 and len(heads) == 2
    ev.set_sample_n(8)
    rv = ev.compute()
    assert np.isfinite([rv["fid"], rv["kid"], rv["pr"]["precision"],
                        rv["is"]["is_mean"]]).all()
