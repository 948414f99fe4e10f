"""Feature-bank evaluators around the shared Inception detector (port of
``shgan_tpu/eval/feature_metrics.py``): the bank every feature metric
keeps, and KID, improved precision/recall and the inception score.  FID
(:mod:`.fid`), KID, PR and IS in one compose share one Inception pass a
batch through the detector's memo.

Real features are cached at ``<cache_dir>/<tag>_<policy>_real_feat.npy``,
the JAX package's name, so the two packages share caches (the first writer
wins; FID, KID and PR of one compose share a tag).  The banks are float64,
like the reference's.  Across ranks the cache is read by no rank (whether a
file exists is one host's state, and the gathers pair the ranks' banks) and
written by the lead once the banks are gathered, then the ranks meet.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch

from ..parallel.multihost import barrier, is_lead, world_size
from .base import BaseEvaluator, register_evaluator
from .detector import get_detector, resolve_resize_policy
from .stylegan_metrics import (compute_inception_score, compute_kid,
                               compute_precision_recall)


def real_feature_cache_file(cache_dir, tag, resize_policy=None):
    """The real-feature cache path; the resize policy is part of its name
    (features under 'ts' and 'bilinear' differ)."""
    policy = resolve_resize_policy(resize_policy)
    return osp.join(cache_dir, f"{tag}_{policy}_real_feat.npy")


class FeatureBankEvaluator(BaseEvaluator):
    """Accumulates detector features of fake (and optionally real) batches,
    with the cached-real-features protocol."""

    needs_real = True
    needs_probs = False
    consumes_host_pixels = False
    consumes_device_views = True

    def __init__(self, device=None, sample_real_n=None, sample_fake_n=None,
                 dsstat_cachefile_tag=None, detector_weights=None,
                 cache_dir=".cache", detector_params=None,
                 resize_policy=None, **_):
        super().__init__()
        del device  # the features run where the batch lies
        self.sample_real_n = sample_real_n
        self.sample_fake_n = sample_fake_n
        self.data_fake_feat = []
        self.data_fake_probs = []
        self.data_real_feat = []
        self.dsstat_cache_file = None
        self.dsstat_use_cache = False
        if dsstat_cachefile_tag is not None and self.needs_real:
            self.dsstat_cache_file = real_feature_cache_file(
                cache_dir, dsstat_cachefile_tag, resize_policy)
            self.dsstat_use_cache = (osp.isfile(self.dsstat_cache_file)
                                     and world_size() == 1)
        self.detector = get_detector(detector_weights, detector_params,
                                     resize_policy)

    def add_batch(self, fake, real, valid=None, fake_dev=None, real_dev=None,
                  **_):
        """fake/real: uint8-valued [N, 3, H, W] (0..255); ``fake_dev`` /
        ``real_dev``, where given, are the same values on the device and
        feed the detector without a host round trip."""
        fx = fake if fake_dev is None else fake_dev
        rx = real if real_dev is None else real_dev
        if self.needs_probs:
            fake_feat, fake_probs = self.detector.features_and_probs(fx)
        else:
            fake_feat, fake_probs = self.detector.features(fx), None
        real_feat = None
        if self.needs_real and not self.dsstat_use_cache:
            real_feat = self.detector.features(rx)
        fake_feat, fake_probs, real_feat = self._apply_valid(
            [fake_feat, fake_probs, real_feat], valid)
        self.data_fake_feat.append(fake_feat)
        if fake_probs is not None:
            self.data_fake_probs.append(fake_probs)
        if real_feat is not None:
            self.data_real_feat.append(real_feat)

    def _gather(self):
        """→ (fake_feat, real_feat, fake_probs) float64 numpy, cut to the
        sample counts; real features come from / go to the cache file."""
        sample_fake_n = (self.sample_n if self.sample_fake_n is None
                         else self.sample_fake_n)
        sample_real_n = (self.sample_n if self.sample_real_n is None
                         else self.sample_real_n)

        def bank(chunks):
            # float32 → float64 is exact: deferring the copy changes nothing
            return np.concatenate(
                [c.double().cpu().numpy() if isinstance(c, torch.Tensor)
                 else np.asarray(c, np.float64) for c in chunks], 0)

        fake_feat = bank(self.data_fake_feat)[:sample_fake_n]
        fake_probs = None
        if self.data_fake_probs:
            fake_probs = bank(self.data_fake_probs)[:sample_fake_n]
        real_feat = None
        if self.needs_real:
            if self.dsstat_use_cache:
                real_feat = np.load(self.dsstat_cache_file)[:sample_real_n]
            else:
                real_feat = bank(self.data_real_feat)[:sample_real_n]
                if self.dsstat_cache_file is not None:
                    if is_lead() and not osp.isfile(self.dsstat_cache_file):
                        os.makedirs(osp.dirname(self.dsstat_cache_file),
                                    exist_ok=True)
                        np.save(self.dsstat_cache_file, real_feat)
                    barrier()
        return fake_feat, real_feat, fake_probs

    def clear_data(self):
        self.data_fake_feat = []
        self.data_fake_probs = []
        self.data_real_feat = []


@register_evaluator("kid")
class KIDEvaluator(FeatureBankEvaluator):
    """Kernel Inception Distance, the raw MMD (no ×1000)."""

    def __init__(self, num_subsets=100, max_subset_size=1000, kid_seed=0,
                 **kw):
        super().__init__(**kw)
        self.num_subsets = num_subsets
        self.max_subset_size = max_subset_size
        self.kid_seed = kid_seed

    def compute(self):
        fake_feat, real_feat, _ = self._gather()
        kid = compute_kid(real_feat, fake_feat,
                          num_subsets=self.num_subsets,
                          max_subset_size=self.max_subset_size,
                          seed=self.kid_seed)
        self.final["kid"] = kid
        return kid

    def one_line_summary(self):
        self._log("Evaluator kid: {:.6f}".format(self.final["kid"]))


@register_evaluator("pr")
class PREvaluator(FeatureBankEvaluator):
    """Improved precision and recall (k-NN manifolds, ``nhood_size``)."""

    def __init__(self, nhood_size=3, **kw):
        super().__init__(**kw)
        self.nhood_size = nhood_size

    def compute(self):
        fake_feat, real_feat, _ = self._gather()
        precision, recall = compute_precision_recall(
            real_feat, fake_feat, nhood_size=self.nhood_size)
        self.final["precision"] = precision
        self.final["recall"] = recall
        return {"precision": precision, "recall": recall}

    def one_line_summary(self):
        self._log("Evaluator pr: precision {:.4f} recall {:.4f}".format(
            self.final["precision"], self.final["recall"]))


@register_evaluator("is")
class ISEvaluator(FeatureBankEvaluator):
    """Inception score of the generated images; reads the fake stream only
    (no real features)."""

    needs_real = False
    needs_probs = True

    def __init__(self, num_splits=10, **kw):
        super().__init__(**kw)
        self.num_splits = num_splits

    def compute(self):
        _, _, fake_probs = self._gather()
        mean, std = compute_inception_score(fake_probs,
                                            num_splits=self.num_splits)
        self.final["is_mean"] = mean
        self.final["is_std"] = std
        return {"is_mean": mean, "is_std": std}

    def one_line_summary(self):
        self._log("Evaluator is: {:.4f} ± {:.4f}".format(
            self.final["is_mean"], self.final["is_std"]))
