"""Feature-bank evaluators around the shared Inception detector (port of
``FeatureBankEvaluator`` of ``shgan_tpu/eval/feature_metrics.py``; KID, PR
and IS come later).

Real features are cached at ``<cache_dir>/<tag>_<policy>_real_feat.npy``,
the JAX package's name, so the two packages share caches.  The banks are
float64, like the reference's.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch

from .base import BaseEvaluator
from .detector import get_detector, resolve_resize_policy


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
            self.dsstat_use_cache = osp.isfile(self.dsstat_cache_file)
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
                if (self.dsstat_cache_file is not None
                        and not osp.isfile(self.dsstat_cache_file)):
                    os.makedirs(osp.dirname(self.dsstat_cache_file),
                                exist_ok=True)
                    np.save(self.dsstat_cache_file, real_feat)
        return fake_feat, real_feat, fake_probs

    def clear_data(self):
        self.data_fake_feat = []
        self.data_fake_probs = []
        self.data_real_feat = []
