"""FID evaluator with cached real-feature statistics (port of
``shgan_tpu/eval/fid.py``).

2048-d Inception features of the mask-composited uint8 fake and the uint8
real; Fréchet distance from the biased mean and covariance, with scipy's
matrix square root, on the host in float64.
"""

from __future__ import annotations

import numpy as np

from .base import register_evaluator
from .feature_metrics import FeatureBankEvaluator


def frechet_distance(mu1, sigma1, mu2, sigma2):
    """FID between two Gaussians."""
    import scipy.linalg
    m = np.square(mu1 - mu2).sum()
    s = scipy.linalg.sqrtm(np.dot(sigma1, sigma2))
    if isinstance(s, tuple):   # scipy versions that return (sqrtm, error)
        s = s[0]
    return float(np.real(m + np.trace(sigma1 + sigma2 - s * 2)))


def feature_stats(feat, n=None):
    """Biased mean and covariance.  ``n`` is the requested sample count:
    the covariance is divided by it even when the bank holds fewer rows,
    as the reference does."""
    feat = np.asarray(feat, np.float64)
    if n is None:
        n = feat.shape[0]
    feat = feat[:n]
    mu = feat.mean(0)
    sigma = (feat.T @ feat) / n - np.outer(mu, mu)
    return mu, sigma


@register_evaluator("fid")
class FIDEvaluator(FeatureBankEvaluator):
    def compute(self):
        fake_feat, real_feat, _ = self._gather()
        nf = (self.sample_n if self.sample_fake_n is None
              else self.sample_fake_n)
        nr = (self.sample_n if self.sample_real_n is None
              else self.sample_real_n)
        mu_f, sig_f = feature_stats(fake_feat, nf)
        mu_r, sig_r = feature_stats(real_feat, nr)
        fid = frechet_distance(mu_f, sig_f, mu_r, sig_r)
        self.final["fid"] = fid
        return fid

    def one_line_summary(self):
        self._log("Evaluator fid: {:.4f}".format(self.final["fid"]))
