"""StyleGAN2-ADA metric math on feature arrays: KID, improved precision and
recall, inception score, and the perceptual path length's slerp and tail
filter (a copy of ``shgan_tpu/eval/stylegan_metrics.py``).

The numpy code is the JAX package's as it is: ``_dist_rows`` computes in
float32 and ``compute_kid`` draws its subsets from ``RandomState(seed)``,
so both packages give the same KID and precision/recall on the same
features.  The formulas:
  * KID:  polynomial-kernel MMD over random subsets
  * P&R:  k-NN manifold estimation, streamed in row blocks
  * IS:   exp(mean KL) over splits
  * PPL:  the 1 %/99 % tail filter of the path-length distances
"""

from __future__ import annotations

import numpy as np


def compute_kid(real_features, gen_features, num_subsets=100,
                max_subset_size=1000, seed=0):
    """Kernel Inception Distance (kernel_inception_distance.py:35-45)."""
    rng = np.random.RandomState(seed)
    real = np.asarray(real_features, np.float64)
    gen = np.asarray(gen_features, np.float64)
    n = real.shape[1]
    m = min(min(real.shape[0], gen.shape[0]), max_subset_size)
    t = 0.0
    for _ in range(num_subsets):
        x = gen[rng.choice(gen.shape[0], m, replace=False)]
        y = real[rng.choice(real.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.diag(a).sum()) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)


def _dist_rows(a, b, i, batch, bsq=None):
    """One row block of the pairwise distance matrix: ‖a[i:i+batch] − b‖."""
    bb = np.asarray(b, np.float32)
    if bsq is None:
        bsq = np.square(bb).sum(1)
    ai = np.asarray(a[i:i + batch], np.float32)
    d2 = np.square(ai).sum(1)[:, None] + bsq[None] - 2 * ai @ bb.T
    return np.sqrt(np.maximum(d2, 0))


def compute_precision_recall(real_features, gen_features, nhood_size=3,
                             batch=4096):
    """Improved precision & recall (precision_recall.py:37-60): a probe is
    covered if it lies within some manifold point's k-NN radius.

    Streamed in row batches like the reference: only per-row kth radii
    and per-probe coverage bits are kept — a full N×N float32 matrix at
    the 50k protocol would be 10 GB."""
    results = {}
    for name, manifold, probes in (("precision", real_features, gen_features),
                                   ("recall", gen_features, real_features)):
        mm = np.asarray(manifold, np.float32)
        msq = np.square(mm).sum(1)
        # (nhood_size+1)-th smallest including self-distance 0
        kth = np.empty(mm.shape[0], np.float32)
        for i in range(0, mm.shape[0], batch):
            d = _dist_rows(mm, mm, i, batch, msq)
            kth[i:i + batch] = np.partition(d, nhood_size,
                                            axis=1)[:, nhood_size]
        covered = np.zeros(np.asarray(probes).shape[0], bool)
        for i in range(0, covered.shape[0], batch):
            d = _dist_rows(probes, mm, i, batch, msq)
            covered[i:i + batch] = (d <= kth[None]).any(axis=1)
        results[name] = float(covered.mean())
    return results["precision"], results["recall"]


def compute_inception_score(gen_probs, num_splits=10):
    """IS over probability vectors (inception_score.py:27-35)."""
    gen_probs = np.asarray(gen_probs, np.float64)
    num_gen = gen_probs.shape[0]
    scores = []
    for i in range(num_splits):
        part = gen_probs[i * num_gen // num_splits:
                         (i + 1) * num_gen // num_splits]
        kl = part * (np.log(part) - np.log(part.mean(axis=0, keepdims=True)))
        scores.append(np.exp(np.mean(kl.sum(axis=1))))
    return float(np.mean(scores)), float(np.std(scores))


def slerp(a, b, t):
    """Spherical interpolation (perceptual_path_length.py:22-31)."""
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    d = (a * b).sum(axis=-1, keepdims=True)
    p = t * np.arccos(np.clip(d, -1, 1))
    c = b - d * a
    c = c / np.linalg.norm(c, axis=-1, keepdims=True)
    out = a * np.cos(p) + c * np.sin(p)
    # final renormalization per the reference (perceptual_path_length.py:30)
    # — for nearly-parallel a,b the normalized-c term amplifies float
    # noise off the unit sphere
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


def ppl_from_distances(dist):
    """PPL reduction with the reference's tail filtering
    (perceptual_path_length.py:119-124): discard below the 1st and above the
    99th percentile, mean the rest."""
    dist = np.asarray(dist, np.float64)
    lo = np.percentile(dist, 1, method="lower")
    hi = np.percentile(dist, 99, method="higher")
    return float(np.extract(np.logical_and(dist >= lo, dist <= hi),
                            dist).mean())
