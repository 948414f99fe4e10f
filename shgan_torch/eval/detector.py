"""Shared Inception detector for the feature-space metrics (port of
``shgan_tpu/eval/detector.py``).

One :class:`InceptionDetector` serves every feature-space evaluator of a
compose: the features (and probabilities) of a batch tensor are computed
once and memoized by tensor identity.  Weights: ``detector_params`` (an
in-memory tree, tests), else the ``detector_weights`` path, else the
``SHGAN_TPU_INCEPTION`` environment variable — the JAX package's order.
"""

from __future__ import annotations

import os
import os.path as osp
import weakref

import torch

from .inception import (inception_features, inception_probs_from_features,
                        load_inception_params, params_to)

_MEMO_SLOTS = 4  # fake + real per batch, with headroom


def resolve_resize_policy(resize_policy=None):
    """None → the ``SHGAN_TPU_FID_RESIZE`` override, else 'ts'."""
    return (resize_policy or os.environ.get("SHGAN_TPU_FID_RESIZE")
            or "ts")


class InceptionDetector:
    """Inception forward under ``torch.inference_mode`` on the input's
    device, with identity-memoized per-batch results.  Memo entries hold
    the input by weak reference, so a dead tensor never matches and large
    device tensors are not kept alive between batches."""

    def __init__(self, params, resize_policy=None):
        self.params = params
        self.has_probs = "fc" in params
        self.resize_policy = resolve_resize_policy(resize_policy)
        self._on = {}     # device → parameter tree on it
        self._memo = []   # [(ref_or_tensor, is_weak, feat, probs_or_None)]

    def _params(self, device):
        if device not in self._on:
            self._on[device] = params_to(self.params, device)
        return self._on[device]

    def _find(self, x):
        for i, (ref, is_weak, _, _) in enumerate(self._memo):
            if (ref() if is_weak else ref) is x:
                return i
        return None

    def _run(self, x, want_probs):
        xt = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        p = self._params(xt.device)
        with torch.inference_mode():
            feat = inception_features(p, xt, self.resize_policy)
            probs = (inception_probs_from_features(p, feat)
                     if want_probs else None)
        try:
            entry = (weakref.ref(x), True, feat, probs)
        except TypeError:
            entry = (x, False, feat, probs)
        self._memo.append(entry)
        del self._memo[:-_MEMO_SLOTS]
        return feat, probs

    def features(self, x):
        """x: uint8-valued [N, 3, H, W] (tensor or array) → [N, 2048]
        float32 features on x's device."""
        i = self._find(x)
        if i is not None:
            return self._memo[i][2]
        return self._run(x, want_probs=False)[0]

    def features_and_probs(self, x):
        """→ ([N, 2048] features, [N, 1008] softmax probabilities)."""
        if not self.has_probs:
            raise ValueError("detector weights carry no classifier head "
                             "('fc'): the probabilities need the full "
                             "pytorch-fid pt_inception .pth")
        i = self._find(x)
        if i is not None:
            ref, is_weak, feat, probs = self._memo[i]
            if probs is None:
                with torch.inference_mode():
                    probs = inception_probs_from_features(
                        self._params(feat.device), feat)
                self._memo[i] = (ref, is_weak, feat, probs)
            return feat, probs
        return self._run(x, True)


_BY_PATH = {}
# injected trees key by id(): compose members passing the same tree share
# one detector; bounded so successive trees are not all kept alive
_BY_ID = {}
_BY_ID_MAX = 2


def get_detector(detector_weights=None, detector_params=None,
                 resize_policy=None):
    """Resolve (and cache) the shared detector: ``detector_params``, then
    ``detector_weights``, then ``SHGAN_TPU_INCEPTION``."""
    resize_policy = resolve_resize_policy(resize_policy)
    if detector_params is not None:
        key = (id(detector_params), resize_policy)
        if key not in _BY_ID:
            _BY_ID[key] = InceptionDetector(detector_params, resize_policy)
            while len(_BY_ID) > _BY_ID_MAX:
                _BY_ID.pop(next(iter(_BY_ID)))
        return _BY_ID[key]
    path = detector_weights or os.environ.get("SHGAN_TPU_INCEPTION")
    if not (path and osp.isfile(path)):
        raise FileNotFoundError(
            "Inception detector weights required: pass detector_weights=, "
            "detector_params=, or set SHGAN_TPU_INCEPTION to a pytorch-fid "
            "pt_inception .pth")
    key = (osp.abspath(path), resize_policy)
    if key not in _BY_PATH:
        _BY_PATH[key] = InceptionDetector(load_inception_params(key[0]),
                                          resize_policy)
    return _BY_PATH[key]
