"""LPIPS perceptual distance with the AlexNet and VGG16 backbones (port of
``shgan_tpu/eval/lpips.py``).

The backbone's conv features at five relu taps, unit-normalized per
channel, squared differences, the learned 1×1 linear weights, a spatial
mean and a sum over the taps.  The convolutions are ``F.conv2d`` (cuDNN on
the card); the JAX package runs them as ``lax.conv``, outside any Pallas
kernel.  Parameters are the JAX package's nested dict (``conv{i}`` with
``weight``/``bias``, ``lin{i}`` with ``weight``), numpy arrays or tensors,
so its random parameters carry across as they are.

Weights are not bundled:
  * alex: torchvision ``alexnet-owt*.pth`` (``features.N.*`` keys) and the
    lpips ``v0.1/alex.pth`` lin weights (``SHGAN_TPU_ALEXNET`` /
    ``SHGAN_TPU_LPIPS_LIN``);
  * vgg16: torchvision ``vgg16-*.pth`` or a flat ``conv{k}.*`` dump, and the
    lpips ``v0.1/vgg.pth`` lin weights (``SHGAN_TPU_VGG16`` /
    ``SHGAN_TPU_LPIPS_LIN_VGG``).
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch
import torch.nn.functional as F

from .base import BaseEvaluator, register_evaluator

# (out_ch, kernel, stride, pad) per conv; relu after each, maxpool after 1, 2
_ALEX_CFG = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
             (256, 3, 1, 1), (256, 3, 1, 1)]
_ALEX_TV_IDX = [0, 3, 6, 8, 10]   # torchvision features.* conv indices
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)
# VGG16: conv3x3 per block; LPIPS taps the relu ending each block
_VGG_BLOCKS = [2, 2, 3, 3, 3]
_VGG_CHANNELS = [64, 128, 256, 512, 512]
_VGG_TV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
_LIN_KEYS = ("lin{i}.model.1.weight", "lins.{i}.model.1.weight",
             "lin{i}.weight")


def _normalize_input(x):
    shift = torch.from_numpy(_SHIFT).to(x.device)[None, :, None, None]
    scale = torch.from_numpy(_SCALE).to(x.device)[None, :, None, None]
    return (x - shift) / scale


def _conv_relu(params, k, x, stride, pad):
    p = params[f"conv{k}"]
    return F.relu(F.conv2d(x, p["weight"], p["bias"], stride=stride,
                           padding=pad))


def _alex_features(params, x):
    """x in [-1, 1] → the 5 relu feature maps."""
    x = _normalize_input(x)
    feats = []
    for i, (_, _, s, p) in enumerate(_ALEX_CFG):
        x = _conv_relu(params, i, x, s, p)
        feats.append(x)
        if i in (0, 1):
            x = F.max_pool2d(x, 3, 2)
    return feats


def _vgg_features(params, x):
    """x in [-1, 1] → the 5 LPIPS relu taps (relu1_2 … relu5_3)."""
    x = _normalize_input(x)
    feats = []
    k = 0
    for bi, n in enumerate(_VGG_BLOCKS):
        for _ in range(n):
            x = _conv_relu(params, k, x, 1, 1)
            k += 1
        feats.append(x)
        if bi < len(_VGG_BLOCKS) - 1:
            x = F.max_pool2d(x, 2, 2)
    return feats


def _unit_normalize(f, eps=1e-10):
    return f / (f.square().sum(dim=1, keepdim=True).sqrt() + eps)


def lpips_distance(params, x0, x1, net="alex"):
    """x0, x1 in [-1, 1], NCHW float32 → [N] LPIPS distances.  ``params``
    must lie on the inputs' device (:func:`lpips_params_to`)."""
    feats = _vgg_features if net == "vgg16" else _alex_features
    total = 0.0
    for i, (a, b) in enumerate(zip(feats(params, x0), feats(params, x1))):
        d = (_unit_normalize(a) - _unit_normalize(b)).square()
        total = total + (d * params[f"lin{i}"]["weight"]).sum(dim=1).mean(
            dim=(1, 2))
    return total


def lpips_params_to(params, device):
    """The nested parameter dict (numpy arrays or tensors) as float32
    tensors on ``device``."""
    def tensor(v):
        if isinstance(v, torch.Tensor):
            return v.float().to(device)
        return torch.tensor(np.asarray(v, np.float32), device=device)
    return {name: {k: tensor(v) for k, v in leaf.items()}
            for name, leaf in params.items()}


def _load_sd(path):
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in sd.items()}


def _load_lins(params, lsd):
    for i in range(5):
        for pat in _LIN_KEYS:
            key = pat.format(i=i)
            if key in lsd:
                break
        else:
            raise KeyError(
                f"lin weights for layer {i} not found — expected one of "
                f"{[p.format(i=i) for p in _LIN_KEYS]} in the lin-weights "
                f"file (keys present: {sorted(lsd)[:8]}…)")
        params[f"lin{i}"] = {"weight": lsd[key]}


def load_lpips_params(alexnet_weights, lin_weights):
    """AlexNet LPIPS parameters from a torchvision ``alexnet`` ``.pth``
    (``features.N.*``) and the lpips ``alex.pth`` lin weights."""
    asd = _load_sd(alexnet_weights)
    params = {f"conv{i}": {"weight": asd[f"features.{j}.weight"],
                           "bias": asd[f"features.{j}.bias"]}
              for i, j in enumerate(_ALEX_TV_IDX)}
    _load_lins(params, _load_sd(lin_weights))
    return params


def load_vgg16_lpips_params(vgg16_weights, lin_weights):
    """VGG16 LPIPS parameters (PPL's embedding) from a torchvision
    ``vgg16`` ``.pth`` (``features.N.*``) or a flat ``conv{k}.*`` dump, and
    the lpips ``vgg.pth`` lin weights."""
    vsd = _load_sd(vgg16_weights)
    names = ([f"features.{j}" for j in _VGG_TV_IDX]
             if "features.0.weight" in vsd
             else [f"conv{k}" for k in range(len(_VGG_TV_IDX))])
    params = {f"conv{k}": {"weight": vsd[f"{n}.weight"],
                           "bias": vsd[f"{n}.bias"]}
              for k, n in enumerate(names)}
    _load_lins(params, _load_sd(lin_weights))
    return params


def resolve_lpips_params(net="alex", alexnet_weights=None,
                         vgg16_weights=None, lin_weights=None):
    """The backbone and lin weights of ``net`` from the arguments, else the
    environment variables; raises ``FileNotFoundError`` without them."""
    if net == "alex":
        aw = alexnet_weights or os.environ.get("SHGAN_TPU_ALEXNET")
        lw = lin_weights or os.environ.get("SHGAN_TPU_LPIPS_LIN")
        if not (aw and lw and osp.isfile(aw) and osp.isfile(lw)):
            raise FileNotFoundError(
                "LPIPS needs alexnet + lin weights: pass "
                "alexnet_weights=/lin_weights= or set "
                "SHGAN_TPU_ALEXNET / SHGAN_TPU_LPIPS_LIN")
        return load_lpips_params(aw, lw)
    if net == "vgg16":
        vw = vgg16_weights or os.environ.get("SHGAN_TPU_VGG16")
        lw = lin_weights or os.environ.get("SHGAN_TPU_LPIPS_LIN_VGG")
        if not (vw and lw and osp.isfile(vw) and osp.isfile(lw)):
            raise FileNotFoundError(
                "LPIPS(vgg16) needs vgg16 + lin weights: pass "
                "vgg16_weights=/lin_weights= or set "
                "SHGAN_TPU_VGG16 / SHGAN_TPU_LPIPS_LIN_VGG")
        return load_vgg16_lpips_params(vw, lw)
    raise ValueError(f"unknown LPIPS net {net!r} (alex | vgg16)")


def _random_params(convs, lin_channels, seed):
    """Shape-correct random parameters: conv weights N(0, 0.05²), zero
    biases, lin weights U(0, 1), float32 numpy."""
    rng = np.random.RandomState(seed)
    params = {}
    for k, (oc, ic, ks) in enumerate(convs):
        params[f"conv{k}"] = {
            "weight": (rng.randn(oc, ic, ks, ks) * 0.05).astype(np.float32),
            "bias": np.zeros((oc,), np.float32)}
    for i, c in enumerate(lin_channels):
        params[f"lin{i}"] = {"weight": rng.rand(1, c, 1, 1).astype(
            np.float32)}
    return params


def random_lpips_params(seed=0):
    """Random AlexNet LPIPS parameters (machinery tests, the card run)."""
    ics = [3] + [c[0] for c in _ALEX_CFG[:-1]]
    return _random_params([(oc, ic, k) for (oc, k, _, _), ic
                           in zip(_ALEX_CFG, ics)],
                          [c[0] for c in _ALEX_CFG], seed)


def random_vgg16_lpips_params(seed=0):
    """Random VGG16 LPIPS parameters (machinery tests, the card run)."""
    convs, ic = [], 3
    for n, oc in zip(_VGG_BLOCKS, _VGG_CHANNELS):
        for _ in range(n):
            convs.append((oc, ic, 3))
            ic = oc
    return _random_params(convs, _VGG_CHANNELS, seed)


def torchvision_state_dicts(params, net="alex"):
    """(backbone, lin) state_dicts of ``params`` in the layouts the loaders
    read: torchvision's ``features.N.*`` and lpips' ``linN.model.1.weight``."""
    idx = _VGG_TV_IDX if net == "vgg16" else _ALEX_TV_IDX
    backbone = {}
    for k, j in enumerate(idx):
        for name in ("weight", "bias"):
            backbone[f"features.{j}.{name}"] = torch.tensor(
                np.asarray(params[f"conv{k}"][name], np.float32))
    lin = {f"lin{i}.model.1.weight": torch.tensor(
        np.asarray(params[f"lin{i}"]["weight"], np.float32))
        for i in range(5)}
    return backbone, lin


def _to_pm1(x):
    """[0, 1] floats or uint8 0..255 → float32 in [-1, 1]."""
    x = torch.as_tensor(x)
    if x.dtype == torch.uint8:
        return x.float() / 127.5 - 1.0
    return x.float() * 2 - 1


@register_evaluator("lpips")
class LPIPSEvaluator(BaseEvaluator):
    """Per-image LPIPS of (pred, gt); reads the device views where the
    stage gives them, and keeps the distances on the device until
    ``compute``."""

    consumes_host_pixels = False
    consumes_device_views = True

    def __init__(self, net="alex", alexnet_weights=None, lin_weights=None,
                 params=None, vgg16_weights=None, **_):
        super().__init__()
        self.net = net
        self.params = params if params is not None else resolve_lpips_params(
            net, alexnet_weights=alexnet_weights,
            vgg16_weights=vgg16_weights, lin_weights=lin_weights)
        self._on = {}   # device → parameters on it
        self.data = []

    def _params(self, device):
        if device not in self._on:
            self._on[device] = lpips_params_to(self.params, device)
        return self._on[device]

    def add_batch(self, pred, gt, valid=None, pred_dev=None, gt_dev=None,
                  **_):
        """pred/gt in [0, 1] (renormalized to ±1); ``pred_dev`` / ``gt_dev``
        ([0, 1] floats or uint8 0..255 on the device) where given."""
        x0 = _to_pm1(pred if pred_dev is None else pred_dev)
        x1 = _to_pm1(gt if gt_dev is None else gt_dev).to(x0.device)
        with torch.inference_mode():
            d = lpips_distance(self._params(x0.device), x0, x1, net=self.net)
        (d,) = self._apply_valid([d], valid)
        self.data.append(d)

    def compute(self):
        d = np.concatenate([torch.as_tensor(c).double().cpu().numpy()
                            for c in self.data], 0)
        if self.sample_n is not None:
            d = d[: self.sample_n]
        self.final["lpips"] = float(d.mean())
        return self.final["lpips"]

    def one_line_summary(self):
        self._log("Evaluator lpips: {:.4f}".format(self.final["lpips"]))

    def clear_data(self):
        self.data = []
