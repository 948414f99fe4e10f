"""Inception-v3 FID feature extractor in plain PyTorch (port of
``shgan_tpu/eval/inception.py``).

The pytorch-fid variant of Inception-v3 (the port of the TF ``pool_3``
graph, with its count-exclude-pad average pools and the max pool of
``Mixed_7c``), eval mode only: batch norms are folded into each conv's
weight and bias at load time.  Parameters are a nested dict
``{module: {"w": [O,I,kh,kw], "b": [O]}}`` (``{module: {branch: ...}}`` for
the mixed blocks), the JAX package's layout, with float32 CPU tensors.

The convolutions, pools and the head's matmul are large library ops, as the
JAX package left them to XLA.  Weights are not bundled: load a pytorch-fid
``pt_inception-2015-12-05`` ``.pth`` with :func:`load_inception_params`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_BN_EPS = 1e-3


def _conv_bn(p, x, stride=1, padding=(0, 0)):
    if isinstance(padding, int):
        padding = (padding, padding)
    y = F.conv2d(x, p["w"], p["b"], stride=stride, padding=padding)
    return torch.relu(y)


def _maxpool(x, k=3, s=2, pad=0):
    return F.max_pool2d(x, k, s, pad)


def _avgpool_exc(x):
    """3×3 average pooling, stride 1, count_include_pad=False."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _inception_a(p, x):
    b1 = _conv_bn(p["branch1x1"], x)
    b5 = _conv_bn(p["branch5x5_1"], x)
    b5 = _conv_bn(p["branch5x5_2"], b5, padding=2)
    b3 = _conv_bn(p["branch3x3dbl_1"], x)
    b3 = _conv_bn(p["branch3x3dbl_2"], b3, padding=1)
    b3 = _conv_bn(p["branch3x3dbl_3"], b3, padding=1)
    bp = _conv_bn(p["branch_pool"], _avgpool_exc(x))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _inception_b(p, x):
    b3 = _conv_bn(p["branch3x3"], x, stride=2)
    bd = _conv_bn(p["branch3x3dbl_1"], x)
    bd = _conv_bn(p["branch3x3dbl_2"], bd, padding=1)
    bd = _conv_bn(p["branch3x3dbl_3"], bd, stride=2)
    return torch.cat([b3, bd, _maxpool(x)], dim=1)


def _inception_c(p, x):
    b1 = _conv_bn(p["branch1x1"], x)
    b7 = _conv_bn(p["branch7x7_1"], x)
    b7 = _conv_bn(p["branch7x7_2"], b7, padding=(0, 3))
    b7 = _conv_bn(p["branch7x7_3"], b7, padding=(3, 0))
    bd = _conv_bn(p["branch7x7dbl_1"], x)
    bd = _conv_bn(p["branch7x7dbl_2"], bd, padding=(3, 0))
    bd = _conv_bn(p["branch7x7dbl_3"], bd, padding=(0, 3))
    bd = _conv_bn(p["branch7x7dbl_4"], bd, padding=(3, 0))
    bd = _conv_bn(p["branch7x7dbl_5"], bd, padding=(0, 3))
    bp = _conv_bn(p["branch_pool"], _avgpool_exc(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _inception_d(p, x):
    b3 = _conv_bn(p["branch3x3_1"], x)
    b3 = _conv_bn(p["branch3x3_2"], b3, stride=2)
    b7 = _conv_bn(p["branch7x7x3_1"], x)
    b7 = _conv_bn(p["branch7x7x3_2"], b7, padding=(0, 3))
    b7 = _conv_bn(p["branch7x7x3_3"], b7, padding=(3, 0))
    b7 = _conv_bn(p["branch7x7x3_4"], b7, stride=2)
    return torch.cat([b3, b7, _maxpool(x)], dim=1)


def _inception_e(p, x, pool="avg"):
    b1 = _conv_bn(p["branch1x1"], x)
    b3 = _conv_bn(p["branch3x3_1"], x)
    b3 = torch.cat([_conv_bn(p["branch3x3_2a"], b3, padding=(0, 1)),
                    _conv_bn(p["branch3x3_2b"], b3, padding=(1, 0))], dim=1)
    bd = _conv_bn(p["branch3x3dbl_1"], x)
    bd = _conv_bn(p["branch3x3dbl_2"], bd, padding=1)
    bd = torch.cat([_conv_bn(p["branch3x3dbl_3a"], bd, padding=(0, 1)),
                    _conv_bn(p["branch3x3dbl_3b"], bd, padding=(1, 0))],
                   dim=1)
    # Mixed_7c of the FID graph pools with max, not average
    bp = _avgpool_exc(x) if pool == "avg" else _maxpool(x, 3, 1, 1)
    bp = _conv_bn(p["branch_pool"], bp)
    return torch.cat([b1, b3, bd, bp], dim=1)


_STEM = [
    ("Conv2d_1a_3x3", dict(stride=2)),
    ("Conv2d_2a_3x3", dict()),
    ("Conv2d_2b_3x3", dict(padding=1)),
    ("maxpool1", None),
    ("Conv2d_3b_1x1", dict()),
    ("Conv2d_4a_3x3", dict()),
    ("maxpool2", None),
]

_MIXED = [
    ("Mixed_5b", _inception_a), ("Mixed_5c", _inception_a),
    ("Mixed_5d", _inception_a), ("Mixed_6a", _inception_b),
    ("Mixed_6b", _inception_c), ("Mixed_6c", _inception_c),
    ("Mixed_6d", _inception_c), ("Mixed_6e", _inception_c),
    ("Mixed_7a", _inception_d),
    ("Mixed_7b", lambda p, x: _inception_e(p, x, "avg")),
    ("Mixed_7c", lambda p, x: _inception_e(p, x, "max")),
]


def _ts_resize_matrix(out_size, in_size):
    """[out, in] matrix of the TF-style asymmetric bilinear resize: source
    coordinate ``s = i * in/out`` (no half-pixel centres), edge-clamped —
    what the reference's TorchScript detector computes internally.  The
    JAX package's matrix, built the same way in float32."""
    m = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        s = i * in_size / out_size
        i0 = min(int(np.floor(s)), in_size - 1)
        i1 = min(i0 + 1, in_size - 1)
        w = np.float32(s - np.floor(s))
        m[i, i0] += 1.0 - w
        m[i, i1] += w
    return m


def _bilinear_resize_matrix(out_size, in_size):
    """[out, in] matrix of half-pixel-centred bilinear resizing without
    antialiasing (pytorch-fid's ``F.interpolate``, the JAX package's
    ``jax.image.resize(..., antialias=False)``): source coordinate
    ``(i + 0.5) * in/out - 0.5``, edge-clamped."""
    m = np.zeros((out_size, in_size), np.float64)
    scale = in_size / out_size
    for i in range(out_size):
        s = (i + 0.5) * scale - 0.5
        i0 = int(np.floor(s))
        w = s - i0
        m[i, min(max(i0, 0), in_size - 1)] += 1.0 - w
        m[i, min(max(i0 + 1, 0), in_size - 1)] += w
    return m.astype(np.float32)


_RESIZE = {"ts": _ts_resize_matrix, "bilinear": _bilinear_resize_matrix}


def _resize_299(x, policy="ts"):
    """Resize to the detector's 299² input as two 1-D matrix products.

    ``"ts"`` (default): the reference TorchScript detector's resize — the
    policy that keeps absolute FID and real-feature caches comparable.
    ``"bilinear"``: pytorch-fid's half-pixel bilinear."""
    if policy not in _RESIZE:
        raise ValueError(f"unknown resize_policy [{policy}] "
                         "(expected 'ts' or 'bilinear')")
    if x.shape[2] == 299 and x.shape[3] == 299:
        return x  # the identity under both policies
    rh = torch.from_numpy(_RESIZE[policy](299, x.shape[2])).to(x.device)
    rw = torch.from_numpy(_RESIZE[policy](299, x.shape[3])).to(x.device)
    y = torch.einsum("nchw,oh->ncow", x, rh)
    return torch.einsum("ncow,pw->ncop", y, rw)


def inception_features(params, x_uint8, resize_policy="ts"):
    """uint8-valued [N, 3, H, W] (0..255, uint8 or float) → [N, 2048]
    pool features, float32."""
    x = _resize_299(x_uint8.float(), resize_policy)
    x = x / 127.5 - 1.0
    for name, kw in _STEM:
        x = _maxpool(x) if kw is None else _conv_bn(params[name], x, **kw)
    for name, fn in _MIXED:
        x = fn(params[name], x)
    return x.mean(dim=(2, 3))


def inception_probs_from_features(params, feat):
    """[N, 2048] pool features → [N, 1008] softmax probabilities.  The fc
    bias is not applied, as the reference scores IS without it."""
    w = params["fc"]["w"].reshape(params["fc"]["w"].shape[0], -1)
    return torch.softmax(feat.float() @ w.t(), dim=-1)


def inception_features_and_probs(params, x_uint8, resize_policy="ts"):
    feat = inception_features(params, x_uint8, resize_policy)
    return feat, inception_probs_from_features(params, feat)


def _fold_bn(conv_w, bn_w, bn_b, bn_mean, bn_var):
    scale = bn_w / np.sqrt(bn_var + _BN_EPS)
    w = conv_w * scale[:, None, None, None]
    b = bn_b - bn_mean * scale
    return {"w": torch.from_numpy(w.astype(np.float32)),
            "b": torch.from_numpy(b.astype(np.float32))}


def load_inception_params(weights):
    """Load pytorch-fid / torchvision Inception-v3 weights and fold the
    batch norms (in float64).  ``weights``: a ``.pth`` path, or a
    state_dict (name → array or tensor)."""
    if isinstance(weights, dict):
        sd = weights
    else:
        sd = torch.load(weights, map_location="cpu", weights_only=True)

    def arr(name):
        v = sd[name]
        v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        return v.astype(np.float64)

    params = {}
    names = {n.rsplit(".", 2)[0] for n in sd if ".conv.weight" in n}
    for name in names:
        entry = _fold_bn(arr(f"{name}.conv.weight"), arr(f"{name}.bn.weight"),
                         arr(f"{name}.bn.bias"),
                         arr(f"{name}.bn.running_mean"),
                         arr(f"{name}.bn.running_var"))
        if "." in name:
            top, sub = name.split(".", 1)
            params.setdefault(top, {})[sub] = entry
        else:
            params[name] = entry
    if "fc.weight" in sd:
        params["fc"] = {"w": torch.from_numpy(
                            arr("fc.weight").astype(np.float32)),
                        "b": torch.from_numpy(
                            arr("fc.bias").astype(np.float32))}
    return params


def params_to(params, device):
    """The parameter tree with every tensor on ``device``."""
    return {k: params_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in params.items()}


_A_CH = {"Mixed_5b": (192, 32), "Mixed_5c": (256, 64), "Mixed_5d": (288, 64)}
_C_CH = {"Mixed_6b": 128, "Mixed_6c": 160, "Mixed_6d": 160, "Mixed_6e": 192}


def inception_conv_shapes():
    """Flat {qualified_name: (out, in, kh, kw)} of every conv of the FID
    graph (plus 'fc'), named like the pytorch-fid state_dict."""
    def conv(i, o, kh, kw=None):
        return (o, i, kh, kh if kw is None else kw)

    spec = {"Conv2d_1a_3x3": conv(3, 32, 3), "Conv2d_2a_3x3": conv(32, 32, 3),
            "Conv2d_2b_3x3": conv(32, 64, 3),
            "Conv2d_3b_1x1": conv(64, 80, 1),
            "Conv2d_4a_3x3": conv(80, 192, 3)}
    for name, (ic, pc) in _A_CH.items():
        spec.update({
            f"{name}.branch1x1": conv(ic, 64, 1),
            f"{name}.branch5x5_1": conv(ic, 48, 1),
            f"{name}.branch5x5_2": conv(48, 64, 5),
            f"{name}.branch3x3dbl_1": conv(ic, 64, 1),
            f"{name}.branch3x3dbl_2": conv(64, 96, 3),
            f"{name}.branch3x3dbl_3": conv(96, 96, 3),
            f"{name}.branch_pool": conv(ic, pc, 1)})
    spec.update({
        "Mixed_6a.branch3x3": conv(288, 384, 3),
        "Mixed_6a.branch3x3dbl_1": conv(288, 64, 1),
        "Mixed_6a.branch3x3dbl_2": conv(64, 96, 3),
        "Mixed_6a.branch3x3dbl_3": conv(96, 96, 3)})
    for name, c7 in _C_CH.items():
        spec.update({
            f"{name}.branch1x1": conv(768, 192, 1),
            f"{name}.branch7x7_1": conv(768, c7, 1),
            f"{name}.branch7x7_2": conv(c7, c7, 1, 7),
            f"{name}.branch7x7_3": conv(c7, 192, 7, 1),
            f"{name}.branch7x7dbl_1": conv(768, c7, 1),
            f"{name}.branch7x7dbl_2": conv(c7, c7, 7, 1),
            f"{name}.branch7x7dbl_3": conv(c7, c7, 1, 7),
            f"{name}.branch7x7dbl_4": conv(c7, c7, 7, 1),
            f"{name}.branch7x7dbl_5": conv(c7, 192, 1, 7),
            f"{name}.branch_pool": conv(768, 192, 1)})
    spec.update({
        "Mixed_7a.branch3x3_1": conv(768, 192, 1),
        "Mixed_7a.branch3x3_2": conv(192, 320, 3),
        "Mixed_7a.branch7x7x3_1": conv(768, 192, 1),
        "Mixed_7a.branch7x7x3_2": conv(192, 192, 1, 7),
        "Mixed_7a.branch7x7x3_3": conv(192, 192, 7, 1),
        "Mixed_7a.branch7x7x3_4": conv(192, 192, 3)})
    for name, ic in (("Mixed_7b", 1280), ("Mixed_7c", 2048)):
        spec.update({
            f"{name}.branch1x1": conv(ic, 320, 1),
            f"{name}.branch3x3_1": conv(ic, 384, 1),
            f"{name}.branch3x3_2a": conv(384, 384, 1, 3),
            f"{name}.branch3x3_2b": conv(384, 384, 3, 1),
            f"{name}.branch3x3dbl_1": conv(ic, 448, 1),
            f"{name}.branch3x3dbl_2": conv(448, 384, 3),
            f"{name}.branch3x3dbl_3a": conv(384, 384, 1, 3),
            f"{name}.branch3x3dbl_3b": conv(384, 384, 3, 1),
            f"{name}.branch_pool": conv(ic, 192, 1)})
    spec["fc"] = conv(2048, 1008, 1, 1)
    return spec


def random_inception_state_dict(seed=0):
    """Shape-correct random pytorch-fid style state_dict of numpy arrays
    (copy of the JAX package's: the same seed gives the same arrays), for
    tests and smoke runs without the real weights."""
    rng = np.random.RandomState(seed)
    sd = {}
    for name, (o, i, kh, kw) in inception_conv_shapes().items():
        if name == "fc":
            sd["fc.weight"] = (rng.randn(o, i) / np.sqrt(i)).astype(
                np.float32)
            sd["fc.bias"] = np.zeros(o, np.float32)
            continue
        fan_in = i * kh * kw
        sd[f"{name}.conv.weight"] = (
            rng.randn(o, i, kh, kw) / np.sqrt(fan_in)).astype(np.float32)
        sd[f"{name}.bn.weight"] = (0.5 + rng.rand(o) * 1.5).astype(np.float32)
        sd[f"{name}.bn.bias"] = (rng.randn(o) * 0.1).astype(np.float32)
        sd[f"{name}.bn.running_mean"] = (rng.randn(o) * 0.1).astype(
            np.float32)
        sd[f"{name}.bn.running_var"] = (0.5 + rng.rand(o)).astype(np.float32)
    return sd
