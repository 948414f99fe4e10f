"""The plain reference of the SH-GAN inpainting generator and of the served
composite, in float32 PyTorch with TF32 off, as a function of a state dict
and the configuration file's model section.

It follows the published description (StyleGAN2's equalized-LR layers,
modulated convolution with demodulation, FIR resampling with [1, 3, 3, 1];
CoModGAN's encoder and co-modulated synthesis; SH-GAN's Spectral Hint
Unit), written as plain operations: ``F.conv2d``, ``F.conv_transpose2d``,
``torch.fft`` and elementwise ops.  The spectral constants (the Gaussian
split maps and the heterogeneous filter's basis) come from
``reference/spectral.py``, the noise from ``reference/seeds.py``.  Nothing
here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import seeds, spectral

SQRT2 = math.sqrt(2.0)


def parse_act(spec):
    """``lrelu_agc(alpha=.., gain=.., clamp=..)`` → (alpha, gain, clamp);
    None for a linear layer."""
    if spec is None:
        return None
    name, _, args = spec.partition("(")
    if name.strip() != "lrelu_agc":
        raise ValueError(f"reference: activation {spec!r}")
    out = {"alpha": 0.1, "gain": 1.0, "clamp": None}
    for part in args.rstrip(")").split(","):
        if part.strip():
            k, v = (s.strip() for s in part.split("="))
            out[k] = SQRT2 if v == "sqrt_2" else float(v)
    return out["alpha"], out["gain"], out["clamp"]


def lrelu(x, act, gain=1.0):
    """Leaky ReLU, then the gain, then the clamp (both scaled by ``gain``)."""
    if act is None:
        return x * gain if gain != 1.0 else x
    alpha, g, clamp = act
    x = torch.where(x >= 0, x, x * alpha)
    if g * gain != 1:
        x = x * (g * gain)
    if clamp is not None:
        x = torch.clamp(x, -clamp * gain, clamp * gain)
    return x


def dense(x, w, b, act=None, lr=1.0):
    y = x @ (w * (lr / math.sqrt(w.shape[1]))).t()
    if b is not None:
        y = y + (b * lr if lr != 1.0 else b)
    return lrelu(y, act)


def fir_taps(f, device):
    """The normalized 2-D FIR filter of a 1-D tap list."""
    f = np.asarray(f, np.float64)
    f = np.outer(f, f)
    f = f / f.sum()
    return torch.tensor(f, dtype=torch.float32, device=device)


def upfirdn(x, taps, up=1, down=1, pad=(0, 0, 0, 0), gain=1.0):
    """Zero-insert by ``up``, pad (x0, x1, y0, y1), convolve with ``taps``
    times ``gain``, keep every ``down``-th sample."""
    n, c, h, w = x.shape
    if up > 1:
        z = x.new_zeros((n, c, h * up, w * up))
        z[:, :, ::up, ::up] = x
        x = z
    x = F.pad(x, list(pad))
    k = (taps * gain).flip([0, 1])[None, None].expand(c, 1, *taps.shape)
    return F.conv2d(x, k, stride=down, groups=c)


def conv_layer(x, w, b, act, up=1, down=1, taps=None, gain=1.0):
    """An equalized-LR conv (weight times 1/sqrt(fan_in)) with bias and
    activation; ``down = 2``: blur, then a stride-2 conv."""
    k = w.shape[2]
    w = w * (1.0 / math.sqrt(w.shape[1] * k * k))
    if down == 2:
        x = upfirdn(x, taps, pad=(2, 2, 2, 2))
        x = F.conv2d(x, w, stride=2)
    else:
        x = F.conv2d(x, w, padding=k // 2)
    return lrelu(x + b[None, :, None, None], act, gain)


def modulated(x, w, styles, up=1, taps=None, demodulate=True):
    """StyleGAN2's modulated conv: styles scale the input channels; with
    demodulation the weight is brought to unit RMS, the styles to unit RMS
    over the whole batch, and the output scaled by
    rsqrt(sum_i wsq[o, i] s[n, i]^2 + 1e-8).  ``up = 2``: a stride-2
    transposed conv, then the [1, 3, 3, 1] filter with gain 4."""
    d = None
    if demodulate:
        w = w * torch.rsqrt(w.square().mean(dim=(1, 2, 3), keepdim=True))
        styles = styles * torch.rsqrt(styles.square().mean())
        d = torch.rsqrt(styles.square() @ w.square().sum(dim=(2, 3)).t()
                        + 1e-8)
    x = x * styles[:, :, None, None]
    if up == 2:
        x = F.conv_transpose2d(x, w.transpose(0, 1), stride=2)
        x = upfirdn(x, taps, pad=(1, 1, 1, 1), gain=4.0)
    else:
        x = F.conv2d(x, w, padding=w.shape[2] // 2)
    return x, d


def synthesis_layer(P, name, x, wvec, act, noise_key, up=1, taps=None):
    styles = dense(wvec, P[f"{name}.affine.weight"], P[f"{name}.affine.bias"])
    x, d = modulated(x, P[f"{name}.weight"], styles, up=up, taps=taps)
    n, _, r, _ = x.shape
    noise = seeds.layer_noise(noise_key, n, r, x.device) \
        * P[f"{name}.noise_strength"]
    x = noise + x * d[:, :, None, None]
    return lrelu(x + P[f"{name}.bias"][None, :, None, None], act)


def torgb(P, name, x, wvec):
    w = P[f"{name}.weight"]
    styles = dense(wvec, P[f"{name}.affine.weight"], P[f"{name}.affine.bias"]) \
        * (1.0 / math.sqrt(w.shape[1]))
    x, _ = modulated(x, w, styles, demodulate=False)
    return x + P[f"{name}.bias"][None, :, None, None]


def mapping(P, margs, z):
    act = parse_act(margs["activation"])
    x = z * torch.rsqrt(z.square().mean(dim=1, keepdim=True) + 1e-8)
    for i in range(margs["num_layers"]):
        x = dense(x, P[f"mapping.fc{i}.weight"], P[f"mapping.fc{i}.bias"],
                  act, lr=margs["lr_multiplier"])
    return x


def shu(P, eargs, x, consts):
    """The Spectral Hint Unit on [N, C, R, R]: {res: hint [N, C, res, res]}."""
    c, r = eargs["shu_channels"], eargs["shu_input_res"]
    y = torch.fft.rfft2(x, norm="forward")
    h = r // 2 + 1

    def shift(t):   # rows [h:] then [:h]
        return torch.cat([t[:, :, h:], t[:, :, :h]], dim=2)
    ff = torch.cat([shift(y.real), shift(y.imag)], dim=1)
    ff = F.conv2d(ff, P["encoder.shu.conv0.weight"],
                  P["encoder.shu.conv0.bias"])
    ff = torch.relu(ff)
    cw = consts["cweight"]
    wf = P["encoder.shu.df1.weight"].reshape(2 * c, 2 * c, cw.shape[0])
    ff = torch.einsum("nihw,iof,fhw->nohw", ff, wf, cw)
    re, im = ff[:, :c], ff[:, c:]
    out = {}
    for res, gmap in consts["gmaps"].items():
        rows = slice(r // 2 - res // 2, r // 2 + res // 2)
        k = res - res // 2 - 1

        def unshift(t):
            return torch.cat([t[:, :, k:], t[:, :, :k]], dim=2)
        sre = unshift(re[:, :, rows, :res // 2 + 1] * gmap)
        sim = unshift(im[:, :, rows, :res // 2 + 1] * gmap)
        # numpy's irfft2 on a half-spectrum: complex inverse along H, then
        # a real inverse along W reading only the real part of the DC and
        # Nyquist columns
        u = torch.fft.ifft(torch.complex(sre, sim), n=res, dim=-2,
                           norm="forward")
        keep = torch.ones(u.shape[-1], device=u.device)
        keep[0] = 0
        keep[res // 2] = 0
        u = torch.complex(u.real, u.imag * keep)
        out[res] = torch.fft.irfft(u, n=res, dim=-1, norm="forward")
    return out


def encoder(P, eargs, img, consts):
    act = parse_act(eargs["activation"])
    taps = consts["taps"]
    R = eargs["resolution"]
    x, feats = None, {}
    r = R
    while r > 4:
        p = f"encoder.b{r}"
        if r == R:
            x = conv_layer(img, P[f"{p}.fromrgb.weight"],
                           P[f"{p}.fromrgb.bias"], act)
        feat = conv_layer(x, P[f"{p}.conv0.weight"], P[f"{p}.conv0.bias"], act)
        feats[r] = feat
        x = conv_layer(feat, P[f"{p}.conv1.weight"], P[f"{p}.conv1.bias"], act,
                       down=2, taps=taps)
        r //= 2
    feat = conv_layer(x, P["encoder.b4.conv.weight"], P["encoder.b4.conv.bias"],
                      act)
    feats[4] = feat
    code = dense(feat.reshape(feat.shape[0], -1), P["encoder.b4.fc.weight"],
                 P["encoder.b4.fc.bias"], act)
    c = eargs["shu_channels"]
    hints = shu(P, eargs, feats[eargs["shu_input_res"]][:, -c:], consts)
    for res, hint in hints.items():
        f = feats[res]
        feats[res] = torch.cat([f[:, :-c], f[:, -c:] + hint], dim=1)
    return code, feats


def synthesis(P, sargs, code, feats, ws, noise_seed, consts):
    act = parse_act(sargs["activation"])
    taps = consts["taps"]
    R = sargs["resolution"]
    w0 = code
    x = dense(code, P["synthesis.b4.fc.weight"], P["synthesis.b4.fc.bias"], act)
    x = x.reshape(x.shape[0], -1, 4, 4) + feats[4]
    x = synthesis_layer(P, "synthesis.b4.conv", x,
                        torch.cat([ws[:, 0], w0], dim=1), act,
                        seeds.noise_key(noise_seed, 8))
    img = torgb(P, "synthesis.b4.torgb", x, torch.cat([ws[:, 1], w0], dim=1))
    r, wi = 8, 1
    while r <= R:
        p = f"synthesis.b{r}"
        x = synthesis_layer(P, f"{p}.conv0", x,
                            torch.cat([ws[:, wi], w0], dim=1), act,
                            seeds.noise_key(noise_seed, 2 * r), up=2,
                            taps=taps)
        x = x + feats[r]
        x = synthesis_layer(P, f"{p}.conv1", x,
                            torch.cat([ws[:, wi + 1], w0], dim=1), act,
                            seeds.noise_key(noise_seed, 2 * r + 1))
        img = upfirdn(img, taps, up=2, pad=(2, 1, 2, 1), gain=4.0)
        img = img + torgb(P, f"{p}.torgb", x,
                          torch.cat([ws[:, wi + 2], w0], dim=1))
        r, wi = r * 2, wi + 2
    return img


def constants(model, device):
    """The filter taps and the SHU's spectral constants of ``model``."""
    e = model["args"]["encoder"]["args"]
    fh, fw = (int(v) for v in e["shu_df_freedom"])
    r = e["shu_input_res"]
    return {
        "taps": fir_taps(e["resample_filter"], device),
        "cweight": torch.from_numpy(spectral.cweight(
            (fh, fw), (r, r // 2 + 1), e["shu_df_type"])).to(device),
        "gmaps": {k: torch.from_numpy(v).to(device) for k, v in
                  spectral.gaussian_split_maps(
                      r, e["shu_lowest_res"], e["shu_tail_sigma_mult"],
                      e["shu_gaussian_at_input_res"]).items()}}


def generator(P, model, x, z, noise_seed, consts):
    """The inpainting forward: ``x`` the 4-channel conditioning image,
    ``z`` the latents, ``noise_seed`` the batch's noise seed."""
    a = model["args"]
    m = a["mapping"]["args"]
    ws = mapping(P, m, z)[:, None].repeat(1, m["num_ws"], 1)
    code, feats = encoder(P, a["encoder"]["args"], x, consts)
    return synthesis(P, a["synthesis"]["args"], code, feats, ws, noise_seed,
                     consts)


@torch.no_grad()
def composite(P, model, real_u8, mask, seed, start, consts):
    """The float composite ``clip(out * 127.5 + 127.5, 0, 255)`` of one
    padded batch as the engine serves it: uint8 images [N, 3, H, W] and
    masks [N, 1, H, W] (1 = keep) on the device, the batch starting at
    global position ``start`` under the engine's ``seed``."""
    real = real_u8.float() / 127.5 - 1.0
    mask = mask.float()
    z_dim = model["args"]["mapping"]["args"]["z_dim"]
    z = torch.from_numpy(seeds.latents(
        seed, z_dim, range(start, start + real.shape[0]))).to(real.device)
    x = torch.cat([mask - 0.5, real * mask], dim=1)
    img = generator(P, model, x, z, seeds.batch_noise_seed(seed, start),
                    consts)
    out = real * mask + img * (1 - mask)
    return torch.clamp(out * 127.5 + 127.5, 0, 255)
