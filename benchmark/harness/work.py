"""The work the algorithm needs, counted from a configuration's shapes, and
the peaks of the card it runs on.

FLOPs are 2 x the multiply-adds of every convolution and dense layer (a
transposed convolution counts its input samples times its taps, not the
zeros it inserts); elementwise work, FFTs and resampling filters are left
out.  The bytes and operations of the FIR resampling (kernel K2's work) and
of the synthesis layers' epilogue (noise, demodulation, bias, activation)
follow the least-time rule: each input byte read once, each output byte
written once.  Nothing here looks at the program; the counts come from the
configuration alone.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB, data sheet, dense rates at the 700 W limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"tf32_flops": 495e12, "bf16_flops": 989e12,
                              "fp32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peaks(kind):
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``),
    or None for a device the table lacks (a CPU run reads no device
    metric)."""
    return PEAKS.get(kind)


def peak_flops(kind, config):
    """The dense peak of card ``kind`` at the precision ``config`` states:
    the TF32 tensor rate where it lets cuDNN use TF32 (``"tf32": true``),
    else the float32 rate of the CUDA cores, the most that float32
    convolutions without TF32 can reach; None for a card the table lacks."""
    p = peaks(kind)
    if p is None:
        return None
    return p["tf32_flops"] if config.get("tf32") else p["fp32_flops"]


def _ch(base, mx, r):
    return min(int(base) // r, int(mx))


def _levels(res, low=4):
    r, out = low, []
    while r <= res:
        out.append(r)
        r *= 2
    return out


def mapping_macs(m):
    w, z = m["w_dim"], m["z_dim"]
    return z * w + (m["num_layers"] - 1) * w * w


def encoder_macs(e):
    """Multiply-adds of the encoder (with the SHU where configured) for one
    image."""
    R, ch = e["resolution"], lambda r: _ch(e["ch_base"], e["ch_max"], r)
    macs = R * R * e["ic_n"] * ch(R)                     # fromrgb 1x1
    for r in _levels(R, 8)[::-1]:
        macs += r * r * ch(r) * ch(r) * 9                # conv0 3x3
        macs += (r // 2) ** 2 * ch(r) * ch(r // 2) * 9   # conv1 3x3, stride 2
    c4 = ch(4) + e.get("mbstd_c_n", 0)
    macs += 16 * c4 * ch(4) * 9 + 16 * ch(4) * e["oc_n"]  # epilogue conv, fc
    if e.get("has_extra_final_layer"):
        macs += e["oc_n"] * e["oc_n"]
    if "shu_channels" in e:
        c2, r = 2 * e["shu_channels"], e["shu_input_res"]
        fh, fw = e["shu_df_freedom"]
        half = r * (r // 2 + 1)
        macs += half * c2 * c2 + half * c2 * c2 * fh * fw  # 1x1, filter
    return macs


def synthesis_macs(s, ws_dim):
    """Multiply-adds of the co-modulated synthesis for one image."""
    R, ch = s["resolution"], lambda r: _ch(s["ch_base"], s["ch_max"], r)
    w = ws_dim
    aff = w * ch(4) * 2
    conv = s["w0_dim"] * ch(4) * 16 + 16 * ch(4) * ch(4) * 9 \
        + 16 * ch(4) * s["rgb_n"]
    for r in _levels(R, 8):
        ci, co = ch(r // 2), ch(r)
        aff += w * (ci + co + co)
        conv += (r // 2) ** 2 * ci * co * 9 + r * r * co * co * 9 \
            + r * r * co * s["rgb_n"]
    return aff + conv


def generator_flops(model):
    """FLOPs of one inpainting forward of one image."""
    a = model["args"]
    m, e, s = a["mapping"]["args"], a["encoder"]["args"], a["synthesis"]["args"]
    ws_dim = m["w_dim"] + s["w0_dim"]
    return 2 * (mapping_macs(m) + encoder_macs(e) + synthesis_macs(s, ws_dim))


def discriminator_flops(d):
    """FLOPs of one discriminator forward of one image (StyleGAN2's
    residual D: fromrgb, per level two 3x3 convs and a 1x1 skip, the
    minibatch-stddev epilogue)."""
    R, ch = d["resolution"], lambda r: _ch(d["ch_base"], d["ch_max"], r)
    macs = R * R * d["ic_n"] * ch(R)
    for r in _levels(R, 8)[::-1]:
        macs += r * r * ch(r) * ch(r) * 9                # conv0
        macs += (r // 2) ** 2 * ch(r) * ch(r // 2) * 9   # conv1, stride 2
        macs += (r // 2) ** 2 * ch(r) * ch(r // 2)       # skip 1x1
    c4 = ch(4)
    macs += 16 * (c4 + d["mbstd_c_n"]) * c4 * 9 + 16 * c4 * c4 + c4
    return 2 * macs


def fir_work(model, batch):
    """(bytes, operations) of one forward's FIR resampling at ``batch``
    (float32): the encoder's blur before each stride-2 conv, the blur after
    each synthesis up-conv and the skip image's upsampling; [1, 3, 3, 1]
    taps, a zero-inserted sample not counted."""
    a = model["args"]
    e, s = a["encoder"]["args"], a["synthesis"]["args"]
    che = lambda r: _ch(e["ch_base"], e["ch_max"], r)  # noqa: E731
    chs = lambda r: _ch(s["ch_base"], s["ch_max"], r)  # noqa: E731
    taps = len(e["resample_filter"]) ** 2
    nbytes = ops = 0
    for r in _levels(e["resolution"], 8):
        n_in, n_out = batch * che(r) * r * r, batch * che(r) * (r + 1) ** 2
        nbytes += 4 * (n_in + n_out)
        ops += 2 * n_out * taps
    for r in _levels(s["resolution"], 8):
        n_in, n_out = batch * chs(r) * (r + 1) ** 2, batch * chs(r) * r * r
        nbytes += 4 * (n_in + n_out)
        ops += 2 * n_out * taps
        n_in, n_out = batch * s["rgb_n"] * (r // 2) ** 2, batch * s["rgb_n"] * r * r
        nbytes += 4 * (n_in + n_out)
        ops += 2 * n_out * taps // 4
    return nbytes, ops


def epilogue_work(model, batch):
    """(bytes, operations) of one forward's synthesis epilogues at
    ``batch`` (float32): the conv output read and the result written; per
    sample the demodulation, noise, bias and activation (8 operations), per
    plane pixel the noise's Philox draw and Box-Muller (65)."""
    s = model["args"]["synthesis"]["args"]
    ch = lambda r: _ch(s["ch_base"], s["ch_max"], r)  # noqa: E731
    nbytes = ops = 0
    for r in _levels(s["resolution"], 4):
        layers = 1 if r == 4 else 2
        n = batch * ch(r) * r * r
        nbytes += layers * (8 * n + 4 * (batch * ch(r) + ch(r) + 1))
        ops += layers * (batch * r * r * 65 + 8 * n)
    return nbytes, ops


def least_ms(nbytes, ops, kind):
    """The least time on card ``kind``: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    p = peaks(kind)
    return max(nbytes / p["hbm_bytes"], ops / p["fp32_flops"]) * 1e3


def train_flops_per_image(cfg):
    """FLOPs of the training step an image, each pass counted by what it
    differentiates (a forward F; a backward to the inputs F, to inputs and
    weights 2F; a double backward twice the passes it differentiates),
    the regularizers weighted by their intervals and batch shares:

    * Gmain: G forward, D forward, D backward to its input, G backward:
      3 F_G + 2 F_D;
    * Dmain: G forward, D forward and backward on fakes and on reals:
      F_G + 6 F_D;
    * Gpl, on N / pl_batch_shrink rows every g_reg_interval steps: G
      forward, the synthesis backward to the styles, and the double
      backward through both: 3 (F_G + F_S);
    * R1, every d_reg_interval steps: D forward, its backward to the
      input, and the double backward through both: 6 F_D.
    """
    mg, md = cfg["model_g"], cfg["model_d"]["args"]
    lk = cfg["train"]["loss_kwargs"]
    a = mg["args"]
    s = a["synthesis"]["args"]
    f_g = generator_flops(mg)
    f_s = 2 * synthesis_macs(s, a["mapping"]["args"]["w_dim"] + s["w0_dim"])
    f_d = discriminator_flops(md)
    pl = 3 * (f_g + f_s) / lk["pl_batch_shrink"] / lk["g_reg_interval"]
    r1 = 6 * f_d / lk["d_reg_interval"]
    return 3 * f_g + 2 * f_d + f_g + 6 * f_d + pl + r1
