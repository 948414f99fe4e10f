"""The work of kernel K3 (the port's ``ops/conv1024``), counted from a
configuration's shapes alone.

K3 runs the convs of the port's ``conv1024_eligible`` rule: 3x3, stride 1,
pad 1, groups 1, at most 32 channels in and out, on a square plane of at
least 1024^2 whose side divides by 8.  In the generator the 3x3 stride-1
convs are the encoder's ``conv0`` of each level and its 4^2 ``conv``, and
the synthesis's ``conv1`` of each level and its 4^2 ``conv``; the encoder's
``conv1`` has stride 2 and the synthesis's ``conv0`` is a transposed conv.
Each eligible conv reads its input and weights once and writes its output
once (float32), and does 9 C_in C_out multiply-adds an output pixel.  Its
least time takes the operations at the rate of the configuration's stated
precision (``work.peak_flops``): float32 convs with TF32 allowed may run on
the TF32 tensor cores, as K3's 3xTF32 design does.
"""

from __future__ import annotations

from . import work

MIN_RES, MAX_CH, ROW_BLOCK = 1024, 32, 8


def stride1_convs(model):
    """(C_in, C_out, side) of every 3x3 stride-1 conv of one forward."""
    a = model["args"]
    e, s = a["encoder"]["args"], a["synthesis"]["args"]
    ce = lambda r: work._ch(e["ch_base"], e["ch_max"], r)  # noqa: E731
    cs = lambda r: work._ch(s["ch_base"], s["ch_max"], r)  # noqa: E731
    out = [(ce(r), ce(r), r) for r in work._levels(e["resolution"], 8)]
    out.append((ce(4) + e.get("mbstd_c_n", 0), ce(4), 4))
    out.append((cs(4), cs(4), 4))
    out += [(cs(r), cs(r), r) for r in work._levels(s["resolution"], 8)]
    return out


def eligible_convs(model):
    """The convs of one forward that K3 runs: (C_in, C_out, side)."""
    return [(ci, co, r) for ci, co, r in stride1_convs(model)
            if ci <= MAX_CH and co <= MAX_CH and r >= MIN_RES
            and r % ROW_BLOCK == 0]


def k3_work(model, batch):
    """(bytes, FLOPs) of one forward's K3 convs at ``batch`` (float32)."""
    nbytes = flops = 0
    for ci, co, r in eligible_convs(model):
        nbytes += 4 * (batch * (ci + co) * r * r + co * ci * 9)
        flops += 2 * batch * co * ci * 9 * r * r
    return nbytes, flops


def least_ms(nbytes, flops, kind, config):
    """The least time on card ``kind``: bytes over the memory rate or FLOPs
    over the dense rate of ``config``'s stated precision, the larger."""
    return max(nbytes / work.peaks(kind)["hbm_bytes"],
               flops / work.peak_flops(kind, config)) * 1e3
