"""bias_lrelu_roofline.stream: the least time of the encoder's conv
epilogues (each Conv2dLayer's bias and activation) of every padded batch
the traced window ran over the device time of the kernels the trace names
bias_lrelu.  The least time is 8 bytes an element of every encoder conv
output (read once, written once, float32) over the memory rate, counted
from the configuration at each batch's size; None where no such kernel
ran (a program that runs the conv epilogue as separate PyTorch ops)."""

from harness import work


def encoder_conv_elements(model):
    """Elements of one image's encoder conv outputs that end in a bias and
    activation: fromrgb (ch(R) at R²), conv0 (ch(r) at r²) and conv1
    (ch(r/2) at (r/2)²) for each level r from R down to 8, and the 4²
    epilogue's conv (ch(4) at 4²)."""
    e = model["args"]["encoder"]["args"]
    ch = lambda r: min(int(e["ch_base"]) // r, int(e["ch_max"]))  # noqa
    res = int(e["resolution"])
    n = ch(res) * res * res + ch(4) * 16
    r = res
    while r >= 8:
        n += ch(r) * r * r + ch(r // 2) * (r // 2) ** 2
        r //= 2
    return n


def read(run):
    t, f = run.trace, run.facts
    peaks = work.peaks(run.kind)
    if t is None or not f.get("batches") or peaks is None:
        return None
    ms = t.seconds_of("bias_lrelu") * 1e3
    if ms <= 0:
        return None
    per_image = encoder_conv_elements(run.cell.config["model"])
    least = sum(8 * per_image * b for b in f["batches"]) \
        / peaks["hbm_bytes"] * 1e3
    return 100.0 * least / ms
