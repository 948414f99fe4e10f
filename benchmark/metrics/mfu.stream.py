"""mfu.stream: the whole forward's share of the card's dense peak at the
configuration's stated precision (TF32 convolutions as served: the TF32
tensor rate): the generator's FLOPs an image (counted from the
configuration) times the composites returned a second in the traced
window, over the peak."""

from harness import work


def read(run):
    f = run.facts
    peak = work.peak_flops(run.kind, run.cell.config)
    if not f.get("images") or peak is None:
        return None
    flops = work.generator_flops(run.cell.config["model"])
    return 100.0 * flops * f["images"] / f["seconds"] / peak
