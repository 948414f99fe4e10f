"""mfu.train: the whole training step's share of the card's dense peak at
the configuration's stated precision (float32 without TF32: the CUDA
cores' float32 rate; with TF32: the TF32 tensor rate): the step's FLOPs
an image (counted from the configuration, the regularizers weighted by
their intervals) times the images trained a second in the traced window,
over the peak."""

from harness import work


def read(run):
    f = run.facts
    peak = work.peak_flops(run.kind, run.cell.config)
    if not f.get("steps") or peak is None:
        return None
    rate = f["steps"] * f["batch"] / f["seconds"]
    flops = work.train_flops_per_image(run.cell.config)
    return 100.0 * flops * rate / peak
