"""k2_roofline.stream: the least time of the FIR resampling of every
padded batch the traced window ran (bytes over the memory rate or
operations over the float32 rate, whichever is larger; counted from the
configuration at each batch's size) over the device time of the kernels
the trace names upfirdn2d."""

from harness import work


def read(run):
    t, f = run.trace, run.facts
    if t is None or not f.get("batches") or work.peaks(run.kind) is None:
        return None
    ms = t.seconds_of("upfirdn2d") * 1e3
    if ms <= 0:
        return None
    model = run.cell.config["model"]
    least = sum(work.least_ms(*work.fir_work(model, b), run.kind)
                for b in f["batches"])
    return 100.0 * least / ms
