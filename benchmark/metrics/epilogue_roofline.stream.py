"""epilogue_roofline.stream: the least time of the synthesis layers'
noise, demodulation, bias and activation of every padded batch run in the
traced window (counted from the configuration at each batch's size) over
the device time of the kernels the trace names noise_bias_act (not the
grad kernel)."""

from harness import work


def read(run):
    t, f = run.trace, run.facts
    if t is None or not f.get("batches") or work.peaks(run.kind) is None:
        return None
    ms = sum(b - a for a, b, n in t.kernels
             if "noise_bias_act" in n.lower() and "grad" not in n.lower()) / 1e3
    if ms <= 0:
        return None
    model = run.cell.config["model"]
    least = sum(work.least_ms(*work.epilogue_work(model, b), run.kind)
                for b in f["batches"])
    return 100.0 * least / ms
