"""k3_roofline.stream: the least time of the K3 convs of every padded batch
the traced window ran (bytes over the memory rate or FLOPs over the rate of
the configuration's stated precision, whichever is larger; counted from the
configuration at each batch's size by the port's eligibility rule, see
``harness/conv1024.py``) over the device time of the kernels the trace
names conv3x3_lowch."""

from harness import conv1024, work


def read(run):
    t, f = run.trace, run.facts
    if t is None or not f.get("batches") or work.peaks(run.kind) is None:
        return None
    ms = t.seconds_of("conv3x3_lowch") * 1e3
    if ms <= 0:
        return None
    model, cfg = run.cell.config["model"], run.cell.config
    least = sum(conv1024.least_ms(*conv1024.k3_work(model, b), run.kind, cfg)
                for b in f["batches"])
    return 100.0 * least / ms
