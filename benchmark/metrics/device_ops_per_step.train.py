"""device_ops_per_step.train: device kernels, copies and sets per training
step, over the traced whole 16-step cycles."""


def read(run):
    t, f = run.trace, run.facts
    if t is None or not f.get("steps"):
        return None
    return len(t.kernels) / f["steps"]
