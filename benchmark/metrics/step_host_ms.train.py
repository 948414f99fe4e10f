"""step_host_ms.train: the host's wall time of one training step (the
port's ``train.step`` span: issuing the step's operations and every wait
inside it, for the launch queue, the allocator or a readback), over the
steps of the traced window.  Where the launch queue fills, it follows the
step's period whatever sets that: read it beside ``device_idle.train``."""

from harness import spans


def read(run):
    return spans.mean_ms(spans.in_window(run, "train.step"))
