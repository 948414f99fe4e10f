"""readback_wait_ms.stream: the mean time the engine takes to read one
batch's composites back to the host (the port's ``serve.readback`` span,
which waits for the device to finish every batch queued before it), over
the readbacks in the traced window."""

from harness import spans


def read(run):
    return spans.mean_ms(spans.in_window(run, "serve.readback"))
