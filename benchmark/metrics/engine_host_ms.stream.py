"""engine_host_ms.stream: the mean time the host takes to enqueue one
batch in the engine (the port's ``serve.batch`` span: normalizing and
padding, z, the compiled forward's staging and its replay), over the
batches enqueued in the traced window."""

from harness import spans


def read(run):
    return spans.mean_ms(spans.in_window(run, "serve.batch"))
