"""engine_z_ms.stream: the time the engine takes a batch to draw its latent
codes, one per row from the row's global position (the port's
``serve.z`` spans inside ``serve.batch``), over the batches enqueued in
the traced window."""

from harness import spans


def read(run):
    return spans.per_parent_ms(run, "serve.batch", "serve.z")
