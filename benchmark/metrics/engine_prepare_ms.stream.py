"""engine_prepare_ms.stream: the time the engine takes a batch to normalize
its inputs and pad them to the batch's rows (the port's ``serve.prepare``
spans inside ``serve.batch``), over the batches enqueued in the traced
window."""

from harness import spans


def read(run):
    return spans.per_parent_ms(run, "serve.batch", "serve.prepare")
