"""compiled_load_ms.stream: the time the compiled forward takes a batch to
load its inputs into the graph's static buffers (the port's
``compiled.load`` spans inside ``serve.batch``: the wait for the last
batch's staging copies, the pinned copies and the noise table), over the
batches enqueued in the traced window."""

from harness import spans


def read(run):
    return spans.per_parent_ms(run, "serve.batch", "compiled.load")
