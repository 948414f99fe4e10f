"""compiled_replay_ms.stream: the time the compiled forward takes a batch to
launch its CUDA graph and copy the output out of the graph's pool (the
port's ``compiled.replay`` spans inside ``serve.batch``), over the batches
enqueued in the traced window."""

from harness import spans


def read(run):
    return spans.per_parent_ms(run, "serve.batch", "compiled.replay")
