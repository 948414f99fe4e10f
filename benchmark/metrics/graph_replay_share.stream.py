"""graph_replay_share.stream: the share of the batches enqueued in the
traced window that replayed a captured CUDA graph (the ``path`` of the
port's ``serve.batch`` span: ``replay``, ``capture`` or ``eager``)."""

from harness import spans


def read(run):
    return spans.share(spans.in_window(run, "serve.batch"),
                       lambda r: r.attrs.get("path") == "replay")
