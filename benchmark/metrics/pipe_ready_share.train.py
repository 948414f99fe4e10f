"""pipe_ready_share.train: the share of the step loop's requests for a
batch in the traced window that found it built already (the ``ready``
of the port's ``data.wait`` span)."""

from harness import spans


def read(run):
    return spans.share(spans.in_window(run, "data.wait"),
                       lambda r: r.attrs.get("ready"))
