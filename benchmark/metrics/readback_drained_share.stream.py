"""readback_drained_share.stream: the share of the engine's readbacks in
the traced window that returned with the device drained (``drained`` of
the port's ``serve.readback`` span: the newest queued batch had already
finished, so nothing was left queued), or None where no readback carries
the attribute."""

from harness import spans


def read(run):
    marked = [r for r in spans.in_window(run, "serve.readback")
              if "drained" in r.attrs]
    return spans.share(marked, lambda r: r.attrs["drained"])
