"""pipe_build_ms.train: the mean time one of the pipeline's worker threads
takes to build a batch (the port's ``data.build`` span: PNG decode, masks,
the formatter and the pinned copy), over the builds that ended in the
traced window."""

from harness import spans


def read(run):
    return spans.mean_ms(spans.in_window(run, "data.build", ended=True))
