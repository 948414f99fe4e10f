"""pipe_midepoch_ready_share.train: the share of the step loop's requests
for a batch in the traced window, other than each epoch's first, that
found the batch built already (the ``ready`` of the port's ``data.wait``
spans with ``epoch_batch`` above 0).  Beside ``pipe_ready_share.train`` it
says whether the waits fall at the epochs' starts."""

from harness import spans


def read(run):
    mid = [r for r in spans.in_window(run, "data.wait")
           if r.attrs.get("epoch_batch", 0) > 0]
    return spans.share(mid, lambda r: r.attrs.get("ready"))
