"""pipe_wait_ms.train: the mean time the step loop waits for its next
batch from the pipeline (the benchmark's clock around the iterator's
next)."""

import statistics


def read(run):
    w = run.facts.get("wait_s")
    return statistics.mean(w) * 1e3 if w else None
