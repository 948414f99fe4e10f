"""collectives_per_step.train: the collectives a training step issues on
the mesh's data group, from the port's counters over the window
(``Mesh.traffic``): the gathers of rows (``rows_calls``: every batch-wide
statistic, forward and backward) plus the gradient all-reduces
(``grad_calls``), over the window's steps.  None where the program keeps no
such counters."""


def read(run):
    c, steps = run.facts.get("traffic") or {}, run.facts.get("steps")
    if not steps or "rows_calls" not in c or "grad_calls" not in c:
        return None
    return (c["rows_calls"] + c["grad_calls"]) / steps
