"""grad_allreduce_ms.train: the mean host time of one gradient all-reduce
(the port's ``dist.grads`` span around ``Mesh.average_grads``: the flat
buffer's build, the collective's enqueue and the copy back into each
leaf's gradient), over the spans of the traced window."""

from harness import spans


def read(run):
    return spans.mean_ms(spans.in_window(run, "dist.grads"))
