"""allreduce_exposed_ms.train: rank 0's device milliseconds a step inside
NCCL's kernels while nothing else (no other kernel, copy or set) runs on its
card, over the traced window's steps: the union of the kernels whose name
holds ``nccl`` less the union of every other device interval.  A collective
waits on the card for the slowest rank to arrive, so the wait is in it."""


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def exposed(nccl, other):
    """Length of the union of ``nccl`` outside the union of ``other``
    (intervals as ``(start, end)`` pairs)."""
    total, busy, i = 0.0, _union(other), 0
    for a, b in _union(nccl):
        while i < len(busy) and busy[i][1] <= a:
            i += 1
        t, j = a, i
        while j < len(busy) and busy[j][0] < b:
            x, y = busy[j]
            total += max(0.0, min(x, b) - t)
            t = max(t, y)
            j += 1
        total += max(0.0, b - t)
    return total


def read(run):
    t, f = run.trace, run.facts
    if t is None or not f.get("steps"):
        return None
    lo, hi = t.window
    clip = [(max(a, lo), min(b, hi), n) for a, b, n in t.kernels]
    nccl = [(a, b) for a, b, n in clip if "nccl" in n.lower()]
    if not nccl:
        return None
    other = [(a, b) for a, b, n in clip if "nccl" not in n.lower()]
    return exposed(nccl, other) / 1e3 / f["steps"]
