"""Driver of an open loop of independent users: requests of a few photos
each arrive on their own schedule and one engine serves them first come,
first served (``InpaintEngine.inpaint``, which pads a request to the
smallest latency bucket that holds it and strips the padding rows).

The offered rate, the mix's ``rate_per_s`` (a number the cell fixes), lies
below the engine's capacity.  Every request due in the window is served,
however late; one not started within ``GRACE_S`` seconds of the window's
close is not served, counts as failed, and its latency is taken as its
wait until then.  The measure is the 95th percentile of all those
latencies (``serve_p95_ms``), each from the request's due time to its
composites in host memory: the next request starts on the completion of
the one before, and the wait counts against it.

The schedule is Poisson at ``rate_per_s``: ``rate x seconds`` requests
whose gaps are the exponential distribution's quantiles at (i + 1/2) / n
and whose sizes follow the truncated geometric law on ``1..max_size``
(P(k) proportional to (1 - p)^(k - 1); ``max_size`` 1: one photo each) in
exact proportions, both shuffled by the mix's ``schedule_seed``: every run
replays one trace, and the run's seed draws the photos, masks, weights,
latents and noise.
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np

from harness.serving import Reservoir, Serving
from harness.trace import profiled

GRACE_S = 60.0


def sizes(n, p, max_size):
    """``n`` request sizes in the truncated geometric proportions, largest
    remainders rounding the counts."""
    w = [(1 - p) ** (k - 1) for k in range(1, max_size + 1)]
    share = [n * x / sum(w) for x in w]
    count = [int(s) for s in share]
    for k in sorted(range(max_size), key=lambda k: count[k] - share[k])[
            :n - sum(count)]:
        count[k] += 1
    return [k + 1 for k in range(max_size) for _ in range(count[k])]


def schedule(seed, rate, seconds, p, max_size):
    """(due seconds from the window's start, size) of every request."""
    n = max(int(round(rate * seconds)), 1)
    rng = np.random.RandomState(seed % (2 ** 32))
    gaps = np.array([-math.log(1 - (i + 0.5) / n) / rate for i in range(n)])
    rng.shuffle(gaps)
    ks = np.array(sizes(n, p, max_size))
    rng.shuffle(ks)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return [(float(d), int(k)) for d, k in zip(due, ks)]


def open_loop(plan, serve, clock=time.perf_counter, sleep=time.sleep,
              stop=None):
    """Serve ``plan`` [(due, payload)] in order; ``serve(i, payload)``
    blocks until request i is answered.  Returns per request (due, start,
    end) in seconds from the loop's start, the start being the later of the
    due time and the previous request's end; with ``stop`` no request
    starts at or after ``stop`` seconds."""
    t0 = clock()
    out = []
    for i, (due, payload) in enumerate(plan):
        now = clock() - t0
        if now < due:
            sleep(due - now)
            now = clock() - t0
        if stop is not None and now >= stop:
            break
        serve(i, payload)
        out.append((due, now, clock() - t0))
    return out, t0


def latencies(plan, times, stop):
    """Each due request's latency in seconds: a served one's from its due
    time to its end; one never started (the loop stopped at ``stop``) its
    wait until the later of ``stop`` and the last end."""
    end = max([stop] + [e for _, _, e in times])
    return [e - d for d, _, e in times] + [end - d
                                           for d, _ in plan[len(times):]]


def p95(values):
    return statistics.quantiles(values, n=100, method="inclusive")[94]


class Driver:
    def __init__(self, cell, log):
        self.cell, self.log = cell, log
        self.serving = Serving(cell)

    def _request(self, i, k):
        """Request i's k photos and masks: slices of the pool (views, so
        that making a request costs the loop nothing)."""
        s = self.serving
        p = len(s.images)
        rng = np.random.RandomState((self.cell.seed + 7919 * i) % (2 ** 32))
        a, b = rng.randint(p - k + 1, size=2)
        return s.images[a:a + k], s.masks[b:b + k]

    def setup(self):
        t = self.cell.traffic
        self.engine = self.serving.build(
            batch_size=t["max_size"], latency_batches=tuple(t["buckets"]),
            **self.cell.settings.get("engine", {}))
        # warm-up: one request a bucket, each bucket's graph captured
        for i, k in enumerate(sorted(set(t["buckets"]) | {t["max_size"]})):
            imgs, masks = self._request(-1 - i, k)
            self.engine.inpaint(imgs, masks)

    def window(self, tracing):
        from torch.profiler import record_function
        t, cell = self.cell.traffic, self.cell
        seconds = min(cell.seconds, t.get("trace_seconds", cell.seconds)) \
            if tracing else cell.seconds
        plan = schedule(t["schedule_seed"], t["rate_per_s"], seconds, t["p"],
                        t["max_size"])
        buckets = sorted(set(t["buckets"]) | {t["max_size"]})
        per = int(cell.settings.get("check_per_bucket", 3))
        keep = {b: Reservoir(per, cell.seed + b) for b in buckets}
        starts = [0]
        for _, k in plan:
            starts.append(starts[-1] + k)

        def serve(i, k):
            imgs, masks = self._request(i, k)
            with record_function("bench.request"):
                out = self.engine.inpaint(imgs, masks, start_index=starts[i])
            keep[next(b for b in buckets if b >= k)].offer((i, k, out))

        with profiled(tracing) as prof:
            with record_function("bench.window"):
                cell.start_window()
                times, _ = open_loop(plan, serve, stop=seconds + GRACE_S)
        end = times[-1][2] if times else seconds
        lat = latencies(plan, times, seconds + GRACE_S)
        done = sum(plan[i][1] for i in range(len(times)))
        service = [e - s for _, s, e in times]
        late = [s - d for d, s, _ in times]
        for b in buckets:
            for i, k, out in keep[b].items:
                imgs, masks = self._request(i, k)
                pad = [(0, b - k), (0, 0), (0, 0), (0, 0)]
                self.serving.keep(np.pad(imgs, pad),
                                  np.pad(masks, pad, constant_values=1),
                                  starts[i], k, out)
        self.log(f"open loop: {len(plan)} requests due at {t['rate_per_s']}/s "
                 f"in {seconds} s, {len(times)} served ({done} images), the "
                 f"last at {end:.3f} s; p95 {p95(lat) * 1e3:.3f} ms over "
                 f"{len(lat)} latencies; mean start after due "
                 f"{statistics.mean(late) * 1e3:.3f} ms; median service "
                 f"{statistics.median(service) * 1e3:.3f} ms")
        return {"e2e": {"serve_p95_ms": p95(lat) * 1e3},
                "attempted": len(plan), "failed": len(plan) - len(times),
                "trace": prof.trace,
                "facts": {"requests": len(times), "seconds": seconds,
                          "images": done,
                          "service_s": service, "latency_s": lat}}

    def release(self):
        self.serving.release()

    def check(self):
        return self.serving.check()
