"""idle_under_engine.stream: the share of the device's idle time in the
traced window (the complement of the profiler's device activity) that
falls while the host enqueues a batch in the engine (the port's
``serve.batch`` spans).

The spans move onto the profiler's clock by the window's end: the stream
driver's window closes as the engine's last readback (the drain's) returns,
so the last ``serve.readback`` span ends microseconds before
``bench.window`` does.  Its start is no anchor: ``bench.window`` is the
first ``record_function`` of the process, whose opening stamp can lie a
millisecond or more before ``cell.start_window()`` reads the clock."""

from harness import spans


def read(run):
    t = run.trace
    batches = spans.in_window(run, "serve.batch")
    backs = spans.since_window(run, "serve.readback")
    if t is None or not batches or not backs:
        return None
    # profiler microseconds = perf_counter nanoseconds / 1e3 + shift
    shift = t.window[1] - max(r.t1 for r in backs) / 1e3
    lo, hi = (v / 1e3 + shift for v in spans.window_ns(run))
    idle = (hi - lo) - t.busy_in(lo, hi)
    if idle <= 0:
        return None
    under = sum((r.t1 - r.t0) / 1e3 - t.busy_in(r.t0 / 1e3 + shift,
                                                 r.t1 / 1e3 + shift)
                for r in batches)
    return 100.0 * under / idle
