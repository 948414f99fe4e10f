"""The port's span recorder (``shgan_torch/runtime/tracing.py``) on the CPU:
nothing recorded and one shared null context while no profiler records;
under a CPU ``torch.profiler`` each span on ``perf_counter_ns`` with its
parent, thread and attributes and as a ``record_function`` event; spans of
several threads; the buffer's bound; and the spans the engine, the compiled
forward, the train step and the pipelines open, with the composites the
same whether they record or not."""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from test_torch_models import _inputs, tiny_cfg
from test_torch_train_ops import tiny_d_cfg

from shgan_torch.data.datasets import get_dataset
from shgan_torch.data.formatters import get_formatter
from shgan_torch.data.pipeline import TrainPipeline
from shgan_torch.models import get_model
from shgan_torch.runtime import tracing
from shgan_torch.serve import InpaintEngine
from shgan_torch.train import TrainConfig, TrainStep


@pytest.fixture(autouse=True)
def fresh():
    """One intra-op thread (tiny launch-bound forwards) and an empty
    buffer before and after each test."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.clear()
    yield
    tracing.clear()
    torch.set_num_threads(prev)


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _event_names(prof):
    """The names of a finished profile's host events (read from its raw
    results: ``prof.events()`` builds an object an event, ~10 s for a
    train step's)."""
    return {e.name() for e in prof.profiler.kineto_results.events()}


def _named(name):
    return [r for r in tracing.spans() if r.name == name]


def test_no_profiler_records_nothing():
    assert not tracing.recording()
    seen = set()
    for i in range(10_000):
        with tracing.span("x", i=i) as s:
            s.set(more=i)
        seen.add(id(s))
    assert seen == {id(tracing.NULL)}
    assert tracing.span("y") is tracing.NULL
    assert tracing.spans() == []


def test_span_under_a_profiler():
    with _profiled() as prof:
        assert tracing.recording()
        t0 = time.perf_counter_ns()
        with tracing.span("outer", start=8) as a:
            with tracing.span("inner") as b:
                b.set(path="replay")
        t1 = time.perf_counter_ns()
    outer, inner = _named("outer")[0], _named("inner")[0]
    assert outer.parent is None and inner.parent == outer.id == a.id
    assert inner.id == b.id != outer.id
    assert outer.attrs == {"start": 8} and inner.attrs == {"path": "replay"}
    assert outer.thread == inner.thread == threading.get_ident()
    assert t0 <= outer.t0 <= inner.t0 <= inner.t1 <= outer.t1 <= t1
    assert {"outer", "inner"} <= _event_names(prof)
    assert {"outer", "inner"} <= {e.name for e in prof.events()}
    # the buffer hands out a copy; clear empties it
    tracing.spans().clear()
    assert len(tracing.spans()) == 2
    tracing.clear()
    assert tracing.spans() == []


def test_spans_of_four_threads_are_all_kept():
    """Four live threads record 500 nested pairs each (``thread_span``, as
    a pool's worker does) at a short switch interval: every record is
    kept, ids are unique and each inner span's parent is the outer span of
    its own thread."""
    n, prev = 500, sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    start, end = threading.Barrier(4, timeout=60), threading.Barrier(
        4, timeout=60)

    def work(k):
        start.wait()
        for i in range(n):
            with tracing.thread_span("outer", k=k, i=i):
                with tracing.thread_span("inner", k=k, i=i):
                    pass
        end.wait()   # no thread ends (and frees its id) before the rest
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    recs = tracing.spans()
    assert len(recs) == 8 * n and len({r.id for r in recs}) == 8 * n
    outer = {(r.attrs["k"], r.attrs["i"]): r for r in recs
             if r.name == "outer"}
    assert len({r.thread for r in outer.values()}) == 4
    for r in recs:
        if r.name == "inner":
            o = outer[(r.attrs["k"], r.attrs["i"])]
            assert r.parent == o.id and r.thread == o.thread
        else:
            assert r.parent is None


def test_the_buffer_keeps_the_newest_limit_records():
    for i in range(tracing.LIMIT + 10):
        with tracing.thread_span("s", i=i):
            pass
    recs = tracing.spans()
    assert len(recs) == tracing.LIMIT
    assert recs[0].attrs["i"] == 10
    assert recs[-1].attrs["i"] == tracing.LIMIT + 9


def _engine():
    e = InpaintEngine(tiny_cfg(), batch_size=2, seed=7, device="cpu")
    with torch.no_grad():
        for name, p in e.G.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.3)
    return e


def test_stream_spans_leave_out_the_consumer():
    """4 batches, 2 in flight: a serve.batch and a serve.readback for each
    batch, the batch's stages as its children, and no engine span over the
    time the caller spends between batches (its own generator's and its
    loop's)."""
    e = _engine()
    imgs, masks = _inputs(8, seed=5)
    caller = []

    def batches():
        for b in range(4):
            t = time.perf_counter_ns()
            time.sleep(0.01)
            caller.append((t, time.perf_counter_ns()))
            yield imgs[2 * b:2 * b + 2], masks[2 * b:2 * b + 2]

    with _profiled() as prof:
        for _ in e.inpaint_stream(batches(), start_index=100, window=2):
            t = time.perf_counter_ns()
            time.sleep(0.01)
            caller.append((t, time.perf_counter_ns()))
    batch, back = _named("serve.batch"), _named("serve.readback")
    assert len(batch) == len(back) == 4
    assert all(r.attrs == {"path": "eager"} for r in batch)
    assert all(set(r.attrs) == {"drained"}
               and isinstance(r.attrs["drained"], bool) for r in back)
    # with 2 in flight, batch k's readback follows batch k + 2's enqueue
    assert back[0].t0 > batch[2].t1 and back[1].t0 > batch[3].t1
    ids = {r.id for r in batch}
    for name in ("serve.prepare", "serve.z", "compiled.load"):
        kids = _named(name)
        assert len(kids) == 4 and {r.parent for r in kids} == ids, name
    assert not _named("compiled.replay")
    engine = batch + back
    for a, b in caller:
        assert not any(r.t0 < b and r.t1 > a for r in engine)
    assert {"serve.batch", "serve.readback", "serve.z"} <= _event_names(
        prof)


def test_composites_equal_with_tracing_on_and_off():
    e = _engine()
    imgs, masks = _inputs(5, seed=2)
    off = e.inpaint(imgs, masks, start_index=3)
    off_s = list(e.inpaint_stream([(imgs[:2], masks[:2]),
                                   (imgs[2:3], masks[2:3])]))
    with _profiled():
        on = e.inpaint(imgs, masks, start_index=3)
        on_s = list(e.inpaint_stream([(imgs[:2], masks[:2]),
                                      (imgs[2:3], masks[2:3])]))
    np.testing.assert_array_equal(on, off)
    for a, b in zip(on_s, off_s, strict=True):
        np.testing.assert_array_equal(a, b)
    # inpaint: 3 chunks (2, 2, 1 padded to 2); the stream: 2 batches
    assert len(_named("serve.batch")) == len(_named("serve.readback")) == 5
    assert len(_named("serve.prepare")) == 5


def test_stream_arrays_are_the_callers_own():
    """The arrays of a 4-batch stream, 2 in flight, keep their first value
    after every later batch has been read back (no buffer of the engine's
    is reused under the caller), and each equals ``inpaint`` of its batch
    at the same start; the last batch is ragged."""
    e = _engine()
    imgs, masks = _inputs(7, seed=6)
    cuts = [(0, 2), (2, 4), (4, 6), (6, 7)]
    got, first = [], []
    with _profiled():
        for out in e.inpaint_stream(
                ((imgs[a:b], masks[a:b]) for a, b in cuts), start_index=40,
                window=2):
            got.append(out)
            first.append(out.copy())
    back = _named("serve.readback")
    assert len(back) == 4 and all(r.attrs["drained"] is True for r in back)
    for out, was, (a, b) in zip(got, first, cuts, strict=True):
        np.testing.assert_array_equal(out, was)
        np.testing.assert_array_equal(
            out, e.inpaint(imgs[a:b], masks[a:b], start_index=40 + a))
    assert not any(np.shares_memory(x, y) for i, x in enumerate(got)
                   for y in got[i + 1:])


def test_inpaint_normalizes_each_chunk_once(monkeypatch):
    """``inpaint`` hands the raw NHWC rows to each chunk's ``serve.batch``,
    where the one normalization (inside ``serve.prepare``) runs; the
    result is the pre-normalized input's, and a count mismatch still
    raises."""
    import shgan_torch.serve as serve
    e = _engine()
    imgs, masks = _inputs(5, seed=4)
    want = e.inpaint(imgs, masks, start_index=1)
    nhwc = np.ascontiguousarray(imgs.transpose(0, 2, 3, 1))
    seen = []
    real = serve._as_model_input

    def counted(images, m):
        seen.append(len(images))
        return real(images, m)

    monkeypatch.setattr(serve, "_as_model_input", counted)
    with _profiled():
        got = e.inpaint(nhwc, masks[:, None], start_index=1)
    np.testing.assert_array_equal(got, want)
    assert seen == [2, 2, 1]
    prep = _named("serve.prepare")
    assert [r.parent for r in prep] == [r.id for r in _named("serve.batch")]
    with pytest.raises(ValueError, match="mismatch"):
        e.inpaint(imgs, masks[:4])
    assert e.inpaint(imgs[:0], masks[:0]).shape == (0,) + imgs.shape[1:]


class _FakeGraph:
    def replay(self):
        pass


def test_graph_paths_capture_then_replay(monkeypatch):
    """With the device parts of a capture stubbed, the first batch of a
    shape is ``capture`` (the capture, then its first replay), the next
    ones ``replay``; each batch's replay is a ``compiled.replay`` span
    inside its ``serve.batch``."""
    e = _engine()
    cf = e.compiled
    cf.captures = True
    monkeypatch.setattr(cf, "_warm_up", lambda st: None)
    monkeypatch.setattr(cf, "_record",
                        lambda st: (_FakeGraph(), cf._forward(st)))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: 0)
    imgs, masks = _inputs(6, seed=1)
    with _profiled():
        list(e.inpaint_stream(
            [(imgs[i:i + 2], masks[i:i + 2]) for i in (0, 2, 4)]))
    batch = _named("serve.batch")
    assert [r.attrs["path"] for r in batch] == ["capture", "replay",
                                                "replay"]
    assert [r.parent for r in _named("compiled.replay")] == [
        r.id for r in batch]


def test_train_step_span_and_its_phases():
    G, D = get_model(tiny_cfg(32), seed=0), get_model(tiny_d_cfg(32), seed=1)
    step = TrainStep(G, D, TrainConfig())
    g = torch.Generator().manual_seed(0)
    real = torch.rand(2, 3, 32, 32, generator=g) * 2 - 1
    mask = (torch.rand(2, 1, 32, 32, generator=g) > 0.5).float()
    with _profiled() as prof:
        step(real, mask, torch.Generator().manual_seed(1), 0.9, True, True)
    (st,) = _named("train.step")
    assert st.attrs == {}
    phases = [r for r in tracing.spans() if r.name in TrainStep.PHASES]
    assert sorted({r.name for r in phases}) == sorted(TrainStep.PHASES)
    assert all(r.parent == st.id for r in phases)
    assert set(TrainStep.PHASES) | {"train.step"} <= _event_names(prof)


def test_train_pipeline_spans(tmp_path):
    """Batches of 2 from 6 PNGs (3 an epoch) on 2 threads, 7 batches: each
    build a ``data.build`` span on a worker thread, each wait a
    ``data.wait`` span on the consumer with whether it was ready and its
    index in the epoch."""
    img_dir, mask_dir = tmp_path / "img", tmp_path / "mask"
    img_dir.mkdir()
    mask_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(6):
        Image.fromarray(rng.randint(0, 256, (16, 16, 3), np.uint8)).save(
            img_dir / f"{i:05d}.png")
        Image.fromarray(((rng.rand(16, 16) > 0.5) * 255).astype(np.uint8)
                        ).save(mask_dir / f"{i:05d}_mask.png")
    ds = get_dataset({"type": "imagedir", "root_dir": str(img_dir)})
    fmt = get_formatter({"type": "FixedMaskFormatter",
                         "args": {"mask_dir": str(mask_dir)}})
    pipe = TrainPipeline(ds, fmt, 2, device="cpu", seed=3, num_threads=2)
    it = iter(pipe)
    with _profiled():
        got = [next(it)]
        time.sleep(0.3)   # the rest of the epoch is built meanwhile
        got += [next(it) for _ in range(6)]
    it.close()
    want = iter(TrainPipeline(ds, fmt, 2, device="cpu", seed=3,
                              num_threads=0))
    for (r, m), (wr, wm) in zip(got, [next(want) for _ in range(7)]):
        assert torch.equal(r, wr) and torch.equal(m, wm)
    waits = _named("data.wait")
    assert [r.attrs["epoch_batch"] for r in waits] == [0, 1, 2] * 2 + [0]
    assert all(isinstance(r.attrs["ready"], bool) for r in waits)
    assert waits[1].attrs["ready"] and waits[2].attrs["ready"]
    main = threading.get_ident()
    assert {r.thread for r in waits} == {main}
    builds = _named("data.build")
    assert builds and all(r.thread != main for r in builds)
    assert len(builds) >= 7 and all(r.attrs == {} for r in builds)
