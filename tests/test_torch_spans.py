"""PyTorch port: the span recorder (utils/profiling.py) in the drivers, on
the CPU.

- Two calls of `run_frontend` and of `run_fastslam` record `call`,
  `session.init`, `call.stage` and `chunk.eager` with their parents,
  session ids and call numbers (a fresh state opens a session, `state=`
  continues it); the CPU paths record no device mark.
- The recorder changes neither the outputs nor `host_syncs`.
- The ring stays bounded.
- Under a CPU torch.profiler the spans appear among the host events;
  with the profiler off no profiler range is opened.
- Marks resolve lazily, in stream order, asking `query()` first: a
  pending event stays pending, nothing synchronizes, a graph's event
  marked again before it completed loses its earlier mark, and resolved
  events return to the pool.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from slam2d_tpu_torch.config import (
    FrontendConfig,
    GridConfig,
    MatcherConfig,
    PFConfig,
    SensorConfig,
)
from slam2d_tpu_torch.data.synth import SynthWorld, simulate_log
from slam2d_tpu_torch.pf.fastslam import fastslam_step
from slam2d_tpu_torch.run.capture import ChunkCapture
from slam2d_tpu_torch.run.fastslam_run import run_fastslam
from slam2d_tpu_torch.run.frontend import frontend_step, run_frontend
from slam2d_tpu_torch.utils import profiling

torch.set_num_threads(1)
CPU = torch.device("cpu")
SENSOR = SensorConfig(n_beams=61, max_range=6.0)
CFG = FrontendConfig(
    sensor=SENSOR,
    grid=GridConfig(height=128, width=128, resolution=0.1, ray_samples=64,
                    center_x=5.0, center_y=5.0),
    matcher=MatcherConfig(search_xy=0.2, search_theta=0.1, n_theta=5),
    chunk=8, bootstrap_dist=1.0,
)
PF = PFConfig(n_particles=4, refine_shared_min_particles=2)


@pytest.fixture(scope="module")
def log():
    world = SynthWorld.box_rooms(10.0)
    wp = np.array([[3.0, 3.0], [3.0, 7.0], [7.0, 7.0]])
    out = simulate_log(world, wp, SENSOR, step=0.15, odom_noise_xy=0.01,
                       odom_noise_theta=0.004, seed=3)
    return {k: np.asarray(out[k])[:24] for k in ("odom", "ranges")}


@pytest.fixture
def ring(monkeypatch):
    """An empty ring and no device clocks for the test."""
    monkeypatch.setattr(profiling, "_clocks", {})
    monkeypatch.setattr(profiling, "_last", (None, None))
    profiling.clear()
    yield
    profiling.clear()


def _part(log, a, b):
    return {k: v[a:b] for k, v in log.items()}


def _draws(T, P=PF.n_particles):
    g = torch.Generator().manual_seed(5)
    return torch.randn((T, P, 3), generator=g), torch.rand(T, generator=g)


def _frontend_calls(log):
    st, tr1, sc1 = run_frontend(_part(log, 0, 16), CFG, CPU)
    st, tr2, sc2 = run_frontend(_part(log, 16, 24), CFG, CPU, state=st)
    return np.concatenate([tr1, tr2]), np.concatenate([sc1, sc2])


def _fastslam_calls(log):
    noise, u = _draws(24)
    st, tr1, ne1, sc1 = run_fastslam(_part(log, 0, 16), CFG, PF, CPU,
                                     draws=(noise[:16], u[:16]),
                                     host_gated=False)
    st, tr2, ne2, sc2 = run_fastslam(_part(log, 16, 24), CFG, PF, CPU,
                                     state=st, draws=(noise[16:], u[16:]),
                                     host_gated=False)
    return (np.concatenate([tr1, tr2]), np.concatenate([ne1, ne2]),
            np.concatenate([sc1, sc2]))


def _tree(recs):
    """{call number: [(name, parent's name, session)]} of the records."""
    by_id = {r["id"]: r for r in recs}
    out = {}
    for r in recs:
        parent = by_id[r["parent"]]["name"] if r["parent"] else None
        out.setdefault(r["call"], []).append((r["name"], parent,
                                              r["session"]))
    return out


@pytest.mark.parametrize("entry", ["frontend", "fastslam"])
def test_driver_spans(log, ring, entry):
    (_frontend_calls if entry == "frontend" else _fastslam_calls)(log)
    recs = profiling.records()
    calls = sorted({r["call"] for r in recs})
    assert len(calls) == 2 and calls[1] == calls[0] + 1
    tree = _tree(recs)
    s = tree[calls[0]][0][2]
    eager = [("chunk.eager", "call", s)]
    assert tree[calls[0]] == [("call", None, s), ("session.init", "call", s),
                              ("call.stage", "call", s)] + eager * 2
    assert tree[calls[1]] == [("call", None, s), ("call.stage", "call", s)] \
        + eager
    for r in recs:
        assert r["marks"] == {} and not r["profiled"]
        assert r["start_ns"] <= r["end_ns"]
        if r["name"] == "chunk.eager":
            assert r["scans"] == 8
    # a fresh state opens the next session
    run_frontend(_part(log, 0, 8), CFG, CPU)
    last = profiling.records()[-4:]
    assert [r["name"] for r in last] == ["call", "session.init", "call.stage",
                                         "chunk.eager"]
    assert {r["session"] for r in last} == {s + 1}
    assert {r["call"] for r in last} == {calls[1] + 1}


@pytest.mark.parametrize("entry", ["frontend", "fastslam"])
def test_recorder_changes_nothing(log, ring, monkeypatch, entry):
    run, step = ((_frontend_calls, frontend_step) if entry == "frontend"
                 else (_fastslam_calls, fastslam_step))
    syncs = step.host_syncs
    got = run(log)
    assert step.host_syncs == syncs
    assert profiling.records()

    @contextlib.contextmanager
    def nothing(*a, **k):
        yield {"marks": {}}

    monkeypatch.setattr(profiling, "span", nothing)
    monkeypatch.setattr(profiling, "call", nothing)
    profiling.clear()
    want = run(log)
    assert not profiling.records()
    assert step.host_syncs == syncs
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_ring_bounded(ring):
    for _ in range(profiling.RING + 10):
        with profiling.span("x"):
            pass
    recs = profiling.records()
    assert len(recs) == profiling.RING
    assert recs[-1]["id"] - recs[0]["id"] == profiling.RING - 1


def test_spans_under_the_profiler(log, ring):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run_frontend(_part(log, 0, 8), CFG, CPU)
    names = {e.name for e in prof.events()}
    assert {"call", "session.init", "call.stage", "chunk.eager"} <= names
    assert all(r["profiled"] for r in profiling.records())


def test_no_profiler_range_off_the_profiler(log, ring, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range opened off the profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    run_frontend(_part(log, 0, 8), CFG, CPU)
    assert not any(r["profiled"] for r in profiling.records())


def _fake_card(monkeypatch, pool=4):
    """Fake events (the device "fake"), from a pool of `pool`."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(profiling, "_EVENT", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda i=None: None)
    monkeypatch.setattr(profiling, "_last", (None, None))
    monkeypatch.setattr(profiling, "POOL", pool)


class FakeEvent:
    """A timing event of a fake device clock: `at` is its time in ms once
    `done`; elapsed_time refuses a pending event, as CUDA does."""

    def __init__(self, **_):
        self.done, self.at = False, None

    def record(self, stream=None):
        self.done, self.at = False, None

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done
        return end.at - self.at

    def finish(self, at):
        self.done, self.at = True, at


def test_lazy_resolution(ring, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the recorder synchronized")

    _fake_card(monkeypatch)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    dev, head = "fake", FakeEvent()
    with profiling.span("a") as a:
        profiling.mark("copied", dev)
        profiling.mark("head", dev, head)
        profiling.mark("replayed", dev)
    clock = profiling._clocks[dev]
    copied, replayed = (ev for _, ev in clock.pending)
    profiling.records()
    assert all(m[1] is None for m in a["marks"].values())
    # done out of stream order: waits for the earlier mark
    replayed.finish(12.5)
    profiling.records()
    assert a["marks"]["replayed"][1] is None
    copied.finish(10.0)
    profiling.records()
    assert a["marks"]["copied"][1] == 0.0
    assert a["marks"]["replayed"][1] == pytest.approx(2500.0)
    assert a["marks"]["head"][1] is None
    head.finish(10.25)
    profiling.records()
    assert a["marks"]["head"][1] == pytest.approx(250.0)
    # a graph's event marked again before it completed loses its first
    # mark; the next one resolves from the mark before it
    with profiling.span("b") as b:
        profiling.mark("copied", dev)
        profiling.mark("head", dev, head)
    head.record()
    with profiling.span("c") as c:
        profiling.mark("copied", dev)
        profiling.mark("head", dev, head)
    (_, b_copied), (_, c_copied) = clock.pending
    b_copied.finish(20.0)
    c_copied.finish(21.0)
    head.finish(21.5)
    profiling.records()
    assert b["marks"]["copied"][1] == pytest.approx(10000.0)
    assert b["marks"]["head"][1] is None
    assert c["marks"]["copied"][1] == pytest.approx(11000.0)
    assert c["marks"]["head"][1] == pytest.approx(11500.0)
    # resolved events go back to the pool
    assert b_copied in clock.free
    with profiling.span("d"):
        profiling.mark("x", dev)
    assert clock.pending[-1][1] is b_copied


class FakeGraph(ChunkCapture):
    """A chunk graph with no capture: `graph.replay` records the head
    event, as the captured body's first node does."""

    def __init__(self):
        self.device, self.K = "fake", 2
        self.state, self.inputs = (torch.zeros(3),), (torch.zeros(2),)
        self.out = torch.zeros(2)
        self.counts = torch.zeros(2)
        self.step = types.SimpleNamespace(counter=lambda d: torch.zeros(2))
        self.head = FakeEvent()
        self.graph = types.SimpleNamespace(replay=self.head.record)
        self.launches, self.replays = [], 0


def test_chunk_graph_marks(ring, monkeypatch):
    """The graph path's spans and marks in a call, each resolved in device
    order (the fake device runs every event 1 ms after the last)."""
    _fake_card(monkeypatch, pool=16)
    g, t = FakeGraph(), [0.0]

    def run_device():
        """Every recorded event done, in stream order: the head right
        after the pooled mark recorded before it."""
        clock = profiling._clocks["fake"]
        order = [ev for _, ev in clock.pending]
        if g.head in clock.graphs:
            order.insert(order.index(clock.graphs[g.head][1][1]) + 1, g.head)
        for ev in order:
            if not ev.done:
                t[0] += 1.0
                ev.finish(t[0])

    for fresh in (True, False):
        with profiling.call(fresh):
            with profiling.span("call.stage"):
                pass
            g.load((torch.ones(3),))
            g.run_chunk(torch.ones(2), torch.zeros(2))
            run_device()
            g.finish()
        run_device()
    recs = profiling.records()
    assert [r["name"] for r in recs] == [
        "call", "call.stage", "chunk.load", "chunk.replay", "chunk.finish"] * 2
    assert recs[3]["scans"] == 2 and g.replays == 2
    marks = [(k, m[1]) for r in recs for k, m in r["marks"].items()]
    assert [k for k, _ in marks] == ["load", "copied", "head", "replayed",
                                     "cloned"] * 2
    # 1 ms apart from the first, in stream order
    assert [v for _, v in marks] == pytest.approx(
        [1000.0 * i for i in range(10)])


def test_pool_reclaims_the_oldest_mark(ring, monkeypatch):
    """With no event free, the oldest waiting mark gives its event up."""
    _fake_card(monkeypatch, pool=2)
    with profiling.span("a") as a:
        for name in ("x", "y", "z"):
            profiling.mark(name, "fake")
    clock = profiling._clocks["fake"]
    assert len(clock.pending) == 2
    for i, (_, ev) in enumerate(clock.pending):
        ev.finish(1.0 + i)
    profiling.records()
    assert [a["marks"][k][1] for k in "xyz"] == [None, 0.0, 1000.0]


def test_marks_outside_a_span_do_nothing(ring):
    profiling.mark("x", "fake")
    assert profiling._clocks == {}
