"""The readers of the program's spans (benchmark/spans.py and the six
`source: program_span` metrics) on synthetic records: the medians, the
calls recorded under the profiler left out, the first session (the
harness's warm-up) skipped, and None where nothing is recorded."""

import pytest

from benchmark.bench import Bench
from slam2d_tpu_torch.utils import profiling

K = 64
# (session, profiled, fresh, launch wait us, graph run us, device gap us
# before the call's first mark); the calls are numbered from 1
CALLS = [
    (1, False, True, 900, 3000, 0),
    (1, False, False, 900, 3000, 50),
    (2, False, True, 400, 2560, 1000),
    (2, False, False, 300, 2688, 200),
    (2, True, False, 5000, 9000, 3000),
    (2, False, False, 500, 2816, 4000),
    (2, False, False, 600, 2944, 100),
    (3, False, True, 350, 2560, 800),
    (3, False, False, 450, 2560, 300),
]
EXPECTED = {
    # graph runs / K over calls 3, 4, 6-9: 40, 42, 44, 46, 40, 40
    "replay_device_us_per_scan": 41.0,
    "replay_launch_wait_us": 425.0,
    # calls (3, 4), (6, 7), (8, 9): 200, 100, 300
    "handoff_idle_us": 200.0,
    # (hand-offs 200 + 100 + 800 + 300 and waits 2600) over the device
    # spans of calls 3-4 (6172 us) and 6-9 (14028 us)
    "program_idle_share": 100.0 * 4000.0 / 20200.0,
    # 100 us + 1 us a call number
    "stage_host_us": 106.5,
    # 300 us + 10 us a call number: calls 3 and 8
    "session_init_us": 355.0,
}


def _records(calls=CALLS):
    recs, ids, t = [], iter(range(1, 1000)), 0.0
    for n, (session, prof, fresh, wait, run, gap) in enumerate(calls, 1):
        start = n * 10**7
        init = 300_000 + 10_000 * n if fresh else 0

        def rec(name, parent, t0, t1, marks=None, **ids_):
            r = {"id": next(ids), "name": name, "parent": parent,
                 "session": session, "call": n, "profiled": prof,
                 "start_ns": t0, "end_ns": t1, "marks": marks or {}}
            r.update(ids_)
            recs.append(r)
            return r["id"]

        root = rec("call", None, start, start + 5 * 10**6)
        if fresh:
            rec("session.init", root, start + 1000, start + 1000 + init)
        head_ns = start + init + 100_000 + 1000 * n
        t += gap
        load, copied = t, t + 5
        head, done = copied + wait, copied + wait + run
        t = done + 7
        rec("call.stage", root, start + init + 2000, start + init + 9000)
        rec("chunk.load", root, head_ns - 900, head_ns - 800,
            {"load": [head_ns - 850, load]})
        rec("chunk.replay", root, head_ns - 700, head_ns + 500,
            {"copied": [head_ns - 10, copied], "head": [head_ns, head],
             "replayed": [head_ns + 400, done]}, scans=K)
        rec("chunk.finish", root, head_ns + 600, head_ns + 900,
            {"cloned": [head_ns + 800, t]})
    return recs


@pytest.fixture
def bench():
    return Bench()


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader(bench, monkeypatch, metric):
    monkeypatch.setattr(profiling, "records", _records)
    assert bench.reader(metric)(None) == pytest.approx(EXPECTED[metric])


def _unmarked():
    recs = _records()
    for r in recs:
        r["marks"] = {}
    return recs


@pytest.mark.parametrize("metric", sorted(EXPECTED))
@pytest.mark.parametrize("case", [
    "empty", "no recorder", "first session only", "all profiled",
    "no marks (the CPU)"])
def test_reader_finds_nothing(bench, monkeypatch, metric, case):
    if case == "no recorder":
        monkeypatch.delattr(profiling, "records")
    else:
        recs = {
            "empty": lambda: [],
            "first session only": lambda: _records(CALLS[:2]),
            "all profiled": lambda: _records(
                [c[:1] + (True,) + c[2:] for c in CALLS]),
            "no marks (the CPU)": _unmarked,
        }[case]
        monkeypatch.setattr(profiling, "records", recs)
    assert bench.reader(metric)(None) is None


def test_call_with_a_lost_mark_left_out(bench, monkeypatch):
    def recs():
        out = _records()
        last = [r for r in out if r["call"] == len(CALLS)]
        next(r for r in last if r["name"] == "chunk.replay")["marks"][
            "head"][1] = None
        return out

    monkeypatch.setattr(profiling, "records", recs)
    # calls 3, 4, 6, 7, 8: waits 400, 300, 500, 600, 350
    assert bench.reader("replay_launch_wait_us")(None) == 400.0
    # calls (3, 4), (6, 7): 200, 100
    assert bench.reader("handoff_idle_us")(None) == 150.0


def test_spans_read_in_every_cell(bench):
    for metric in EXPECTED:
        m = next(m for m in bench.spec["per_layer"] if m["name"] == metric)
        assert m["source"] == "program_span"
        assert m["moves"] == "scans_per_s"
        assert m["workloads"] == [w["name"] for w in bench.spec["workloads"]]
