"""The port's metrics export surface against the JAX package's.

Counterparts of ``tests/test_observability.py:155-320`` and
``tests/test_obs_plane.py::test_snapshot_deltas_is_the_exporter_semantics``
for ``multiverso_tpu_torch/dashboard.py``: ``snapshot_deltas``,
``render_prometheus`` (text identical to JAX's for the same snapshot),
``parse_prometheus``, ``MetricsExporter`` (JSON lines, interval deltas,
snapshot-order commits, the reset hook), ``Timer`` and
``monitored_block_until_ready``, and the session's ``-metrics_jsonl``.
Every comparison is exact: the renderers are text, the deltas plain
arithmetic on the same numbers.
"""

import io
import json
import re
import threading
import time

import numpy as np
import pytest

from multiverso_tpu import dashboard as jdash
from multiverso_tpu_torch import dashboard as tdash
from multiverso_tpu_torch.dashboard import (Dashboard, MetricsExporter,
                                            parse_prometheus,
                                            render_prometheus,
                                            snapshot_deltas)


@pytest.fixture(autouse=True)
def _clean():
    Dashboard.reset()
    jdash.Dashboard.reset()
    yield
    Dashboard.reset()
    jdash.Dashboard.reset()


def _wait(pred, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.005)


def _populate(mod=tdash):
    """The JAX tests' instrument set, on ``mod``'s dashboard."""
    d = mod.Dashboard
    h = d.get_or_create_histogram("SERVE_TTFT[lm]")
    for v in (1.5, 2.5, 300.0):
        h.record(v)
    d.get_or_create_gauge("DECODE_TPS[lm]").set(123.5)
    d.get_or_create_counter("SERVE_SHED[lm]").inc(7)
    m = d.get_or_create("TABLE_ADD[t]")
    m.record(4.25)
    m.record(1.75)


def _seeded_snapshot(seed):
    """A snapshot with every row kind, names that need escaping, and
    float values from a seeded generator."""
    rng = np.random.default_rng(seed)
    snap = {}
    for i in range(4):
        snap[f"C{i}[lm.t{i}]"] = {"type": "counter",
                                  "value": int(rng.integers(0, 1 << 40))}
        snap[f"G{i}"] = {"type": "gauge", "value": float(rng.normal())}
        snap[f"M{i}[x\"y\\\\z\n]"] = {
            "type": "monitor", "count": int(rng.integers(0, 99)),
            "total_ms": float(rng.random() * 1e3),
            "avg_ms": float(rng.random())}
        snap[f"H-{i}.lat[e{i}]"] = {
            "type": "histogram", "count": int(rng.integers(1, 9)),
            **{k: float(rng.lognormal()) for k in
               ("p50_ms", "p95_ms", "p99_ms", "mean_ms", "max_ms")}}
    snap["SLO_P99[H-0.lat[e0]]"] = {
        "type": "slo", "target_ms": 5.0, "percentile": 99.0, "window": 3,
        "value_ms": 1.25, "breach_frac": 0.0, "burn": 0.0, "ok": 1}
    snap["ROW[w]"] = {"type": "gauge", "value": 1.0, "note": "text",
                      "flag": True}
    return snap


# -- render / parse ------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("labels", [None, {"node": "3"},
                                    {"node": "1", "zone": 'a"b'}])
def test_render_prometheus_text_equals_jax(seed, labels):
    snap = _seeded_snapshot(seed)
    text = render_prometheus(snap, labels=labels)
    assert text == jdash.render_prometheus(snap, labels=labels)
    assert parse_prometheus(text) == jdash.parse_prometheus(text)


def test_render_of_the_live_dashboards_equals_jax():
    """The same instruments on both registries render the same text."""
    _populate(tdash)
    _populate(jdash)
    tsnap, jsnap = Dashboard.snapshot(), jdash.Dashboard.snapshot()
    assert tsnap == jsnap
    assert render_prometheus() == jdash.render_prometheus()
    assert render_prometheus({}) == "" == jdash.render_prometheus({})


def test_parse_prometheus_round_trips_every_value():
    snap = _seeded_snapshot(5)
    parsed = parse_prometheus(render_prometheus(snap))
    for name, row in snap.items():
        base = re.sub(r"[^a-zA-Z0-9_]", "_",
                      name.partition("[")[0].lower()).strip("_")
        want = {(f"mv_{base}" if f == "value" else f"mv_{base}_{f}"):
                float(v) for f, v in row.items()
                if f != "type" and isinstance(v, (int, float))
                and not isinstance(v, bool)}
        assert parsed[name] == want, name


# -- deltas ----------------------------------------------------------------------

def test_snapshot_deltas_is_the_exporter_semantics():
    prev = {"C[x]": {"type": "counter", "value": 10},
            "H[x]": {"type": "histogram", "count": 4, "p50_ms": 1.0},
            "G[x]": {"type": "gauge", "value": 5.0}}
    snap = {"C[x]": {"type": "counter", "value": 25},
            "H[x]": {"type": "histogram", "count": 2, "p50_ms": 2.0},
            "G[x]": {"type": "gauge", "value": 9.0},
            "NEW[x]": {"type": "counter", "value": 3}}
    helper = snapshot_deltas(prev, snap, 2.0)
    assert helper == jdash.snapshot_deltas(prev, snap, 2.0)
    exporter = MetricsExporter(interval_s=60)
    exporter._last = prev
    assert exporter._deltas(snap, 2.0) == helper
    assert helper["C[x]"] == {"value": 15, "value_per_s": 7.5}
    assert "H[x]" not in helper and "G[x]" not in helper
    assert "NEW[x]" not in helper
    assert snapshot_deltas(None, snap, 2.0) == {}
    assert snapshot_deltas(prev, snap, 0.0) == {}


@pytest.mark.parametrize("seed", [0, 1])
def test_snapshot_deltas_equal_jax_on_seeded_snapshots(seed):
    a, b = _seeded_snapshot(seed), _seeded_snapshot(seed + 10)
    for dt in (None, 0.5, 3.0):
        assert snapshot_deltas(a, b, dt) == jdash.snapshot_deltas(a, b, dt)
        assert snapshot_deltas(b, a, dt) == jdash.snapshot_deltas(b, a, dt)


# -- the exporter ----------------------------------------------------------------

def test_snapshot_roundtrips_jsonl_and_prometheus():
    _populate()
    sink = io.StringIO()
    exporter = MetricsExporter(interval_s=60.0, sink=sink)
    record = exporter.report_once()
    snap = record["snapshot"]
    line = sink.getvalue().strip().splitlines()[0]
    assert json.loads(line)["snapshot"] == snap
    text = exporter.prometheus()
    assert text == render_prometheus(snap) == jdash.render_prometheus(snap)
    assert parse_prometheus(text)["SERVE_SHED[lm]"] == {
        "mv_serve_shed": 7.0}


def test_exporter_interval_deltas():
    _populate()
    exporter = MetricsExporter(interval_s=60.0)
    exporter.report_once()
    Dashboard.get_or_create_counter("SERVE_SHED[lm]").inc(5)
    Dashboard.get_or_create_histogram("SERVE_TTFT[lm]").record(9.0)
    time.sleep(0.02)
    rec = exporter.report_once()
    assert rec["interval_s"] > 0
    d = rec["deltas"]
    assert d["SERVE_SHED[lm]"]["value"] == 5
    assert d["SERVE_SHED[lm]"]["value_per_s"] > 0
    assert d["SERVE_TTFT[lm]"]["count"] == 1
    assert "DECODE_TPS[lm]" not in d
    Dashboard.get_or_create_histogram("SERVE_TTFT[lm]").reset()
    rec = exporter.report_once()
    assert "SERVE_TTFT[lm]" not in rec["deltas"]


def test_exporter_thread_writes_lines(tmp_path):
    _populate()
    path = str(tmp_path / "metrics.jsonl")
    exporter = MetricsExporter(interval_s=0.05, sink=path).start()
    _wait(lambda: exporter.reports >= 2)
    exporter.stop(final_report=True)
    lines = open(path).read().strip().splitlines()
    assert len(lines) >= 3
    for line in lines:
        assert "SERVE_TTFT[lm]" in json.loads(line)["snapshot"]


def test_exporter_reports_commit_in_snapshot_order(monkeypatch):
    _populate()
    exporter = MetricsExporter(interval_s=60.0)
    exporter.report_once()
    real_time = time.time
    monkeypatch.setattr(time, "time", lambda: real_time() - 30.0)
    rec = exporter.report_once()
    monkeypatch.undo()
    assert rec["interval_s"] >= 0
    entered, release = threading.Event(), threading.Event()
    real_snapshot = Dashboard.snapshot

    def slow_snapshot():
        snap = real_snapshot()
        entered.set()
        release.wait(10)
        return snap

    monkeypatch.setattr(Dashboard, "snapshot", staticmethod(slow_snapshot))
    t = threading.Thread(target=exporter.report_once)
    t.start()
    second_done = threading.Event()
    t2 = threading.Thread(
        target=lambda: (exporter.report_once(), second_done.set()))
    try:
        assert entered.wait(5)
        t2.start()
        assert not second_done.wait(0.3)
        exporter.prometheus()           # a scrape stays unblocked
        release.set()
        assert second_done.wait(5)
    finally:
        release.set()
        t.join(10)
        t2.join(10)
    assert exporter.reports == 4


def test_dashboard_reset_detaches_running_exporter(tmp_path):
    exporter = MetricsExporter(interval_s=0.05,
                               sink=str(tmp_path / "m.jsonl")).start()
    _wait(lambda: exporter.reports >= 1)
    thread = exporter._thread
    assert thread is not None and thread.is_alive()
    Dashboard.reset()
    assert exporter._thread is None and not thread.is_alive()
    assert Dashboard._reporters == []
    exporter.stop()                               # idempotent


def test_timer_and_monitored_wait():
    import torch

    t = tdash.Timer()
    time.sleep(0.01)
    assert t.elapse_ms() >= 10.0
    t.start()
    assert t.elapse_ms() < 10.0
    value = {"a": torch.ones(3), "b": [torch.zeros(2), 4]}
    assert tdash.monitored_block_until_ready("WAIT[x]", value) is value
    assert Dashboard.stats("WAIT[x]")["count"] == 1


# -- the session flag ------------------------------------------------------------

def test_session_metrics_jsonl_starts_and_finalizes_the_exporter(tmp_path):
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.runtime import Session

    path = str(tmp_path / "m.jsonl")
    Session._instance = None
    try:
        mv.init(["t", "-device=cpu", f"-metrics_jsonl={path}",
                 "-metrics_interval_s=0.05"])
        sess = Session.get()
        exporter = sess.metrics_exporter
        assert exporter is not None and exporter._thread.is_alive()
        Dashboard.get_or_create_counter("SESS[x]").inc(4)
        _wait(lambda: exporter.reports >= 2)
        Dashboard.get_or_create_counter("SESS[x]").inc(1)
        mv.shutdown()
        assert sess.metrics_exporter is None and exporter._thread is None
        lines = [json.loads(x) for x in open(path).read().splitlines()]
        assert len(lines) == exporter.reports
        assert lines[-1]["snapshot"]["SESS[x]"]["value"] == 5
    finally:
        mv.shutdown()
        mv.set_flag("metrics_jsonl", "")
        mv.set_flag("metrics_interval_s", 10.0)
        mv.set_flag("device", "cuda")
        Session._instance = None
