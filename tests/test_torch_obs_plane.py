"""The port's fleet observability plane against the JAX package's.

Port counterparts of ``tests/test_obs_plane.py``'s agent, collector and
wire tests (:151-666), run on ``multiverso_tpu_torch.serving.obs_plane``,
plus:

* interop both ways over the real ``mvobs`` TCP wire and an in-process
  coordination KV: a port agent's reports ingested by a JAX collector,
  and a JAX agent's by a port collector. The port and JAX dashboards are
  separate registries, so each side reports its own; seeded with the
  same instrument values, the mixed pair's ``fleet()`` rows equal an
  all-JAX pair's exactly (histogram percentiles are bucket midpoints, so
  equal buckets give equal numbers);
* the session's start and stop order under ``-obs_plane``: the final
  report ships before the servers stop, with the engines' terminal
  stats although the server registry is already empty.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import pytest

from multiverso_tpu_torch import trace
from multiverso_tpu_torch.dashboard import (BUCKET_REL_ERROR, Dashboard,
                                            Histogram, parse_prometheus)
from multiverso_tpu_torch.serving.obs_plane import ObsAgent, ObsCollector
from multiverso_tpu_torch.trace import validate_chrome_events


def _nearest_rank(sorted_data, p):
    n = len(sorted_data)
    return sorted_data[min(n - 1, max(0, int(round(p / 100.0 * (n - 1)))))]


@pytest.fixture(autouse=True)
def _clean_dashboard():
    from multiverso_tpu.dashboard import Dashboard as JDash

    Dashboard.reset()
    JDash.reset()
    yield
    Dashboard.reset()
    JDash.reset()


# -- agent reports (loopback) -------------------------------------------------

def test_agent_ships_changed_rows_deltas_and_buckets():
    c = Dashboard.get_or_create_counter("OBS_T_C[x]")
    c.inc(5)
    h = Dashboard.get_or_create_histogram("OBS_T_H[x]")
    h.record(10.0)
    agent = ObsAgent(report_ms=50, engines=lambda: {}, start=False)
    try:
        rep = agent.tick()
        assert rep["v"] == 1 and rep["seq"] == 0
        assert "OBS_T_C[x]" in rep["rows"] and "OBS_T_H[x]" in rep["rows"]
        assert "OBS_T_H[x]" in rep["buckets"]
        assert rep["deltas"] == {}
        time.sleep(0.02)
        c.inc(3)
        rep2 = agent.tick()
        assert rep2["seq"] == 1
        assert "OBS_T_C[x]" in rep2["rows"]
        assert "OBS_T_H[x]" not in rep2["rows"]
        assert "OBS_T_H[x]" not in rep2["buckets"]
        assert rep2["deltas"]["OBS_T_C[x]"]["value"] == 3
        assert agent.collector.fleet()["counters"]["OBS_T_C[x]"] == 8
    finally:
        agent.stop(final_report=False)


def test_agent_drains_spans_incrementally():
    trace.enable(256)
    try:
        agent = ObsAgent(report_ms=50, engines=lambda: {}, start=False)
        with trace.span("serve.request", root=True, model="m"):
            pass
        rep = agent.tick()
        assert len(rep["spans"]) == 1
        assert rep["spans"][0]["name"] == "serve.request"
        assert rep["spans_missed"] == 0
        assert agent.tick()["spans"] == []
        agent.stop(final_report=False)
    finally:
        trace.disable()
        trace.collector().clear()


class _FakeEngine:
    name = "fe"
    watchdog = None
    recorder = None

    def __init__(self, completed=3, stopped=False):
        self._completed = completed
        self._stopped = stopped

    def stats(self):
        return {"tokens_per_s": 12.5, "live_seqs": 1,
                "completed": self._completed, "shed": 0,
                "watchdog_trips": self.watchdog.trip_count
                if self.watchdog else 0}

    def health(self):
        return {"live_seqs": 1, "stopped": self._stopped}

    def pool_drift(self):
        return None


def test_agent_forwards_watchdog_trips_exactly_once():
    from multiverso_tpu_torch.serving.watchdog import (EngineWatchdog,
                                                       WatchdogConfig)

    eng = _FakeEngine()
    eng.watchdog = EngineWatchdog(eng, WatchdogConfig(), start=False)
    agent = ObsAgent(report_ms=50, engines=lambda: {"fe": eng},
                     start=False)
    try:
        eng.watchdog._trip("stall", "r1")
        eng.watchdog._trip("queue_age", "r2")
        rep = agent.tick()
        wd = rep["engines"]["fe"]["watchdog"]
        assert wd["trips_total"] == 2
        assert [t[0] for t in wd["new_trips"]] == ["stall", "queue_age"]
        assert agent.tick()["engines"]["fe"]["watchdog"]["new_trips"] == []
        eng.watchdog._trip("stall", "r3")
        rep3 = agent.tick()
        assert [t[0] for t in
                rep3["engines"]["fe"]["watchdog"]["new_trips"]] == ["stall"]
        st = agent.collector.node_state(0)
        assert [t[1] for t in st["trips"]] == ["stall", "queue_age",
                                               "stall"]
        assert rep["engines"]["fe"]["stats"]["tokens_per_s"] == 12.5
        assert rep["engines"]["fe"]["health"]["live_seqs"] == 1
    finally:
        agent.stop(final_report=False)


def test_agent_final_report_keeps_engines_after_discovery_goes_dark():
    from multiverso_tpu_torch.serving.watchdog import (EngineWatchdog,
                                                       WatchdogConfig)

    eng = _FakeEngine(completed=7, stopped=True)
    eng.watchdog = EngineWatchdog(eng, WatchdogConfig(), start=False)
    engines = {"fe": eng}
    agent = ObsAgent(report_ms=50, engines=lambda: dict(engines),
                     start=False)
    try:
        agent.tick()
        engines.clear()
        eng.watchdog._trip("stall", "terminal")
        rep = agent.tick()
        assert "fe" in rep["engines"]
        assert rep["engines"]["fe"]["health"]["stopped"] is True
        assert [t[0] for t in
                rep["engines"]["fe"]["watchdog"]["new_trips"]] == ["stall"]
    finally:
        agent.stop(final_report=False)


# -- collector aggregation ----------------------------------------------------

def _report(node, seq, rows=None, buckets=None, spans=None, anchor=None,
            engines=None, ts=None):
    return {"v": 1, "node": node, "seq": seq, "ts": ts or float(seq),
            "mono": float(seq), "interval_s": 1.0, "rows": rows or {},
            "deltas": {}, "buckets": buckets or {},
            "engines": engines or {}, "spans": spans or [],
            "spans_missed": 0, "trace_anchor": anchor or [0.0, 0.0]}


def _three_node_reports(seed):
    """Three nodes' reports with seeded latency samples, built once with
    the port's histograms and once with JAX's (the exports must agree)."""
    from multiverso_tpu.dashboard import Histogram as JHist

    rng = np.random.default_rng(seed)
    reps, jreps, pooled = [], [], []
    for node in range(3):
        samples = rng.lognormal(1.0, 1.0, 500)
        pooled.extend(samples)
        h = Histogram(f"CS{node}", register=False)
        jh = JHist(f"CS{node}", register=False)
        for v in samples:
            h.record(float(v))
            jh.record(float(v))
        rows = {
            "REQS[x]": {"type": "counter", "value": 100 + node},
            "LAT[x]": {"type": "histogram", "count": 500, "p50_ms": 0.0,
                       "p95_ms": 0.0, "p99_ms": 0.0, "mean_ms": 0.0,
                       "max_ms": 0.0},
            "SLO_P99[LAT[x]]": {"type": "slo", "target_ms": 5.0,
                                "percentile": 99.0, "window": 500,
                                "value_ms": 0.0, "breach_frac": 0.0,
                                "burn": 0.0, "ok": 1},
        }
        reps.append(_report(node, 0, rows=rows,
                            buckets={"LAT[x]": h.buckets()}))
        jreps.append(_report(node, 0, rows=rows,
                             buckets={"LAT[x]": jh.buckets()}))
    return reps, jreps, sorted(pooled)


@pytest.mark.parametrize("seed", [3, 11])
def test_collector_sums_counters_exactly_and_merges_histograms(seed):
    from multiverso_tpu.serving.obs_plane import ObsCollector as JColl

    reps, jreps, pooled = _three_node_reports(seed)
    col, jcol = ObsCollector(), JColl()
    for node in range(3):
        assert reps[node]["buckets"] == jreps[node]["buckets"]
        col.ingest(node, reps[node])
        jcol.ingest(node, jreps[node])
    fl = col.fleet()
    assert fl == jcol.fleet()
    assert fl["nodes"] == 3 and fl["counters"]["REQS[x]"] == 303
    for p, key in ((50, "p50_ms"), (99, "p99_ms")):
        truth = _nearest_rank(pooled, p)
        est = fl["histograms"]["LAT[x]"][key]
        assert abs(est - truth) / truth <= BUCKET_REL_ERROR + 1e-9
    assert fl["histograms"]["LAT[x]"]["count"] == 1500
    slo = fl["slos"]["SLO_P99[LAT[x]]"]
    truth_breach = sum(v > 5.0 for v in pooled) / len(pooled)
    assert slo["breach_frac"] == pytest.approx(truth_breach, abs=0.05)
    assert slo["burn"] == pytest.approx(slo["breach_frac"] / 0.01)
    col.ingest(1, _report(1, 1, rows={
        "REQS[x]": {"type": "counter", "value": 150}}))
    assert col.fleet()["counters"]["REQS[x]"] == 100 + 150 + 102


def test_collector_merged_chrome_doc_validates_across_nodes():
    col = ObsCollector()
    span0 = {"name": "serve.request", "trace_id": 7, "span_id": 1,
             "parent_id": None, "t0": 1.0, "t1": 2.0, "thread": "T",
             "attrs": {"model": "lm"}}
    pub = {"name": "bus.publish", "trace_id": 9, "span_id": 2,
           "parent_id": None, "t0": 2.0, "t1": 3.0, "thread": "T",
           "attrs": {}}
    span1 = {"name": "serve.request", "trace_id": 7, "span_id": 3,
             "parent_id": None, "t0": 0.5, "t1": 1.5, "thread": "T",
             "attrs": {"model": "lm"}}
    apply_ = {"name": "bus.apply", "trace_id": 9, "span_id": 4,
              "parent_id": 2, "t0": 2.5, "t1": 3.5, "thread": "T",
              "attrs": {}}
    col.ingest(0, _report(0, 0, spans=[span0, pub], anchor=[1000.0, 0.0]))
    col.ingest(1, _report(1, 0, spans=[span1, apply_],
                          anchor=[1000.2, 0.0]))
    doc = col.export_chrome()
    events = doc["traceEvents"]
    assert validate_chrome_events(events)["spans"] == 4
    assert {e["pid"] for e in events if e.get("ph") == "B"} == {0, 1}
    names = {e["pid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M"}
    assert names == {0: "node0", 1: "node1"}
    b1 = [e for e in events if e.get("ph") == "B"
          and e["pid"] == 1 and e["name"] == "serve.request"][0]
    assert b1["ts"] == pytest.approx(1000.7e6)
    ba = [e for e in events if e.get("ph") == "B"
          and e["name"] == "bus.apply"][0]
    assert ba["args"]["parent_id"] == "2"
    from multiverso_tpu.serving.obs_plane import ObsCollector as JColl

    jcol = JColl()
    jcol.ingest(0, _report(0, 0, spans=[span0, pub], anchor=[1000.0, 0.0]))
    jcol.ingest(1, _report(1, 0, spans=[span1, apply_],
                           anchor=[1000.2, 0.0]))
    assert jcol.export_chrome() == doc


def test_collector_degraded_edge_trigger_and_rearm():
    clock = {"t": 0.0}
    fired = []
    col = ObsCollector(degraded_after_s=1.0,
                       on_degraded=lambda node, age: fired.append(node),
                       clock=lambda: clock["t"])
    col.ingest(0, _report(0, 0))
    col.ingest(1, _report(1, 0))
    clock["t"] = 0.5
    assert col.check() == [] and col.degraded() == []
    clock["t"] = 0.9
    col.ingest(0, _report(0, 1))
    clock["t"] = 1.5
    assert [n for n, _ in col.check()] == [1]
    assert col.degraded() == [1] and fired == [1]
    clock["t"] = 2.0
    col.ingest(0, _report(0, 2))
    assert col.check() == [] and fired == [1]
    assert Dashboard.get_or_create_counter("OBS_DEGRADED[node1]").get() == 1
    col.ingest(1, _report(1, 1))
    assert col.check() == [] and col.degraded() == []
    assert (1, "recovered") in {(n, kind) for n, kind, _ in col.events}
    clock["t"] = 4.0
    col.ingest(0, _report(0, 3))
    assert [n for n, _ in col.check()] == [1]
    assert fired == [1, 1]


def test_collector_prometheus_carries_node_label():
    from multiverso_tpu.serving.obs_plane import ObsCollector as JColl

    col, jcol = ObsCollector(), JColl()
    for node in range(2):
        rep = _report(node, 0, rows={
            "REQS[x]": {"type": "counter", "value": 10 * (node + 1)},
            "LAT[x]": {"type": "histogram", "count": 2, "p50_ms": 1.5,
                       "p95_ms": 2.5, "p99_ms": 2.5, "mean_ms": 2.0,
                       "max_ms": 2.5}})
        col.ingest(node, rep)
        jcol.ingest(node, rep)
    text = col.prometheus()
    assert text == jcol.prometheus()
    assert 'node="0"' in text and 'node="1"' in text
    assert text.count("# TYPE mv_reqs counter") == 1
    assert "REQS[x]" in parse_prometheus(text)


def test_collector_table_lists_nodes_and_silence():
    col = ObsCollector()
    engines = {"lm": {"stats": {"tokens_per_s": 100.0, "live_seqs": 2,
                                "completed": 5, "shed": 0},
                      "health": {"live_seqs": 2},
                      "watchdog": {"trips_total": 1, "new_trips": []}}}
    col.ingest(0, _report(0, 0, engines=engines, ts=100.0))
    col.ingest(1, _report(1, 0, ts=90.0))
    text = col.table(silent_after_s=5.0)
    assert "SILENT" in text and "ok" in text and "100.0" in text
    lines = [ln for ln in text.splitlines()
             if ln.lstrip().startswith(("0 ", "1 "))]
    assert len(lines) == 2


def test_collector_roster_flags_never_reporting_node():
    clock = {"t": 0.0}
    col = ObsCollector(degraded_after_s=1.0, clock=lambda: clock["t"])
    col.expect_nodes(range(3))
    assert col.nodes() == [0, 1, 2]
    col.ingest(0, _report(0, 0))
    col.ingest(1, _report(1, 0))
    clock["t"] = 0.5
    assert col.check() == []
    clock["t"] = 1.2
    col.ingest(0, _report(0, 1))
    col.ingest(1, _report(1, 1))
    assert [n for n, _ in col.check()] == [2]
    assert col.degraded() == [2]
    col.expect_nodes(range(3))
    assert col.node_state(0)["reports"] == 2


def test_collector_replica_and_tenant_rows_equal_jax():
    """The router's gauges and the cost ledger's keyed instruments render
    the same replica and tenant rows in both collectors."""
    from multiverso_tpu.dashboard import Histogram as JHist
    from multiverso_tpu.serving.obs_plane import ObsCollector as JColl

    rows = {
        "FLEET_REPLICA_STATE[f.1]": {"type": "gauge", "value": 2.0},
        "FLEET_INFLIGHT[f.1]": {"type": "gauge", "value": 3.0},
        "FLEET_HB_AGE_MS[f.1]": {"type": "gauge", "value": 41.5},
        "FLEET_ROLE[f.1]": {"type": "gauge", "value": 1.0},
        "TENANT_REQUESTS[lm.t0]": {"type": "counter", "value": 4},
        "TENANT_COST[lm.t0]": {"type": "counter", "value": 2.5},
        "TENANT_SLO_MS[lm]": {"type": "gauge", "value": 20.0},
        "TENANT_LAT_MS[lm.t0]": {"type": "histogram", "count": 3},
    }
    h, jh = Histogram("L", register=False), JHist("L", register=False)
    for v in (5.0, 30.0, 12.0):
        h.record(v)
        jh.record(v)
    col, jcol = ObsCollector(), JColl()
    col.ingest(0, _report(0, 0, rows=rows,
                          buckets={"TENANT_LAT_MS[lm.t0]": h.buckets()}))
    jcol.ingest(0, _report(0, 0, rows=rows,
                           buckets={"TENANT_LAT_MS[lm.t0]": jh.buckets()}))
    assert col.replica_rows() == jcol.replica_rows()
    assert col.replica_rows()[0]["role"] == "prefill"
    assert col.tenant_rows() == jcol.tenant_rows()
    assert col.tenants_table() == jcol.tenants_table()


# -- the wire (in-process, real sockets) --------------------------------------

class _KV:
    """The three client calls the plane uses, backed by a local dict."""

    def __init__(self):
        self._d = {}
        self._cv = threading.Condition()

    def key_value_set(self, key, val, allow_overwrite=False):
        with self._cv:
            self._d[key] = val
            self._cv.notify_all()

    def blocking_key_value_get(self, key, timeout_ms):
        deadline = time.monotonic() + timeout_ms / 1000.0
        with self._cv:
            while key not in self._d:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"NOT_FOUND: {key}")
                self._cv.wait(left)
            return self._d[key]

    def key_value_try_get(self, key):
        with self._cv:
            if key not in self._d:
                raise KeyError(f"NOT_FOUND: {key}")
            return self._d[key]


def test_wire_reports_reach_collector_and_acks_release():
    kv = _KV()
    Dashboard.get_or_create_counter("WIRE[x]").inc(5)
    agents = [ObsAgent(rank=r, size=3, client=kv, report_ms=60,
                       label=f"twt{os.getpid()}", engines=lambda: {},
                       start=False)
              for r in range(3)]
    try:
        deadline = time.monotonic() + 20
        col = agents[0].collector
        while True:
            for a in agents:
                a.tick()
            if (sorted(col.nodes()) == [0, 1, 2]
                    and col.fleet()["counters"].get("WIRE[x]") == 15):
                break
            assert time.monotonic() < deadline, col.stats()
            time.sleep(0.02)
        assert all(a.dropped_reports == 0 for a in agents)
        for a in agents[1:]:
            deadline = time.monotonic() + 10
            while a._seq - a._released > 1:
                a.tick()
                assert time.monotonic() < deadline, (a._seq, a._released)
                time.sleep(0.02)
            with a._transport._lock:
                assert len(a._transport._retained) <= 1
    finally:
        for a in agents:
            a.stop(final_report=False)


def test_wire_drops_whole_reports_past_outstanding_cap():
    kv = _KV()
    trace.enable(256)
    agent = ObsAgent(rank=1, size=2, client=kv, report_ms=60,
                     label=f"tdt{os.getpid()}", engines=lambda: {},
                     start=False)
    try:
        c = Dashboard.get_or_create_counter("DROP_T[x]")
        c.inc(1)
        for _ in range(ObsAgent.MAX_OUTSTANDING):
            agent.tick()
        c.inc(41)
        with trace.span("serve.request", root=True, model="m"):
            pass
        for _ in range(5):
            assert agent.tick() is None
        assert agent.dropped_reports == 5
        with agent._transport._lock:
            assert len(agent._transport._retained) == \
                ObsAgent.MAX_OUTSTANDING
        kv.key_value_set(f"tdt{os.getpid()}/ack/1", str(agent._seq))
        rep = agent.tick()
        assert rep is not None
        assert rep["rows"]["DROP_T[x]"]["value"] == 42
        assert [sp["name"] for sp in rep["spans"]] == ["serve.request"]
    finally:
        agent.stop(final_report=False)
        trace.disable()
        trace.collector().clear()


def test_wire_acks_work_without_key_value_try_get():
    class _BlockingOnlyKV:
        def __init__(self):
            self._inner = _KV()
            self.key_value_set = self._inner.key_value_set
            self.blocking_key_value_get = self._inner.blocking_key_value_get

    kv = _BlockingOnlyKV()
    assert not hasattr(kv, "key_value_try_get")
    agent = ObsAgent(rank=1, size=2, client=kv, report_ms=60,
                     label=f"tnt{os.getpid()}", engines=lambda: {},
                     start=False)
    try:
        agent.tick()
        agent.tick()
        assert agent._released == 0
        kv.key_value_set(f"tnt{os.getpid()}/ack/1", "2")
        assert agent._release_acked_and_can_ship()
        assert agent._released == 2
        with agent._transport._lock:
            assert agent._transport._retained == {}
    finally:
        agent.stop(final_report=False)


def test_wire_hub_topology_only_collector_subscribes():
    kv = _KV()
    agents = [ObsAgent(rank=r, size=3, client=kv, report_ms=60,
                       label=f"thub{os.getpid()}", engines=lambda: {},
                       start=False)
              for r in range(3)]
    try:
        def sub_threads(agent):
            return [t.name for t in agent._transport._threads
                    if t.name.startswith("p2p-sub")]

        assert len(sub_threads(agents[0])) == 2
        assert sub_threads(agents[1]) == [] and sub_threads(agents[2]) == []
        deadline = time.monotonic() + 20
        col = agents[0].collector
        while not all(r in col.nodes() and col.node_state(r)["reports"] > 0
                      for r in range(3)):
            for a in agents:
                a.tick()
            assert time.monotonic() < deadline, col.stats()
            time.sleep(0.02)
        for a in agents[1:]:
            with a._transport._lock:
                assert all(not box for box in a._transport._in.values())
    finally:
        for a in agents:
            a.stop(final_report=False)


# -- interop with the JAX plane -----------------------------------------------

_NAMES = ("IOP_C[x]", "IOP_G[x]", "IOP_H[x]", "IOP_M[x]",
          "SLO_P99[IOP_H[x]]")


def _seed_instruments(dash, seed):
    """The same instrument values on one package's dashboard."""
    rng = np.random.default_rng(seed)
    dash.get_or_create_counter("IOP_C[x]").inc(17)
    dash.get_or_create_gauge("IOP_G[x]").set(2.5)
    h = dash.get_or_create_histogram("IOP_H[x]")
    for v in rng.lognormal(1.0, 0.8, 300):
        h.record(float(v))
    m = dash.get_or_create("IOP_M[x]")
    m.record(1.25)
    m.record(3.5)
    dash.set_slo("IOP_H[x]", 6.0)


def _fleet_rows(fl):
    """The parts of ``fleet()`` the seeded instruments make."""
    return {"nodes": fl["nodes"],
            "counters": {k: v for k, v in fl["counters"].items()
                         if k in _NAMES},
            "monitors": {k: v for k, v in fl["monitors"].items()
                         if k in _NAMES},
            "histograms": {k: v for k, v in fl["histograms"].items()
                           if k in _NAMES},
            "slos": {k: v for k, v in fl["slos"].items() if k in _NAMES}}


def _run_pair(collector_cls, agent_cls, kv, label):
    """Rank 0 (collector) and rank 1 (agent) over the real wire until
    rank 1's first report is ingested and acked."""
    col = collector_cls(rank=0, size=2, client=kv, report_ms=60,
                        label=label, engines=lambda: {}, start=False)
    agent = agent_cls(rank=1, size=2, client=kv, report_ms=60,
                      label=label, engines=lambda: {}, start=False)
    try:
        deadline = time.monotonic() + 20
        agent.tick()
        while True:
            col.tick()
            if col.collector.node_state(1)["reports"] >= 1:
                break
            assert time.monotonic() < deadline, col.collector.stats()
            time.sleep(0.02)
        deadline = time.monotonic() + 10
        while agent._seq - agent._released > 0:
            agent._release_acked_and_can_ship()
            assert time.monotonic() < deadline
            time.sleep(0.02)
        return _fleet_rows(col.collector.fleet()), agent.stats()
    finally:
        agent.stop(final_report=False)
        col.stop(final_report=False)


@pytest.mark.parametrize("direction", ["port_agent_to_jax_collector",
                                       "jax_agent_to_port_collector"])
def test_interop_fleet_rows_equal_an_all_jax_pair(direction):
    from multiverso_tpu.dashboard import Dashboard as JDash
    from multiverso_tpu.serving.obs_plane import ObsAgent as JAgent

    _seed_instruments(JDash, 5)
    _seed_instruments(Dashboard, 5)
    want, _ = _run_pair(JAgent, JAgent, _KV(), f"ija{os.getpid()}")
    if direction == "port_agent_to_jax_collector":
        got, agent_stats = _run_pair(JAgent, ObsAgent, _KV(),
                                     f"ipj{os.getpid()}")
    else:
        got, agent_stats = _run_pair(ObsAgent, JAgent, _KV(),
                                     f"ijp{os.getpid()}")
    assert got == want
    assert got["nodes"] == 2
    assert got["counters"]["IOP_C[x]"] == 34
    assert agent_stats["dropped_reports"] == 0
    assert agent_stats["outstanding"] == 0


# -- the session under -obs_plane ---------------------------------------------

def test_session_ships_final_report_before_servers_stop(tmp_path):
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models.transformer import (TransformerConfig,
                                                         TransformerLM)
    from multiverso_tpu_torch.runtime import Session
    from multiverso_tpu_torch.serving import InferenceServer

    sink = str(tmp_path / "obs.jsonl")
    Session._instance = None
    try:
        mv.init(["t", "-device=cpu", "-obs_plane=true",
                 "-obs_report_ms=50", f"-obs_jsonl={sink}"])
        sess = Session.get()
        agent = sess.obs_agent
        assert agent is not None and agent.collector is not None
        lm = TransformerLM(TransformerConfig(
            vocab_size=32, d_model=16, n_heads=2, n_layers=1, d_ff=32,
            max_seq=24))
        srv = InferenceServer("obs")
        eng = srv.register_decoder("lm", lm, slots=2, max_prompt=8,
                                   max_new=4)
        for f in [srv.submit("lm", [1 + i, 2, 3]) for i in range(4)]:
            f.result(timeout=120)
        deadline = time.monotonic() + 20
        while agent.reports < 2:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        order = []
        real_stop = srv.stop
        srv.stop = lambda: (order.append(("srv", agent.reports)),
                            real_stop())[1]
        mv.shutdown()
        assert sess.obs_agent is None
        lines = [json.loads(x) for x in open(sink).read().splitlines()]
        assert len(lines) == agent.reports
        # the final report shipped before the server stopped, and it
        # carries the engine although the registry was already empty
        assert order == [("srv", agent.reports)]
        last = lines[-1]["engines"]["lm"]
        assert last["stats"]["completed"] == 4
        assert last["health"]["stopped"] is False
        fl = agent.collector.fleet()
        assert fl["engines"]["lm"]["completed"] == 4
        assert eng.stats()["completed"] == 4
    finally:
        mv.shutdown()
        mv.set_flag("obs_plane", False)
        mv.set_flag("obs_jsonl", "")
        mv.set_flag("obs_report_ms", 1000)
        mv.set_flag("device", "cuda")
        Session._instance = None
