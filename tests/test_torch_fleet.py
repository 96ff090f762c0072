"""The port's serving fleet against the JAX package's.

``multiverso_tpu_torch.serving``'s ``FleetRouter``, ``ReplicaServer`` and
``FaultPlan`` over the port's p2p wire, on the CPU:

* the router's policies against deterministic fake engines (the cases of
  ``tests/test_fleet.py``): affinity, least-loaded dispatch, shedding by
  class, deadlines, retries, death, drain-and-replay and half-open
  readmission;
* the JAX package's schedules: ``retry_backoff_s`` and every ``FaultPlan``
  decision for the same ``(spec, seed)``;
* wire interop: a JAX router driving port replicas over port engines
  (outputs equal to JAX ``greedy_decode``), and a port router driving a
  JAX replica over a JAX engine;
* replay with real port engines: a kill mid-generation gives the
  fault-free outputs, equal to JAX ``greedy_decode``;
* three subprocess replicas over a file KV: a seeded ``os._exit`` kill
  and a restart readmitted through the probe.
"""

import os
import random
import subprocess
import sys
import textwrap
import threading
import time
from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.models import transformer as jtf
from multiverso_tpu_torch.serving import (DeadlineExceededError, FaultPlan,
                                          FleetConfig, FleetError,
                                          FleetRouter, OverloadedError,
                                          ReplicaServer, retry_backoff_s)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=32)
# heartbeat of the fleets over real engines: DEAD after two silent beats,
# long enough that a loaded host's stalls do not flag a healthy replica
REAL_HB_MS = 200


class _KV:
    """The three client calls the wire uses, over a local dict."""

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


class _FakeEngine:
    """Deterministic instant decode: the output is a pure function of the
    prompt, so the router's logic is what a test exercises."""

    def __init__(self, delay_s=0.0, queue_depth=0, fail_with=None):
        self.delay_s = delay_s
        self.queue_depth = queue_depth
        self.fail_with = fail_with
        self.submits = 0

    def submit(self, prompt, max_new=None, ctx=None):
        self.submits += 1
        if self.fail_with is not None:
            raise self.fail_with
        f = Future()
        p = np.asarray(prompt, np.int32)
        out = ((p[-1] + 1 + np.arange(max_new or 4)) % 64).astype(np.int32)

        def later():
            if self.delay_s:
                time.sleep(self.delay_s)
            f.set_result({"result": out, "snapshot_version": 1,
                          "staleness_s": 0.0})

        if self.delay_s:
            threading.Thread(target=later, daemon=True).start()
        else:
            later()
        return f

    def health(self):
        return {"queue_depth": self.queue_depth, "live_seqs": 0}

    def stats(self):
        return {"submits": self.submits}

    def stop(self):
        pass


class _PrioRecordingEngine(_FakeEngine):
    """The priority-aware submit surface, recording what arrived."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.seen = []

    def submit(self, prompt, max_new=None, ctx=None, priority=None,
               deadline_s=None):
        self.seen.append((priority, deadline_s))
        return super().submit(prompt, max_new, ctx)


def _wait(cond, what, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what()
        time.sleep(0.005)


def _mk_fleet(label, n_replicas=3, hb_ms=50, engines=None, **cfg_kw):
    kv = _KV()
    size = n_replicas + 1
    cfg_kw.setdefault("deadline_s", 30.0)
    router = FleetRouter(size, kv, label=label, name=label,
                         fleet_config=FleetConfig(heartbeat_ms=hb_ms,
                                                  **cfg_kw))
    engines = engines or [_FakeEngine() for _ in range(n_replicas)]
    replicas = [ReplicaServer(r + 1, size, kv, engines[r], label=label,
                              heartbeat_ms=hb_ms)
                for r in range(n_replicas)]
    _wait(lambda: router.stats()["up"] >= n_replicas, router.replica_rows)
    return kv, router, replicas, engines


def _stop_fleet(router, replicas):
    router.stop()
    for rep in replicas:
        try:
            rep.stop()
        except Exception:
            pass


def _prompt(n=3):
    return np.arange(1, 1 + n, dtype=np.int32)


# -- the JAX package's schedules ---------------------------------------------

SPECS = [
    "kill_at_request=5, wedge_at_request=3:0.25, wire_delay=0.05:0.5, "
    "wire_drop=0.1, slow_heartbeat=4",
    "kill_trainer_at_publish=6, wal_torn_tail, zombie_epoch=2:1",
    "wal_bad_crc=1, burst=2:3, pool_squeeze=4:0.5:7, kv_xfer_drop=2",
    "wire_delay=0.01, wire_drop=0.3",
]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_fault_plan_schedule_equals_jax(spec, seed):
    """Every field the grammar sets, then every consultation in one
    order, decision for decision against the JAX plan."""
    from multiverso_tpu.serving.faultinject import FaultPlan as JaxPlan

    def run(cls):
        kills = []
        plan = cls(spec, seed=seed, kill_fn=lambda: kills.append(1))
        fields = {k: v for k, v in vars(plan).items()
                  if not k.startswith("_") and k != "counts"}
        seq = []
        for k in range(1, 9):
            seq.append(("req", plan.on_request(k), plan.burst_n(k),
                        plan.squeeze_frac(k), plan.squeeze_release(k),
                        plan.drop_kv_xfer(k), plan.publish_epoch(k, 5)))
            for _ in range(5):
                seq.append((plan.wire_delay_s(), plan.drop_heartbeat()))
        plan.on_trainer_publish(6)
        return fields, seq, dict(plan.counts), kills, plan.active()

    assert run(FaultPlan) == run(JaxPlan)


@pytest.mark.parametrize("bad", ["explode=1", "kill_at_request",
                                 "slow_heartbeat=0.5", "burst=0:2",
                                 "pool_squeeze=1:1.5", "kv_xfer_drop=0",
                                 "zombie_epoch=0:1", "wal_torn_tail=2"])
def test_fault_plan_rejects_what_jax_rejects(bad):
    from multiverso_tpu.serving.faultinject import FaultPlan as JaxPlan

    with pytest.raises(ValueError):
        JaxPlan(bad)
    with pytest.raises(ValueError):
        FaultPlan(bad)


def test_fault_plan_kill_fn_and_wedge():
    from multiverso_tpu_torch.serving.faultinject import KILL_EXIT

    assert KILL_EXIT == 43
    killed = []
    plan = FaultPlan("kill_at_request=2, wedge_at_request=3:0.125",
                     kill_fn=lambda: killed.append(True))
    assert plan.on_request(1) == 0.0
    plan.on_request(2)
    assert killed == [True]
    assert plan.on_request(3) == 0.125
    assert plan.counts["kills"] == 1 and plan.counts["wedges"] == 1
    assert not FaultPlan("").active()


@pytest.mark.parametrize("attempt", [1, 2, 5, 12, 5000])
def test_retry_backoff_equals_jax(attempt):
    from multiverso_tpu.serving import retry_backoff_s as jax_backoff

    assert retry_backoff_s(attempt, 0.02, 1.0) == \
        jax_backoff(attempt, 0.02, 1.0)
    ra, rb = random.Random(attempt), random.Random(attempt)
    vals = [retry_backoff_s(attempt, 0.02, 1.0, ra) for _ in range(32)]
    assert vals == [jax_backoff(attempt, 0.02, 1.0, rb) for _ in range(32)]
    ceiling = min(1.0, 0.02 * 2 ** min(attempt - 1, 64))
    assert all(ceiling / 2 <= v <= ceiling for v in vals)
    with pytest.raises(ValueError):
        retry_backoff_s(0, 0.02, 1.0)


# -- routing policy -----------------------------------------------------------

def test_dispatch_completes_and_session_affinity():
    # a heartbeat a loaded host keeps: at 50 ms (DEAD after 100 ms of
    # silence) a stalled host flags the pinned replica and moves the
    # session; this test measures affinity, not detection latency
    kv, router, replicas, engines = _mk_fleet("aff", hb_ms=REAL_HB_MS)
    try:
        outs = [router.predict(_prompt(4), 4, session="sess-A")
                for _ in range(6)]
        assert len({o["replica"] for o in outs}) == 1
        for o in outs:
            assert o["result"].shape == (4,)
        st = router.stats()
        assert st["completed"] == 6 and st["requests_lost"] == 0
    finally:
        _stop_fleet(router, replicas)


def test_least_loaded_dispatch_avoids_busy_replica():
    engines = [_FakeEngine(queue_depth=50), _FakeEngine(), _FakeEngine()]
    kv, router, replicas, _ = _mk_fleet("load", engines=engines)
    try:
        served = {router.predict(_prompt(), 3)["replica"] for _ in range(8)}
        assert 1 not in served
    finally:
        _stop_fleet(router, replicas)


def test_fleet_shed_past_aggregate_depth():
    engines = [_FakeEngine(delay_s=5.0) for _ in range(2)]
    kv, router, replicas, _ = _mk_fleet("shed", n_replicas=2,
                                        engines=engines, shed_depth=4,
                                        deadline_s=60.0)
    try:
        futs = [router.submit(_prompt(2), 2) for _ in range(4)]
        with pytest.raises(OverloadedError) as exc:
            router.submit(_prompt(2), 2)
        assert exc.value.what == "fleet"
        assert router.stats()["shed"] == 1
        for f in futs:
            f.cancel()
    finally:
        _stop_fleet(router, replicas)


def test_deadline_exceeded_fails_the_future():
    kv, router, replicas, _ = _mk_fleet(
        "dl", n_replicas=1, engines=[_FakeEngine(delay_s=10.0)])
    try:
        fut = router.submit(_prompt(2), 2, deadline_s=0.2)
        with pytest.raises(DeadlineExceededError):
            fut.result(timeout=10)
        assert router.stats()["deadline_failures"] == 1
        assert router.stats()["requests_lost"] == 0
    finally:
        _stop_fleet(router, replicas)


# what every replica raises -> what the request resolves to, and how many
# submits the fleet spends on it
FAILURES = {
    # a deterministic engine error fails once: no retry storm
    "engine_error": (lambda: ValueError("bad prompt"),
                     dict(), RuntimeError, 1),
    # a shed bigger than the whole pool cannot change on retry
    "nonretriable_shed": (lambda: OverloadedError(
        "e", 9, 2, what="kv block pool", retriable=False),
        dict(), OverloadedError, 1),
    # a retriable shed everywhere spends the budget: first + retry_max
    "budget_exhausted": (lambda: OverloadedError("e", 9, 8),
                         dict(retry_max=2, backoff_ms=5.0,
                              backoff_cap_ms=10.0), FleetError, 3),
    # a backoff landing past the deadline fails now
    "backoff_past_deadline": (lambda: OverloadedError("e", 9, 8),
                              dict(backoff_ms=1000.0,
                                   backoff_cap_ms=1000.0, deadline_s=0.3),
                              DeadlineExceededError, 1),
}


@pytest.mark.parametrize("case", sorted(FAILURES))
def test_replica_failure_outcome(case):
    make, cfg_kw, exc_type, submits = FAILURES[case]
    engines = [_FakeEngine(fail_with=make())]
    kv, router, replicas, _ = _mk_fleet(f"fail_{case}", n_replicas=1,
                                        engines=engines, **cfg_kw)
    try:
        fut = router.submit(_prompt(2), 2)
        with pytest.raises(exc_type) as exc:
            fut.result(timeout=10)
        if case == "nonretriable_shed":
            assert exc.value.retriable is False
        assert engines[0].submits == submits
        st = router.stats()
        assert st["requests_lost"] == 0 and st["failed"] == 1
        assert st["deadline_failures"] == int(
            exc_type is DeadlineExceededError)
    finally:
        _stop_fleet(router, replicas)


def test_replica_overload_is_retried_elsewhere():
    engines = [_FakeEngine(fail_with=OverloadedError("e", 9, 8)),
               _FakeEngine()]
    kv, router, replicas, _ = _mk_fleet("ovl", n_replicas=2,
                                        engines=engines)
    try:
        got = {router.predict(_prompt(2), 2)["replica"] for _ in range(4)}
        assert got == {2}
        assert router.stats()["requests_lost"] == 0
    finally:
        _stop_fleet(router, replicas)


def test_shed_by_class_evicts_lowest_pending():
    """Past the cap a class-2 arrival evicts the newest queued class-0
    request (retriable ``OverloadedError``); with nothing lower queued
    the arrival sheds itself."""
    kv = _KV()
    router = FleetRouter(3, kv, label="shedcls", name="shedcls",
                         fleet_config=FleetConfig(heartbeat_ms=50,
                                                  shed_depth=3,
                                                  deadline_s=60.0))
    try:
        lows = [router.submit(_prompt(2), 2, priority=0) for _ in range(3)]
        hi = router.submit(_prompt(2), 2, priority=2)
        with pytest.raises(OverloadedError) as exc:
            lows[-1].result(timeout=10)
        assert exc.value.retriable is True and exc.value.what == "fleet"
        assert not hi.done()
        s = router.stats()
        assert s["shed_by_class"] == {"p0": 1} and s["requests_lost"] == 0
        with pytest.raises(OverloadedError):
            router.submit(_prompt(2), 2, priority=0)
        assert router.stats()["shed_by_class"] == {"p0": 2}
        with pytest.raises(ValueError):
            router.submit(_prompt(2), 2, priority=8)
        for f in lows[:2] + [hi]:
            f.cancel()
    finally:
        router.stop()


def test_priority_and_deadline_ride_the_wire():
    engines = [_PrioRecordingEngine()]
    kv, router, replicas, _ = _mk_fleet("priowire", n_replicas=1,
                                        engines=engines, deadline_s=30.0)
    try:
        reply = router.predict(_prompt(2), 2, priority=3)
        assert reply["replica"] == 1
        (prio, deadline_s), = engines[0].seen
        assert prio == 3 and 0 < deadline_s <= 30.0
    finally:
        _stop_fleet(router, replicas)


# -- death, redispatch, readmission -------------------------------------------

def test_dead_replica_flagged_drained_and_survivors_serve():
    hb_ms = 60
    engines = [_FakeEngine(delay_s=0.5), _FakeEngine(delay_s=0.01),
               _FakeEngine(delay_s=0.01)]
    kv, router, replicas, _ = _mk_fleet("death", hb_ms=hb_ms,
                                        engines=engines)
    try:
        engines[1].queue_depth = engines[2].queue_depth = 50
        time.sleep(3 * hb_ms / 1000.0)      # heartbeats carry the load
        futs = [router.submit(_prompt(4), 4, session="pin")
                for _ in range(3)]
        time.sleep(0.05)
        assert router._affinity.get("pin") == 1
        t_kill = time.monotonic()
        replicas[0].die()
        _wait(lambda: router.replica_rows()[0]["state"] == "DEAD",
              router.replica_rows, timeout=5.0)
        assert time.monotonic() - t_kill < 2 * hb_ms / 1000.0 + 1.0
        outs = [f.result(timeout=20) for f in futs]
        assert {o["replica"] for o in outs} <= {2, 3}
        st = router.stats()
        assert st["requests_lost"] == 0 and st["deaths"] == 1
        assert st["recovery_time_s"] is not None
        assert router._affinity.get("pin") != 1
    finally:
        _stop_fleet(router, replicas)


def test_half_open_readmission_probe():
    # REAL_HB_MS, not 50 ms: a loaded host's stall would flag a healthy
    # replica (or the readmitted one again); detection latency is
    # test_dead_replica_flagged_drained_and_survivors_serve's to measure
    hb_ms = REAL_HB_MS
    kv, router, replicas, engines = _mk_fleet("readmit", hb_ms=hb_ms)
    try:
        replicas[0].die()
        _wait(lambda: router.replica_rows()[0]["state"] == "DEAD",
              router.replica_rows)
        replicas[0] = ReplicaServer(1, 4, kv, _FakeEngine(),
                                    label="readmit", heartbeat_ms=hb_ms)
        _wait(lambda: router.stats()["readmissions"] >= 1,
              router.replica_rows)
        rows = router.replica_rows()
        assert rows[0]["state"] == "UP" and rows[0]["readmissions"] == 1
        served = {router.predict(_prompt(), 3)["replica"] for _ in range(6)}
        assert 1 in served
        assert router.stats()["requests_lost"] == 0
    finally:
        _stop_fleet(router, replicas)


def test_n_minus_one_keeps_serving_at_reduced_capacity():
    kv, router, replicas, _ = _mk_fleet("degraded")
    try:
        replicas[2].die()
        _wait(lambda: router.replica_rows()[2]["state"] == "DEAD",
              router.replica_rows)
        outs = [router.predict(_prompt(), 3) for _ in range(6)]
        assert {o["replica"] for o in outs} <= {1, 2}
        st = router.stats()
        assert st["up"] == 2 and st["requests_lost"] == 0
    finally:
        _stop_fleet(router, replicas)


def test_slow_heartbeat_chaos_applies_after_assignment():
    """The heartbeat scale is read per beat, so a plan assigned after
    construction slows the beats."""
    kv, router, replicas, _ = _mk_fleet("slowhb", n_replicas=1, hb_ms=40)
    try:
        rep = replicas[0]
        _wait(lambda: rep.heartbeats >= 5, rep.stats)
        rep.chaos = FaultPlan("slow_heartbeat=100")   # 40 ms -> 4 s
        time.sleep(0.2)
        n0 = rep.heartbeats
        time.sleep(0.6)
        assert rep.heartbeats - n0 <= 1
    finally:
        _stop_fleet(router, replicas)


def test_boot_dead_replica_does_not_pin_release_frontier():
    """A rank that never heartbeats must not pin the request stream's
    release frontier at 0."""
    kv = _KV()
    router = FleetRouter(4, kv, label="bootdead", name="bootdead")
    live = [ReplicaServer(r, 4, kv, _FakeEngine(), label="bootdead")
            for r in (1, 2)]
    try:
        _wait(lambda: router.stats()["up"] >= 2, router.replica_rows)
        for _ in range(6):
            router.predict(_prompt(), 3)
        _wait(lambda: router._released > 0,
              lambda: (router._released, router._seq), timeout=10.0)
        with router._transport._lock:
            retained = len(router._transport._retained)
        assert retained < router._seq
    finally:
        router.stop()
        for rep in live:
            rep.stop()


def test_route_dispatch_span_links_router_to_replica():
    from multiverso_tpu_torch import trace

    trace.enable(4096)
    try:
        kv, router, replicas, _ = _mk_fleet("spans", n_replicas=1)
        try:
            router.predict(_prompt(), 3)
        finally:
            _stop_fleet(router, replicas)
        by_name = {}
        for sp in trace.collector().spans():
            by_name.setdefault(sp.name, []).append(sp)
        roots = [sp for sp in by_name.get("serve.request", [])
                 if sp.attrs.get("fleet")]
        assert roots, sorted(by_name)
        root = roots[0]
        dispatch = [sp for sp in by_name.get("route.dispatch", [])
                    if sp.trace_id == root.trace_id]
        assert dispatch and dispatch[0].parent_id == root.span_id
        execs = [sp for sp in by_name.get("replica.exec", [])
                 if sp.trace_id == root.trace_id]
        assert execs and execs[0].parent_id == dispatch[0].span_id
    finally:
        trace.disable()


def test_messages_encode_to_the_jax_bytes():
    from multiverso_tpu.serving import replica as jrep
    from multiverso_tpu_torch.serving import replica as trep

    msg = {"t": trep.MSG_REQ, "target": 2, "rid": "ab12", "prompt": [1, 2],
           "max_new": 4, "trace": None, "prio": 1, "deadline_ms": 250.0,
           "tenant": "acme", "known": ["00ff"]}
    assert trep.encode_msg(msg) == jrep.encode_msg(msg)
    assert trep.decode_msg(jrep.encode_msg(msg)) == msg
    for name in ("LABEL", "ROUTER_RANK", "MSG_REQ", "MSG_PING", "MSG_RSP",
                 "MSG_ERR", "MSG_PONG", "MSG_HB", "MSG_XFER", "ROLES"):
        assert getattr(trep, name) == getattr(jrep, name), name


# -- real engines -------------------------------------------------------------

@pytest.fixture()
def port():
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.dashboard import Dashboard
    from multiverso_tpu_torch.runtime import Session

    Session._instance = None
    Dashboard.reset()
    mv.init(["test", "-device=cpu", "-log_level=error"])
    # one torch thread: under the suite's parallel workers a full pool
    # of threads per engine starves the replicas' heartbeat threads
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield mv
    torch.set_num_threads(threads)
    mv.shutdown()
    Dashboard.reset()
    Session._instance = None
    mv.set_flag("device", "cuda")


def _port_engine(name, **kw):
    """A warm port engine over the seeded small LM (the same weights as
    the JAX package's ``init_params`` from that config)."""
    from multiverso_tpu_torch.models.transformer import (TransformerConfig,
                                                         TransformerLM)
    from multiverso_tpu_torch.serving import DecodeEngine, DecodeEngineConfig

    engine = DecodeEngine(name, TransformerLM(TransformerConfig(**SMALL)),
                          DecodeEngineConfig(**{
                              "slots": 2, "max_prompt": 8, "max_new": 10,
                              "watchdog": False, **kw}))
    engine.warmup()
    return engine


def _trace(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, SMALL["vocab_size"],
                          int(rng.integers(2, 9))).astype(np.int32),
             int(rng.integers(4, 11))) for _ in range(n)]


def _jax_oracle(reqs):
    """JAX ``greedy_decode`` on ``init_params`` of the small config, all
    prompts in one right-padded batch, row i cut to its ``max_new``."""
    cfg = jtf.TransformerConfig(**SMALL)
    P = max(len(p) for p, _ in reqs)
    toks = np.zeros((len(reqs), P), np.int32)
    for i, (p, _) in enumerate(reqs):
        toks[i, : len(p)] = p
    out = np.asarray(jtf.greedy_decode(
        cfg, jtf.init_params(cfg), jnp.asarray(toks),
        jnp.asarray([len(p) for p, _ in reqs], np.int32),
        max(m for _, m in reqs), None))
    return [row[:m] for row, (_, m) in zip(out, reqs)]


def test_replay_real_port_engines_kill_mid_generation(port):
    """Three replicas of real port engines serve one trace twice,
    fault-free and with a chaos kill of one replica mid-trace: every
    request completes both times, the outputs are equal, and equal to
    JAX ``greedy_decode`` on the same weights."""
    reqs = _trace(5, 12)
    oracle = _jax_oracle(reqs)          # before any fleet is up
    engines = [_port_engine(f"flt{r}") for r in range(3)]
    runs = {}
    try:
        for label, chaos in (("clean", ""), ("chaos", "kill_at_request=2")):
            kv = _KV()
            router = FleetRouter(4, kv, label=f"replay_{label}",
                                 fleet_config=FleetConfig(
                                     heartbeat_ms=REAL_HB_MS, deadline_s=120.0))
            replicas = [ReplicaServer(r + 1, 4, kv, engines[r],
                                      label=f"replay_{label}",
                                      heartbeat_ms=REAL_HB_MS) for r in range(3)]
            if chaos:
                replicas[0].chaos = FaultPlan(chaos,
                                              kill_fn=replicas[0].die)
            _wait(lambda: router.stats()["up"] >= 3, router.replica_rows)
            futs = [router.submit(p, m, session=f"s{i % 4}")
                    for i, (p, m) in enumerate(reqs)]
            runs[label] = [np.asarray(f.result(timeout=120)["result"],
                                      np.int32) for f in futs]
            st = router.stats()
            assert st["requests_lost"] == 0, st
            assert st["output_mismatches"] == 0, st
            assert st["deaths"] == (1 if chaos else 0), st
            router.stop()
            for rep in replicas:
                rep.stop(stop_engine=False)
    finally:
        for engine in engines:
            engine.stop()
    for i, (clean, chaos, want) in enumerate(zip(runs["clean"],
                                                 runs["chaos"], oracle)):
        np.testing.assert_array_equal(clean, chaos, err_msg=str(i))
        np.testing.assert_array_equal(clean, want, err_msg=str(i))


def test_jax_router_drives_port_replicas(port):
    """The JAX package's router over port replicas and engines: the
    outputs equal JAX ``greedy_decode``, and a tenant rides the wire."""
    from multiverso_tpu.serving import FleetConfig as JaxFleetConfig
    from multiverso_tpu.serving import FleetRouter as JaxRouter

    reqs = _trace(7, 6)
    oracle = _jax_oracle(reqs)
    engines = [_port_engine(f"jr{r}", cost_ledger=True) for r in range(2)]
    kv = _KV()
    router = JaxRouter(3, kv, label="jaxrouter",
                       fleet_config=JaxFleetConfig(heartbeat_ms=REAL_HB_MS,
                                                   deadline_s=120.0))
    replicas = [ReplicaServer(r + 1, 3, kv, engines[r], label="jaxrouter",
                              heartbeat_ms=REAL_HB_MS) for r in range(2)]
    try:
        _wait(lambda: router.stats()["up"] >= 2, router.replica_rows)
        futs = [router.submit(p, m, tenant="acme") for p, m in reqs]
        outs = [np.asarray(f.result(timeout=120)["result"]) for f in futs]
        st = router.stats()
        assert st["requests_lost"] == 0 and st["completed"] == len(reqs)
    finally:
        router.stop()
        for rep in replicas:
            rep.stop()
    for out, want in zip(outs, oracle):
        np.testing.assert_array_equal(out, want)
    billed = sum(e.ledger.tenants().get("acme", {}).get("requests", 0)
                 for e in engines)
    assert billed == len(reqs)


def test_port_router_drives_jax_replica(port, mv_session):
    """The port's router over a JAX replica and JAX engine: replies
    arrive through the port's wire and equal JAX ``greedy_decode``."""
    from multiverso_tpu.models.transformer import TransformerLM as JaxLM
    from multiverso_tpu.serving import ReplicaServer as JaxReplica
    from multiverso_tpu.serving.decode_engine import (
        DecodeEngine as JaxEngine, DecodeEngineConfig as JaxEngineConfig)

    reqs = _trace(9, 4)
    oracle = _jax_oracle(reqs)
    engine = JaxEngine("jxr", JaxLM(jtf.TransformerConfig(**SMALL)),
                       JaxEngineConfig(slots=2, max_prompt=8, max_new=10,
                                       watchdog=False))
    engine.warmup()
    kv = _KV()
    router = FleetRouter(2, kv, label="portrouter",
                         fleet_config=FleetConfig(heartbeat_ms=REAL_HB_MS,
                                                  deadline_s=120.0))
    rep = JaxReplica(1, 2, kv, engine, label="portrouter", heartbeat_ms=REAL_HB_MS)
    try:
        _wait(lambda: router.stats()["up"] >= 1, router.replica_rows)
        outs = [np.asarray(router.predict(p, m, timeout_s=120)["result"])
                for p, m in reqs]
        st = router.stats()
        assert st["requests_lost"] == 0 and st["completed"] == len(reqs)
        assert router.replica_rows()[0]["snapshot_version"] >= 0
    finally:
        router.stop()
        rep.stop()
    for out, want in zip(outs, oracle):
        np.testing.assert_array_equal(out, want)


# -- the pool chaos hooks -----------------------------------------------------

def test_squeeze_pool_forces_preemption_and_stays_drift_clean(port):
    """Squeezed blocks are held with no sequence and are no leak; live
    traffic preempts around them, every output equals JAX
    ``greedy_decode``, and unsqueezing returns every block."""
    engine = _port_engine("squeeze", slots=4, max_new=12, kv_block_size=4,
                          kv_pool_blocks=12, prefill_token_budget=4,
                          max_queue=32)
    try:
        assert engine.squeeze_pool(0.5) == 6
        assert engine.pool_drift() is None
        rng = np.random.default_rng(31)
        reqs = [(rng.integers(1, SMALL["vocab_size"],
                              int(rng.integers(4, 9))).astype(np.int32), 12)
                for _ in range(8)]
        want = _jax_oracle(reqs)
        futs = [engine.submit(p, m) for p, m in reqs]
        for f, w in zip(futs, want):
            np.testing.assert_array_equal(f.result(timeout=180)["result"], w)
        assert engine.stats()["preemptions"] > 0
        assert engine.unsqueeze_pool() == 6
        assert engine.stats()["kv_blocks_live"] == 0
        engine._pool.check()
    finally:
        engine.stop()


def test_squeeze_raced_admission_requeues(port):
    """An admission whose reservation races a squeeze (the allocation
    raises) goes back to the queue with its claimed blocks returned and
    no hit counted; it is served, and counted once, after the release."""
    from multiverso_tpu_torch.serving.decode_engine import _Request

    engine = _port_engine("race", max_new=8, kv_block_size=4,
                          kv_pool_blocks=6, prefill_token_budget=4)
    try:
        prompt = np.random.default_rng(7).integers(
            1, SMALL["vocab_size"], 8).astype(np.int64)
        want = _jax_oracle([(prompt.astype(np.int32), 8)])[0]
        engine.submit(prompt, 8).result(timeout=120)
        assert engine._pool.n_cached == 2
        free = engine._pool.n_free
        assert engine.squeeze_pool(free / engine._pool.capacity) == free
        hits0 = engine.prefix_hits
        req = _Request(prompt, 8)
        slot = engine._free_q.popleft()
        engine._begin_prefill(req, slot)     # the copy's alloc raises
        assert req.slot == -1 and req.blocks == []
        assert len(engine._q) == 1 and slot in engine._free_q
        assert engine.prefix_hits == hits0 and engine._pool.n_cached == 2
        assert engine._pool.drift() is None
        engine.unsqueeze_pool()
        with engine._cv:
            engine._cv.notify()
        np.testing.assert_array_equal(
            req.future.result(timeout=120)["result"], want)
        assert engine.prefix_hits == hits0 + 2
        engine._pool.check()
    finally:
        engine.stop()


def test_burst_and_pool_squeeze_through_a_replica(port):
    """The replica fires a plan's burst and pool squeeze at the requests
    it names: the burst's copies go to the engine, the squeeze holds half
    the pool until its release; every fleet request still equals JAX
    ``greedy_decode`` and nothing is lost."""
    engine = _port_engine("burst", slots=4, max_new=10, kv_block_size=4,
                          kv_pool_blocks=12, prefill_token_budget=4,
                          max_queue=32)
    reqs = _trace(13, 6)
    want = _jax_oracle(reqs)
    kv = _KV()
    router = FleetRouter(2, kv, label="burst", fleet_config=FleetConfig(
        heartbeat_ms=REAL_HB_MS, deadline_s=120.0))
    rep = ReplicaServer(1, 2, kv, engine, label="burst",
                        heartbeat_ms=REAL_HB_MS)
    rep.chaos = FaultPlan("burst=2:3, pool_squeeze=1:0.5:4")
    try:
        _wait(lambda: router.stats()["up"] >= 1, router.replica_rows)
        outs = [np.asarray(router.predict(p, m, timeout_s=120)["result"])
                for p, m in reqs]
        for out, w in zip(outs, want):
            np.testing.assert_array_equal(out, w)
        counts = rep.stats()["chaos"]
        assert counts["bursts"] == 1 and counts["pool_squeezes"] == 1
        assert engine._squeezed == []            # released at request 4
        _wait(lambda: engine.stats()["completed"] >= len(reqs) + 3,
              engine.stats)
        st = router.stats()
        assert st["requests_lost"] == 0 and st["completed"] == len(reqs)
    finally:
        router.stop()
        rep.stop()
    engine._pool.check()


# -- three subprocess replicas ------------------------------------------------

_FILE_KV = textwrap.dedent("""
    class FileKV:
        def __init__(self, root):
            self.root = root
        def _p(self, key):
            return os.path.join(self.root, "kv", key.replace("/", "_"))
        def key_value_set(self, key, val, allow_overwrite=False):
            p = self._p(key)
            tmp = p + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(str(val))
            os.replace(tmp, p)
        def blocking_key_value_get(self, key, timeout_ms):
            deadline = time.monotonic() + timeout_ms / 1000.0
            while True:
                try:
                    with open(self._p(key)) as f:
                        return f.read()
                except FileNotFoundError:
                    if time.monotonic() > deadline:
                        raise TimeoutError(key)
                    time.sleep(0.02)
        def key_value_try_get(self, key):
            try:
                with open(self._p(key)) as f:
                    return f.read()
            except FileNotFoundError:
                raise KeyError("NOT_FOUND: " + key)
""")

_REPLICA_WORKER = textwrap.dedent("""
    import os, sys, time
    sys.path.insert(0, %r)
    import torch
    torch.set_num_threads(1)
""") + _FILE_KV + textwrap.dedent("""
    rank = int(os.environ["FLEET_RANK"])
    import multiverso_tpu_torch as mv
    # the flag-wired bootstrap: -chaos/-chaos_seed arm the plan
    mv.init(["w", "-device=cpu", "-log_level=error",
             "-fleet_heartbeat_ms=250",
             "-chaos=" + os.environ.get("FLEET_CHAOS", ""),
             "-chaos_seed=1"])
    from multiverso_tpu_torch.models.transformer import (TransformerConfig,
                                                         TransformerLM)
    from multiverso_tpu_torch.serving import serve_replica

    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                            n_layers=2, d_ff=64, max_seq=32)
    kv = FileKV(os.environ["FLEET_ROOT"])
    replica = serve_replica(rank, 4, kv, TransformerLM(cfg), label="fleet",
                            engine_kw=dict(slots=2, max_prompt=8,
                                           max_new=10, watchdog=False))
    print(f"REPLICA{rank}_UP", flush=True)
    kv.blocking_key_value_get("phase/done", 300_000)
    replica.stop()
    mv.shutdown()
    print(f"REPLICA{rank}_CLEAN_EXIT", flush=True)
""")


def _spawn_replica(root, rank, chaos=""):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update({"FLEET_RANK": str(rank), "FLEET_ROOT": str(root),
                "FLEET_CHAOS": chaos, "PYTHONPATH": REPO,
                "OMP_NUM_THREADS": "1"})
    return subprocess.Popen([sys.executable, "-c", _REPLICA_WORKER % REPO],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def test_three_process_replicas_kill_and_restart(tmp_path):
    """Three subprocess port replicas over a file KV; rank 1's flag-armed
    plan ``os._exit``s it at its third request. Every request completes
    with JAX ``greedy_decode``'s output, nothing is lost, the death is
    flagged, and a restarted rank 1 is readmitted through the probe and
    serves again."""
    from multiverso_tpu_torch.serving.faultinject import KILL_EXIT

    ns = {"os": os, "time": time}
    exec(_FILE_KV, ns)
    os.makedirs(tmp_path / "kv")
    kv = ns["FileKV"](str(tmp_path))
    reqs = _trace(11, 15)
    oracle = _jax_oracle(reqs)
    router = FleetRouter(4, kv, label="fleet",
                         fleet_config=FleetConfig(heartbeat_ms=250,
                                                  deadline_s=240.0))
    procs = {r: _spawn_replica(tmp_path, r, "kill_at_request=3"
                               if r == 1 else "") for r in (1, 2, 3)}
    restarted = None
    try:
        deadline = time.monotonic() + 180
        while router.stats()["up"] < 3:
            assert time.monotonic() < deadline, router.replica_rows()
            for r, p in procs.items():
                assert p.poll() is None, (r, p.communicate()[0][-4000:])
            time.sleep(0.05)
        futs = [router.submit(p, m, session=f"s{i % 6}")
                for i, (p, m) in enumerate(reqs)]
        assert procs[1].wait(timeout=180) == KILL_EXIT
        t_exit = time.monotonic()
        _wait(lambda: router.replica_rows()[0]["state"] == "DEAD",
              router.replica_rows, timeout=30.0)
        assert time.monotonic() - t_exit < 2 * 0.25 + 2.0
        outs = [np.asarray(f.result(timeout=240)["result"], np.int32)
                for f in futs]
        st = router.stats()
        assert st["requests_lost"] == 0 and st["output_mismatches"] == 0
        assert st["deaths"] >= 1 and st["recovery_time_s"] is not None
        for (prompt, _), out, want in zip(reqs, outs, oracle):
            np.testing.assert_array_equal(out, want, err_msg=str(prompt))
        restarted = _spawn_replica(tmp_path, 1)
        deadline = time.monotonic() + 180
        while True:
            row = router.replica_rows()[0]
            if row["readmissions"] >= 1 and row["state"] == "UP":
                break
            assert time.monotonic() < deadline, router.replica_rows()
            assert restarted.poll() is None
            time.sleep(0.05)
        served = set()
        deadline = time.monotonic() + 120
        while 1 not in served and time.monotonic() < deadline:
            served.add(router.predict(_prompt(4), 4,
                                      timeout_s=120)["replica"])
        assert 1 in served, served
        assert router.stats()["requests_lost"] == 0
    finally:
        kv.key_value_set("phase/done", "1")
        router.stop()
        outs = {}
        for r, p in list(procs.items()) + [("1r", restarted)]:
            if p is None:
                continue
            try:
                outs[r], _ = p.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                outs[r] = "TIMEOUT: " + p.communicate()[0]
    assert procs[1].returncode == KILL_EXIT
    for r in (2, 3):
        assert procs[r].returncode == 0, f"rank {r}:\n{outs[r][-4000:]}"
        assert f"REPLICA{r}_CLEAN_EXIT" in outs[r]
    assert restarted.returncode == 0, outs["1r"][-4000:]
