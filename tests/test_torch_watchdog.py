"""The port's engine watchdog against the JAX package's.

The same sequence of health and drift readings goes into a JAX
``EngineWatchdog`` and the port's (each over its own fake engine): they
trip on the same polls with the same reasons. Then the JAX file's unit
cases on the port's class (stall, queue age, two-verdict drift, stopped
engine, bundle layout, flapping bound, thread stacks), an injected stall
on a real engine, and the drift detector on a real engine.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from multiverso_tpu.serving import watchdog as jwd
from multiverso_tpu_torch.dashboard import Dashboard
from multiverso_tpu_torch.serving.watchdog import (EngineWatchdog,
                                                   WatchdogConfig,
                                                   thread_stacks)


class _FakeEngine:
    """The watchdog's whole contract: health() / pool_drift() / stats()
    / name / recorder."""

    name = "fake"

    def __init__(self):
        self.h = {"iters_total": 7, "last_iter_age_s": 0.0, "live_seqs": 0,
                  "active_slots": 0, "queue_depth": 0, "queue_age_s": 0.0,
                  "stopped": False}
        self.drift = None
        self.recorder = None

    def health(self):
        return dict(self.h)

    def pool_drift(self):
        return self.drift

    def stats(self):
        return {"marker": 123, **self.h}


@pytest.fixture()
def fake_wd(tmp_path):
    Dashboard.reset()
    engine = _FakeEngine()
    wd = EngineWatchdog(engine, WatchdogConfig(
        stall_s=0.5, queue_age_s=2.0, dump_dir=str(tmp_path)), start=False)
    yield engine, wd
    Dashboard.reset()


def test_trips_match_jax_on_one_reading_sequence():
    rng = np.random.default_rng(3)
    jeng, teng = _FakeEngine(), _FakeEngine()
    jdog = jwd.EngineWatchdog(jeng, jwd.WatchdogConfig(
        stall_s=0.5, queue_age_s=2.0), start=False)
    tdog = EngineWatchdog(teng, WatchdogConfig(stall_s=0.5, queue_age_s=2.0),
                          start=False)
    for _ in range(300):
        h = {"live_seqs": int(rng.integers(0, 3)),
             "last_iter_age_s": float(rng.choice([0.0, 0.2, 1.0])),
             "queue_age_s": float(rng.choice([0.0, 1.0, 3.0])),
             "queue_depth": int(rng.integers(0, 5)),
             "stopped": bool(rng.random() < 0.05)}
        drift = (None if rng.random() < 0.6
                 else f"leak: {int(rng.integers(0, 4))} free")
        for eng in (jeng, teng):
            eng.h.update(h)
            eng.drift = drift
        assert tdog.check_once() == jdog.check_once()
    assert tdog.trip_count == jdog.trip_count > 0
    assert [t[:2] for t in tdog.trips] == [t[:2] for t in jdog.trips]


def test_stall_requires_live_work_and_rearms(fake_wd):
    engine, wd = fake_wd
    assert wd.check_once() == []
    engine.h["last_iter_age_s"] = 5.0
    assert wd.check_once() == []                  # idle != stalled
    engine.h["live_seqs"] = 2
    fired = wd.check_once()
    assert len(fired) == 1 and "stall" in fired[0]
    assert wd.check_once() == []                  # edge-triggered
    engine.h["last_iter_age_s"] = 0.0
    assert wd.check_once() == []
    engine.h["last_iter_age_s"] = 5.0             # re-armed
    assert len(wd.check_once()) == 1
    assert wd.trip_count == 2
    assert Dashboard.get_or_create_counter(
        "WATCHDOG_TRIPS[fake]").get() == 2


def test_queue_age_breach_trips(fake_wd):
    engine, wd = fake_wd
    engine.h["queue_age_s"] = 1.0
    assert wd.check_once() == []
    engine.h["queue_age_s"] = 3.0
    fired = wd.check_once()
    assert len(fired) == 1 and "queue-age breach" in fired[0]
    assert wd.trips[0][0] == "queue_age"


def test_pool_drift_needs_two_consecutive_verdicts(fake_wd):
    engine, wd = fake_wd
    engine.drift = "leak: 2 free + 1 live != capacity 4"
    assert wd.check_once() == []
    fired = wd.check_once()
    assert len(fired) == 1 and "block-pool drift" in fired[0]
    wd2 = EngineWatchdog(engine, wd.config, start=False)
    engine.drift = "leak: transient"
    assert wd2.check_once() == []
    engine.drift = None
    assert wd2.check_once() == []
    assert wd2.trip_count == 0
    wd3 = EngineWatchdog(engine, wd.config, start=False)
    engine.drift = "leak: 2 free + 1 live != capacity 4"
    assert wd3.check_once() == []
    engine.drift = "leak: 1 free + 2 live != capacity 4"
    fired = wd3.check_once()
    assert len(fired) == 1 and "block-pool drift" in fired[0]


def test_stopped_engine_never_trips(fake_wd):
    engine, wd = fake_wd
    engine.h.update(stopped=True, live_seqs=3, last_iter_age_s=99.0,
                    queue_age_s=99.0)
    engine.drift = "leak"
    assert wd.check_once() == []
    assert wd.check_once() == []
    assert wd.trip_count == 0


def test_bundle_layout_and_no_dump_dir(fake_wd):
    engine, wd = fake_wd
    engine.h.update(live_seqs=1, last_iter_age_s=5.0)
    wd.check_once()
    kind, reason, bundle = wd.trips[0]
    assert kind == "stall" and bundle is not None
    files = set(os.listdir(bundle))
    assert {"stats.json", "dashboard.json", "stacks.txt"} <= files
    meta = json.load(open(os.path.join(bundle, "stats.json")))
    assert meta["kind"] == "stall" and meta["engine"] == "fake"
    assert meta["stats"]["marker"] == 123
    dash = json.load(open(os.path.join(bundle, "dashboard.json")))
    assert dash["WATCHDOG_TRIPS[fake]"] == {"type": "counter", "value": 0}
    assert "MainThread" in open(os.path.join(bundle, "stacks.txt")).read()
    engine2 = _FakeEngine()
    engine2.h.update(live_seqs=1, last_iter_age_s=5.0)
    seen = []
    wd2 = EngineWatchdog(engine2, WatchdogConfig(
        stall_s=0.5, on_trip=lambda r, b: seen.append((r, b))),
        start=False)
    wd2.check_once()
    assert wd2.trips[0][2] is None
    assert seen and seen[0][1] is None and "stall" in seen[0][0]


def test_flapping_condition_bounded_memory_and_bundles(fake_wd):
    engine, wd = fake_wd
    for _ in range(70):
        engine.h["queue_age_s"] = 3.0
        assert len(wd.check_once()) == 1
        engine.h["queue_age_s"] = 0.0
        assert wd.check_once() == []
    assert wd.trip_count == 70
    assert Dashboard.get_or_create_counter(
        "WATCHDOG_TRIPS[fake]").get() == 70
    assert len(wd.trips) == 64
    assert wd.bundles == wd.config.max_bundles == 16
    assert all(t[2] is None for t in list(wd.trips)[-54:])
    assert sum(os.path.isdir(os.path.join(wd.config.dump_dir, d))
               for d in os.listdir(wd.config.dump_dir)) == 16


def test_thread_stacks_cover_live_threads():
    text = thread_stacks()
    assert "MainThread" in text
    assert "test_thread_stacks_cover_live_threads" in text


@pytest.fixture()
def port():
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.runtime import Session

    Session._instance = None
    Dashboard.reset()
    mv.init(["test", "-device=cpu"])
    yield mv
    mv.shutdown()
    Dashboard.reset()
    Session._instance = None
    mv.set_flag("device", "cuda")


def _lm():
    from multiverso_tpu_torch.models.transformer import (TransformerConfig,
                                                         TransformerLM)

    return TransformerLM(TransformerConfig(vocab_size=64, d_model=32,
                                           n_heads=4, n_layers=2, d_ff=64,
                                           max_seq=48))


def test_injected_stall_trips_within_deadline(port, tmp_path):
    """A wedged fused step on a live engine trips the running watchdog
    within stall_s + ~2 polls; the bundle holds the ring and the wedged
    thread's stack; the engine finishes once released."""
    from multiverso_tpu_torch.serving import InferenceServer

    srv = InferenceServer("t")
    engine = srv.register_decoder("lm", _lm(), slots=2, max_prompt=8,
                                  max_new=8, watchdog=False)
    out = srv.submit("lm", np.arange(1, 5)).result(timeout=60)
    assert len(out["result"]) == 8
    tripped = threading.Event()
    engine.watchdog = EngineWatchdog(engine, WatchdogConfig(
        interval_s=0.05, stall_s=0.4, queue_age_s=0.0,
        dump_dir=str(tmp_path),
        on_trip=lambda reason, bundle: tripped.set()))
    release = threading.Event()
    orig_step = engine._step_fn

    def wedged_step(*args):
        release.wait(30)
        return orig_step(*args)

    engine._step_fn = wedged_step
    t0 = time.monotonic()
    fut = srv.submit("lm", np.arange(1, 6))
    try:
        assert tripped.wait(5.0), "watchdog missed its deadline"
        assert time.monotonic() - t0 < 5.0
        wd = engine.watchdog
        assert wd.trip_count == 1
        kind, reason, bundle = wd.trips[0]
        assert kind == "stall" and "live sequence" in reason
        files = set(os.listdir(bundle))
        assert {"stats.json", "dashboard.json", "stacks.txt",
                "ring.jsonl"} <= files
        lines = open(os.path.join(bundle, "ring.jsonl")).read().splitlines()
        assert json.loads(lines[0])["flight_recorder"]["name"] == "lm"
        assert len(lines) - 1 >= 5
        stacks = open(os.path.join(bundle, "stacks.txt")).read()
        assert "serve-decode-lm" in stacks and "wedged_step" in stacks
        assert Dashboard.snapshot()["WATCHDOG_TRIPS[lm]"]["value"] == 1
    finally:
        release.set()
    assert len(fut.result(timeout=60)["result"]) == 8
    engine._step_fn = orig_step
    assert engine.stats()["watchdog_trips"] == 1


def test_pool_drift_detector_on_real_engine(port):
    from multiverso_tpu_torch.serving import InferenceServer

    srv = InferenceServer("t")
    engine = srv.register_decoder("lm", _lm(), slots=2, max_prompt=8,
                                  max_new=4, watchdog=False)
    wd = EngineWatchdog(engine, WatchdogConfig(stall_s=30.0), start=False)
    out = srv.submit("lm", np.arange(1, 5)).result(timeout=60)
    assert len(out["result"]) == 4
    for _ in range(4):
        assert wd.check_once() == []
    assert engine.pool_drift() is None
    engine._pool.alloc(1)            # a reservation nothing owns
    engine._admitting = True         # ... unless an admission holds it
    assert engine.pool_drift() is None
    assert engine.health()["live_seqs"] == 1
    engine._admitting = False
    assert engine.health()["live_seqs"] == 0
    assert wd.check_once() == []
    fired = wd.check_once()
    assert len(fired) == 1
    assert "live block" in fired[0] and "zero live sequences" in fired[0]
    assert wd.trips[0][0] == "pool_drift"
