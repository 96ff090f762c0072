"""The port's per-tenant cost ledger against the JAX package's.

``multiverso_tpu_torch.serving.accounting`` and the engine's charge
sites, on the CPU:

* the same event sequence gives the JAX ``CostLedger``'s ``tenants()``,
  totals, ``stats()``, heartbeat rows and drift, field for field, at any
  cost weights and through the ``-tenant_max`` fold into ``~other``;
* a port engine and a JAX engine serving the same tenant-tagged requests
  one at a time bill the same integer aggregates;
* conservation under preemption churn, with and without speculation, and
  a shed request billed under its tenant;
* the tenant rides the ``mvserve`` wire (and an absent one decodes as
  None), and reaches ``FleetRouter.replica_rows()`` through heartbeats.
"""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from multiverso_tpu.serving import accounting as jacct
from multiverso_tpu_torch.serving import accounting as tacct

WEIGHTS = [
    {"cost_token": 1.0, "cost_token_ms": 0.0, "cost_block_byte_s": 0.0,
     "cost_xfer_byte": 0.0},
    {"cost_token": 2.0, "cost_token_ms": 0.5, "cost_block_byte_s": 0.001,
     "cost_xfer_byte": 0.25},
]
SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=48)


@pytest.fixture(autouse=True)
def _clean_dashboards():
    from multiverso_tpu.dashboard import Dashboard as JaxDashboard
    from multiverso_tpu_torch.dashboard import Dashboard

    Dashboard.reset()
    JaxDashboard.reset()
    yield
    Dashboard.reset()
    JaxDashboard.reset()


def _ledger(mod, **kw):
    base = dict(default_tenant="default", max_tenants=8,
                weights=WEIGHTS[0], slo_lat_ms=0.0)
    base.update(kw)
    return mod.CostLedger("lm", **base)


def _events(seed, n=60):
    """One tenant-tagged event sequence: (tenant, vector fields, outcome,
    latency), with some direct transfer charges between them."""
    rng = np.random.default_rng(seed)
    names = ("acme", "globex", "initech", None, "", " hooli ", "umbrella",
             "wayne", "stark", "tyrell", "cyberdyne")
    out = []
    for i in range(n):
        t = names[int(rng.integers(0, len(names)))]
        fields = dict(
            prefill_tokens=int(rng.integers(0, 64)),
            prefill_tokens_saved=int(rng.integers(0, 16)),
            decode_tokens=int(rng.integers(0, 32)),
            xfer_bytes=int(rng.integers(0, 4096)),
            kv_block_s=float(rng.random()),
            device_step_ms=float(rng.random() * 10),
            queue_wait_ms=float(rng.random()),
            recompute_tokens=int(rng.integers(0, 8)),
            preemptions=int(rng.integers(0, 3)))
        outcome = jacct.OUTCOMES[int(rng.integers(0, 4))]
        charge = int(rng.integers(0, 2048)) if i % 7 == 3 else 0
        out.append((t, fields, outcome, float(rng.random() * 50), charge))
    return out


def _play(led, events):
    costs = []
    for t, fields, outcome, lat, charge in events:
        u = led.usage(t)
        for k, v in fields.items():
            setattr(u, k, v)
        costs.append(led.finalize(u, outcome, lat_ms=lat))
        if charge:
            led.charge(t, xfer_bytes=charge)
    return costs


@pytest.mark.parametrize("weights", [0, 1])
@pytest.mark.parametrize("max_tenants", [3, 64])
def test_same_events_give_the_jax_ledger(weights, max_tenants):
    events = _events(7 + weights)
    kw = dict(block_bytes=1024, weights=WEIGHTS[weights],
              max_tenants=max_tenants)
    port, ref = _ledger(tacct, **kw), _ledger(jacct, **kw)
    assert _play(port, events) == _play(ref, events)
    assert port.tenants() == ref.tenants()
    assert port.totals.as_dict() == ref.totals.as_dict()
    assert port.stats() == ref.stats()
    assert port.heartbeat_rows() == ref.heartbeat_rows()
    assert port.heartbeat_rows(limit=2) == ref.heartbeat_rows(limit=2)
    assert port.tenant_count() == ref.tenant_count()
    mirror = [sum(f[k] for _, f, _, _, _ in events)
              for k in ("prefill_tokens", "decode_tokens", "xfer_bytes")]
    mirror[2] += sum(c for *_, c in events)
    assert port.drift(*mirror) == ref.drift(*mirror) == 0
    if max_tenants == 3:
        assert tacct.OVERFLOW_TENANT in port.tenants()
    port.reset()
    ref.reset()
    assert port.tenants() == ref.tenants() == {}
    assert port.stats() == ref.stats()


def test_canonicalization_and_late_fold():
    led = _ledger(tacct, default_tenant="anon")
    assert led.usage(None).tenant == led.usage("  ").tenant == "anon"
    assert led.usage("  acme ").tenant == "acme"
    led2 = _ledger(tacct, max_tenants=2)
    u_c = led2.usage("c")             # the table is empty: canonical
    u_c.decode_tokens = 3
    for t in ("a", "b"):
        led2.finalize(led2.usage(t), "completed")
    led2.finalize(u_c, "completed")   # the table filled meanwhile
    assert led2.tenants()[tacct.OVERFLOW_TENANT]["decode_tokens"] == 3
    assert led2.drift(0, 3, 0) == 0
    with pytest.raises(ValueError):
        led.finalize(led.usage("a"), "exploded")
    with pytest.raises(ValueError):
        _ledger(tacct, max_tenants=0)


def test_reset_keeps_the_monotonic_counters():
    from multiverso_tpu_torch.dashboard import Dashboard

    led = tacct.CostLedger("e", default_tenant="default", max_tenants=8,
                           weights=WEIGHTS[0], slo_lat_ms=25.0)
    for t, toks in (("acme", 10), ("globex", 4)):
        u = led.usage(t)
        u.decode_tokens = toks
        led.finalize(u, "completed", lat_ms=5.0)
    c = Dashboard.get_or_create_counter("TENANT_DECODE_TOKENS[e.acme]")
    assert c.get() == 10
    assert Dashboard.get_or_create_gauge("TENANT_SLO_MS[e]").get() == 25.0
    assert led.heartbeat_rows(limit=1) == {"acme": 10.0}
    led.reset()
    assert led.tenants() == {} and led.tenant_count() == 0
    assert c.get() == 10
    u = led.usage("acme")
    u.decode_tokens = 3
    led.finalize(u, "completed")
    assert c.get() == 13


# -- engines ------------------------------------------------------------------

@pytest.fixture()
def port():
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.runtime import Session

    Session._instance = None
    mv.init(["test", "-device=cpu", "-log_level=error"])
    # one torch thread: under the suite's parallel workers a full pool
    # of threads per engine starves the replicas' heartbeat threads
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield mv
    torch.set_num_threads(threads)
    mv.shutdown()
    Session._instance = None
    mv.set_flag("device", "cuda")


def _server(pkg, **kw):
    if pkg == "port":
        from multiverso_tpu_torch.models.transformer import (
            TransformerConfig, TransformerLM)
        from multiverso_tpu_torch.serving import InferenceServer
    else:
        from multiverso_tpu.models.transformer import (TransformerConfig,
                                                       TransformerLM)
        from multiverso_tpu.serving import InferenceServer
    srv = InferenceServer("t")
    engine = srv.register_decoder("lm", TransformerLM(TransformerConfig(
        **SMALL)), **kw)
    engine.warmup()
    return srv, engine


INT_FIELDS = ("requests", "completed", "shed", "deadline", "failed",
              "prefill_tokens", "prefill_tokens_saved", "decode_tokens",
              "xfer_bytes", "recompute_tokens", "preemptions")


def test_engine_bills_what_the_jax_engine_bills(port, mv_session):
    """The same tenant-tagged requests, one at a time (so the schedule is
    the same), on a port and a JAX engine with the prefix cache: equal
    integer aggregates per tenant, token costs included."""
    rng = np.random.default_rng(3)
    repeat = rng.integers(1, 64, 8).astype(np.int32)
    reqs = []
    for i in range(10):
        prompt = repeat if i % 3 == 0 else rng.integers(
            1, 64, int(rng.integers(1, 9))).astype(np.int32)
        reqs.append({"prompt": prompt, "max_new": int(rng.integers(2, 9)),
                     "tenant": ("acme", "globex", None)[i % 3]})
    kw = dict(slots=2, max_prompt=8, max_new=8, kv_block_size=4,
              prefill_token_budget=4, watchdog=False, cost_ledger=True)
    rows = {}
    for pkg in ("port", "jax"):
        srv, engine = _server(pkg, **kw)
        try:
            for r in reqs:
                srv.submit("lm", {k: v for k, v in r.items()
                                  if v is not None}).result(timeout=120)
            rows[pkg] = {t: {f: a[f] for f in INT_FIELDS + ("cost",)}
                         for t, a in engine.ledger.tenants().items()}
            st = engine.stats()
            assert st["accounting_drift"] == 0
        finally:
            srv.stop()
    assert rows["port"] == rows["jax"]
    assert set(rows["port"]) == {"acme", "globex", "default"}
    assert sum(a["prefill_tokens_saved"] for a in rows["port"].values()) > 0


@pytest.mark.parametrize("spec_k", [0, 2])
def test_engine_conservation_under_preemption_churn(port, spec_k):
    """An 8-block pool under 4 slots forces preemption with recompute;
    repeats full-hit the prefix cache; speculation adds windows. Drift is
    0 at quiescence, the per-tenant sums equal the engine's mirrors, and
    the ledger adds no program signature."""
    srv, engine = _server(
        "port", slots=4, max_prompt=8, max_new=16, kv_block_size=4,
        kv_pool_blocks=8, prefill_token_budget=4, prefix_cache=True,
        spec_k=spec_k, max_queue=64, cost_ledger=True)
    try:
        rng = np.random.default_rng(23)
        tenants = ("acme", "globex", "initech", None)
        repeat = rng.integers(1, 64, 6).astype(np.int32)
        futs = []
        for i in range(18):
            prompt = (repeat if i % 3 == 0 else rng.integers(
                1, 64, int(rng.integers(1, 9))).astype(np.int32))
            payload = {"prompt": prompt, "max_new": int(rng.integers(6, 17))}
            if tenants[i % 4] is not None:
                payload["tenant"] = tenants[i % 4]
            futs.append(srv.submit("lm", payload))
        for fut in futs:
            fut.result(timeout=180)
        stats = engine.stats()
        assert stats["preemptions"] > 0, "the pool never ran short"
        assert stats["accounting_drift"] == 0
        assert stats["step_traces"] == stats["prefill_traces"] == 1
        assert stats["completed"] == len(futs)
        if spec_k:
            assert stats["spec_proposed"] > 0
        led = engine.ledger
        seen = led.tenants()
        assert set(seen) == {"acme", "globex", "initech", "default"}
        assert stats["tenants_live"] == 4
        vals = seen.values()
        assert sum(a["prefill_tokens"] for a in vals) == \
            stats["prefill_tokens"]
        assert sum(a["decode_tokens"] for a in vals) == stats["tokens"]
        assert sum(a["prefill_tokens_saved"] for a in vals) == \
            stats["prefill_tokens_saved"]
        assert sum(a["completed"] for a in vals) == stats["completed"]
        assert sum(a["preemptions"] for a in vals) == stats["preemptions"]
        assert led.totals.recompute_tokens > 0
        assert led.totals.device_step_ms > 0.0
        assert led.totals.kv_block_s > 0.0
        assert stats["tenant_cost_units"] == pytest.approx(
            stats["prefill_tokens"] + stats["tokens"])
        hb = engine.health()["tenants"]
        assert set(hb) <= set(seen) and len(hb) == 4
        recs = engine.recorder.records()
        assert recs and recs[-1]["tenants_live"] == 4
        assert all(r["kv_block_s"] >= 0.0 for r in recs)
    finally:
        srv.stop()


def test_shed_is_billed_and_the_ledger_off_surface_is_unchanged(port):
    from multiverso_tpu_torch.serving import OverloadedError

    srv, engine = _server("port", slots=2, max_prompt=8, max_new=16,
                          kv_block_size=4, kv_pool_blocks=4, preempt=False,
                          cost_ledger=True)
    try:
        with pytest.raises(OverloadedError):
            srv.submit("lm", {"prompt": np.arange(1, 9, dtype=np.int32),
                              "max_new": 16, "tenant": "acme"})
        agg = engine.ledger.tenants()["acme"]
        assert agg["requests"] == 1 and agg["shed"] == 1
        assert agg["prefill_tokens"] == agg["decode_tokens"] == 0
        assert engine.stats()["accounting_drift"] == 0
    finally:
        srv.stop()
    srv, engine = _server("port", slots=2, max_prompt=8, max_new=4)
    try:
        srv.submit("lm", {"prompt": np.arange(1, 5, dtype=np.int32),
                          "max_new": 2, "tenant": "acme"}).result(timeout=60)
        assert engine.ledger is None
        st = engine.stats()
        for key in ("tenants_live", "tenant_cost_units", "tenant_requests",
                    "accounting_drift"):
            assert key not in st
        assert "tenants" not in engine.health()
        # the reply resolves inside an iteration, its record lands at the
        # iteration's end: wait for it
        deadline = time.monotonic() + 30
        while not engine.recorder.records() and time.monotonic() < deadline:
            time.sleep(0.01)
        rec = engine.recorder.records()[-1]
        assert rec["tenants_live"] == -1 and rec["kv_block_s"] == -1.0
    finally:
        srv.stop()


# -- the wire -----------------------------------------------------------------

class _KV:
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


class _ClassicEngine:
    """A pre-tenant engine surface (3-argument submit)."""

    def __init__(self):
        self.submits = 0

    def submit(self, prompt, max_new=None, ctx=None):
        self.submits += 1
        f = Future()
        p = np.asarray(prompt, np.int32)
        out = ((p[-1] + 1 + np.arange(max_new or 4)) % 64).astype(np.int32)
        f.set_result({"result": out, "snapshot_version": 1,
                      "staleness_s": 0.0})
        return f

    def health(self):
        return {"queue_depth": 0, "live_seqs": 0,
                "tenants": {"acme": 3.0}}

    def stats(self):
        return {"submits": self.submits}

    def stop(self):
        pass


class _TenantRecordingEngine(_ClassicEngine):
    def __init__(self):
        super().__init__()
        self.seen = []

    def submit(self, prompt, max_new=None, ctx=None, priority=None,
               deadline_s=None, tenant=None):
        self.seen.append(tenant)
        return super().submit(prompt, max_new, ctx)


def _fleet(label, engines):
    from multiverso_tpu_torch.serving import (FleetConfig, FleetRouter,
                                              ReplicaServer)

    kv = _KV()
    size = len(engines) + 1
    router = FleetRouter(size, kv, label=label, name=label,
                         fleet_config=FleetConfig(heartbeat_ms=50,
                                                  deadline_s=30.0))
    replicas = [ReplicaServer(r + 1, size, kv, engines[r], label=label,
                              heartbeat_ms=50) for r in range(len(engines))]
    deadline = time.monotonic() + 20
    while router.stats()["up"] < len(engines):
        assert time.monotonic() < deadline, router.replica_rows()
        time.sleep(0.01)
    return router, replicas


@pytest.mark.parametrize("engine", ["tenant", "classic"])
def test_tenant_rides_the_wire_and_reaches_replica_rows(engine):
    """A tagged submit delivers the tenant and an untagged one puts no
    key on the wire (the engine sees None); a pre-tenant engine still
    serves a tagged request; heartbeat ``tenants`` rows reach
    ``replica_rows``."""
    eng = _TenantRecordingEngine() if engine == "tenant" else \
        _ClassicEngine()
    router, replicas = _fleet(f"acct_{engine}", [eng])
    try:
        prompt = np.arange(1, 4, dtype=np.int32)
        router.predict(prompt, 2, tenant="acme")
        router.predict(prompt, 2)
        if engine == "tenant":
            assert eng.seen == ["acme", None]
        assert eng.submits == 2
        deadline = time.monotonic() + 5
        while not router.replica_rows()[0]["tenants"]:
            assert time.monotonic() < deadline, router.replica_rows()
            time.sleep(0.01)
        assert router.replica_rows()[0]["tenants"] == {"acme": 3.0}
        assert router.stats()["requests_lost"] == 0
    finally:
        router.stop()
        for rep in replicas:
            rep.stop()
