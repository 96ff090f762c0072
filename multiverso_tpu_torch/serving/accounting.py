"""Per-tenant cost attribution: the request-level resource ledger.

Counterpart of ``multiverso_tpu/serving/accounting.py``: the same
vector, aggregates, cost fold and cardinality cap, so the same event
sequence gives the same ``tenants()``.

The metering substrate under quotas/showback (docs/OBSERVABILITY.md
"Tenant accounting"): every request carries a :class:`ResourceUsage`
vector that the engine fills in at its EXISTING instrumentation points
— queue wait, prefill tokens computed vs saved by the prefix cache,
decode tokens (speculative acceptances included), KV-block-seconds
(reserved blocks x wall, integrated per iteration), device step
milliseconds attributed by active-lane share, KV transfer bytes, and
preemption recompute tokens — and :meth:`CostLedger.finalize` folds at
completion into per-tenant rolling aggregates.

Design constraints (both load-bearing, both tested):

* **Pure host state.** The ledger is dicts and floats on the engine
  loop thread — no tensor, no device work. Attaching it cannot add a
  program signature (``step_traces`` stays 1, retraces 0).
* **Exact.** Every integer field increments at the IDENTICAL code
  site as the engine's own global mirror, attributed through
  ``req.usage`` — so the conservation identity holds to the token:
  sum over tenants of prefill/decode/xfer equals the engine's
  ``prefill_tokens``/``tokens``/``xfer_bytes`` exactly, whatever the
  churn (preemption-with-recompute, speculative windows, full-hit
  admissions, deadline drops, engine failure). ``drift()`` computes
  the residual; the bench gates it at zero (``accounting_drift``).

Cardinality is bounded the ``SHED_BY_CLASS[name.pN]`` way: per-tenant
Dashboard instruments (``TENANT_*[engine.tenant]``) are created lazily
on first use, and once ``-tenant_max`` distinct tenants exist, every
new tenant id folds into the :data:`OVERFLOW_TENANT` bucket — a hostile
or buggy client cannot balloon the metrics surface. The monotonic
counters ride obs-plane reports unchanged (``ObsCollector.tenant_rows``
merges them fleet-wide); the resettable aggregates back ``stats()`` and
``reset_stats()`` like every other engine mirror.

The cost model is a configurable linear fold of the vector
(``-cost_token``, ``-cost_token_ms``, ``-cost_block_byte_s``,
``-cost_xfer_byte``): with the defaults, one cost unit == one token,
so cost is deterministic and reconcilable; weights let a deployment
price device time and KV residency instead.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ..dashboard import Dashboard

# the fold bucket for tenant ids past the -tenant_max cardinality cap:
# "~" sorts after every sane tenant id and cannot collide with one (ids
# are stripped; the engine never invents it for a real tenant)
OVERFLOW_TENANT = "~other"

# terminal outcomes finalize() accepts (anything else raises — an
# unknown outcome is an attribution bug, not a new category)
OUTCOMES = ("completed", "shed", "deadline", "failed")


class ResourceUsage:
    """One request's resource vector (host-only, engine-thread-owned).

    Integer fields mirror engine counters 1:1 (the conservation
    identity); float fields are wall-clock attributions. ``t_wait0``
    is the open queue-wait clock base — set at submit, re-armed at
    preemption requeue, closed into ``queue_wait_ms`` at admission."""

    __slots__ = ("tenant", "queue_wait_ms", "prefill_tokens",
                 "prefill_tokens_saved", "decode_tokens", "kv_block_s",
                 "device_step_ms", "xfer_bytes", "recompute_tokens",
                 "preemptions", "t_wait0")

    def __init__(self, tenant: str) -> None:
        self.tenant = tenant
        self.queue_wait_ms = 0.0
        self.prefill_tokens = 0
        self.prefill_tokens_saved = 0
        self.decode_tokens = 0
        self.kv_block_s = 0.0
        self.device_step_ms = 0.0
        self.xfer_bytes = 0
        self.recompute_tokens = 0
        self.preemptions = 0
        self.t_wait0 = time.monotonic()

    def vector(self) -> Dict[str, Any]:
        """The schema'd dict form (trace spans, tests, docs)."""
        return {"tenant": self.tenant,
                "queue_wait_ms": self.queue_wait_ms,
                "prefill_tokens": self.prefill_tokens,
                "prefill_tokens_saved": self.prefill_tokens_saved,
                "decode_tokens": self.decode_tokens,
                "kv_block_s": self.kv_block_s,
                "device_step_ms": self.device_step_ms,
                "xfer_bytes": self.xfer_bytes,
                "recompute_tokens": self.recompute_tokens,
                "preemptions": self.preemptions}


class _TenantAgg:
    """One tenant's resettable rolling aggregate (the stats() mirror —
    the monotonic ``TENANT_*`` Dashboard counters are the obs-plane
    twin, folded at the same finalize)."""

    __slots__ = ("requests", "completed", "shed", "deadline", "failed",
                 "queue_wait_ms", "prefill_tokens",
                 "prefill_tokens_saved", "decode_tokens", "kv_block_s",
                 "device_step_ms", "xfer_bytes", "recompute_tokens",
                 "preemptions", "cost")

    def __init__(self) -> None:
        self.requests = 0
        self.completed = 0
        self.shed = 0
        self.deadline = 0
        self.failed = 0
        self.queue_wait_ms = 0.0
        self.prefill_tokens = 0
        self.prefill_tokens_saved = 0
        self.decode_tokens = 0
        self.kv_block_s = 0.0
        self.device_step_ms = 0.0
        self.xfer_bytes = 0
        self.recompute_tokens = 0
        self.preemptions = 0
        self.cost = 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {s: getattr(self, s) for s in self.__slots__}


class CostLedger:
    """Per-engine tenant accounting (host state only — see module doc).

    The engine owns one when ``-cost_ledger`` is on and calls in from
    its existing instrumentation sites; everything here is dict/float
    arithmetic cheap enough for the iteration path. Thread-safety:
    attribution happens on the engine loop thread; ``finalize``/
    ``charge``/``reset``/readers take the ledger lock (submit-time
    sheds and stats() readers run on client threads)."""

    def __init__(self, engine: str, *, block_bytes: int = 0,
                 default_tenant: Optional[str] = None,
                 max_tenants: Optional[int] = None,
                 weights: Optional[Dict[str, float]] = None,
                 slo_lat_ms: Optional[float] = None) -> None:
        from .. import config
        self.engine = engine
        # per-block K/V bytes (paged engines): what turns kv_block_s
        # into byte-seconds under the -cost_block_byte_s weight
        self.block_bytes = int(block_bytes)
        self.default_tenant = str(
            default_tenant if default_tenant is not None
            else config.get_flag("default_tenant")) or "default"
        self.max_tenants = int(
            max_tenants if max_tenants is not None
            else config.get_flag("tenant_max"))
        if self.max_tenants < 1:
            raise ValueError(f"tenant_max must be >= 1, "
                             f"got {self.max_tenants}")
        w = dict(weights) if weights is not None else {
            "cost_token": float(config.get_flag("cost_token")),
            "cost_token_ms": float(config.get_flag("cost_token_ms")),
            "cost_block_byte_s": float(
                config.get_flag("cost_block_byte_s")),
            "cost_xfer_byte": float(config.get_flag("cost_xfer_byte"))}
        self.weights = w
        self._lock = threading.Lock()
        self._agg: Dict[str, _TenantAgg] = {}
        # lazy keyed Dashboard instruments, one bundle per tenant
        # (bounded by max_tenants + the overflow bucket)
        self._instruments: Dict[str, Dict[str, Any]] = {}
        # the global twin of the per-tenant sums: folded ONLY at
        # finalize()/charge() — the same calls, the same amounts — so
        # sum-over-tenants == totals holds by construction (float
        # fields included)
        self.totals = _TenantAgg()
        # the per-request latency SLO the fleet tenant table breaches
        # against (0 = none); published as a gauge so tenant_rows()
        # finds it next to the TENANT_LAT_MS buckets it merges
        slo = float(slo_lat_ms if slo_lat_ms is not None
                    else config.get_flag("slo_lat_ms"))
        self.slo_lat_ms = slo
        if slo > 0:
            Dashboard.get_or_create_gauge(
                f"TENANT_SLO_MS[{engine}]").set(slo)

    # -- attribution (engine instrumentation sites) -------------------------
    def usage(self, tenant: Optional[str]) -> ResourceUsage:
        """A fresh per-request vector for ``tenant`` (None/empty ->
        the default tenant). Cardinality folds happen here, once, so
        every later touch of the vector is a plain attribute add."""
        return ResourceUsage(self._canon(tenant))

    def _canon(self, tenant: Optional[str]) -> str:
        t = str(tenant).strip() if tenant is not None else ""
        if not t:
            t = self.default_tenant
        with self._lock:
            if t in self._agg or len(self._agg) < self.max_tenants:
                return t
        return OVERFLOW_TENANT

    def charge_iteration(self, reqs: List[Any], dt_s: float) -> None:
        """Integrate KV residency over one engine iteration: each
        admitted request is charged ``len(req.blocks) * dt_s``
        block-seconds (``reqs`` are engine ``_Request``s carrying
        ``usage``/``blocks``). Loop thread only; no lock — the per-
        request vectors are loop-thread-owned until finalize."""
        if dt_s <= 0.0:
            return
        for req in reqs:
            u = req.usage
            if u is not None and req.blocks:
                u.kv_block_s += len(req.blocks) * dt_s

    def charge_step(self, reqs: List[Any], step_ms: float) -> None:
        """Attribute one fused step's wall clock by active-lane share:
        each live sequence pays ``step_ms / n_live`` device
        milliseconds (the co-batching cost model — a lane consumed the
        step whether it accepted one token or a speculative window)."""
        live = [r.usage for r in reqs if r.usage is not None]
        if not live or step_ms <= 0.0:
            return
        share = step_ms / len(live)
        for u in live:
            u.device_step_ms += share

    def charge(self, tenant: Optional[str], *, xfer_bytes: int = 0) -> None:
        """Direct tenant charge for resources not tied to a live
        request (today: splice-side KV transfer bytes — a payload
        arrives and warms the pool before any submit exists). Lands in
        the aggregate immediately, same amounts as the engine's
        ``xfer_bytes`` mirror site, so conservation holds."""
        if not xfer_bytes:
            return
        with self._lock:
            t = self._canon_locked(tenant)
            agg = self._agg_for(t)
            agg.xfer_bytes += int(xfer_bytes)
            self.totals.xfer_bytes += int(xfer_bytes)
            b = self._bundle(t)
        b["xfer"].inc(int(xfer_bytes))

    # -- finalize -----------------------------------------------------------
    def finalize(self, usage: ResourceUsage, outcome: str,
                 lat_ms: Optional[float] = None) -> float:
        """Fold one finished request's vector into its tenant's
        aggregates (resettable mirror + monotonic Dashboard counters +
        latency histogram) and return its cost units. ``outcome`` is
        one of :data:`OUTCOMES`; ``lat_ms`` (completed requests) feeds
        the per-tenant latency buckets the fleet SLO-breach fraction
        reads."""
        if outcome not in OUTCOMES:
            raise ValueError(f"unknown outcome {outcome!r}")
        cost = self.cost_of(usage)
        with self._lock:
            tenant = usage.tenant
            if tenant not in self._agg \
                    and len(self._agg) >= self.max_tenants:
                # late fold: the tenant was canonical at submit but the
                # table filled while this request ran
                tenant = OVERFLOW_TENANT
            agg = self._agg_for(tenant)
            agg.requests += 1
            setattr(agg, outcome, getattr(agg, outcome) + 1)
            agg.queue_wait_ms += usage.queue_wait_ms
            agg.prefill_tokens += usage.prefill_tokens
            agg.prefill_tokens_saved += usage.prefill_tokens_saved
            agg.decode_tokens += usage.decode_tokens
            agg.kv_block_s += usage.kv_block_s
            agg.device_step_ms += usage.device_step_ms
            agg.xfer_bytes += usage.xfer_bytes
            agg.recompute_tokens += usage.recompute_tokens
            agg.preemptions += usage.preemptions
            agg.cost += cost
            t = self.totals
            t.requests += 1
            setattr(t, outcome, getattr(t, outcome) + 1)
            t.queue_wait_ms += usage.queue_wait_ms
            t.prefill_tokens += usage.prefill_tokens
            t.prefill_tokens_saved += usage.prefill_tokens_saved
            t.decode_tokens += usage.decode_tokens
            t.kv_block_s += usage.kv_block_s
            t.device_step_ms += usage.device_step_ms
            t.xfer_bytes += usage.xfer_bytes
            t.recompute_tokens += usage.recompute_tokens
            t.preemptions += usage.preemptions
            t.cost += cost
            b = self._bundle(tenant)
        # monotonic obs-plane twins OUTSIDE the ledger lock (Dashboard
        # instruments have their own locks; lock-order hygiene)
        b["requests"].inc()
        if usage.prefill_tokens:
            b["prefill"].inc(usage.prefill_tokens)
        if usage.decode_tokens:
            b["decode"].inc(usage.decode_tokens)
        if usage.xfer_bytes:
            b["xfer"].inc(usage.xfer_bytes)
        if usage.kv_block_s:
            b["block_s"].inc(usage.kv_block_s)
        if cost:
            b["cost"].inc(cost)
        if lat_ms is not None:
            b["lat"].record(lat_ms)
        return cost

    def cost_of(self, usage: ResourceUsage) -> float:
        """The linear cost fold (docs/OBSERVABILITY.md "Tenant
        accounting"): tokens, device milliseconds, KV byte-seconds,
        and transfer bytes, each under its ``-cost_*`` weight."""
        w = self.weights
        return (w["cost_token"] * (usage.prefill_tokens
                                   + usage.decode_tokens)
                + w["cost_token_ms"] * usage.device_step_ms
                + w["cost_block_byte_s"] * usage.kv_block_s
                * self.block_bytes
                + w["cost_xfer_byte"] * usage.xfer_bytes)

    # -- internals ----------------------------------------------------------
    def _canon_locked(self, tenant: Optional[str]) -> str:
        t = str(tenant).strip() if tenant is not None else ""
        if not t:
            t = self.default_tenant
        if t in self._agg or len(self._agg) < self.max_tenants:
            return t
        return OVERFLOW_TENANT

    def _agg_for(self, tenant: str) -> _TenantAgg:
        agg = self._agg.get(tenant)
        if agg is None:
            agg = self._agg[tenant] = _TenantAgg()
        return agg

    def _bundle(self, tenant: str) -> Dict[str, Any]:
        """Lazy per-tenant Dashboard instruments (the SHED_BY_CLASS
        pattern): created on a tenant's first finalize, cached, keyed
        ``TENANT_*[engine.tenant]`` so obs-plane reports ship them and
        ``tenant_rows()`` can split the key back apart."""
        b = self._instruments.get(tenant)
        if b is None:
            key = f"{self.engine}.{tenant}"
            b = self._instruments[tenant] = {
                "requests": Dashboard.get_or_create_counter(
                    f"TENANT_REQUESTS[{key}]"),
                "prefill": Dashboard.get_or_create_counter(
                    f"TENANT_PREFILL_TOKENS[{key}]"),
                "decode": Dashboard.get_or_create_counter(
                    f"TENANT_DECODE_TOKENS[{key}]"),
                "xfer": Dashboard.get_or_create_counter(
                    f"TENANT_XFER_BYTES[{key}]"),
                "block_s": Dashboard.get_or_create_counter(
                    f"TENANT_KV_BLOCK_S[{key}]"),
                "cost": Dashboard.get_or_create_counter(
                    f"TENANT_COST[{key}]"),
                "lat": Dashboard.get_or_create_histogram(
                    f"TENANT_LAT_MS[{key}]"),
            }
        return b

    # -- read side ----------------------------------------------------------
    def tenant_count(self) -> int:
        """Live tenant cardinality (cheap: the flight recorder reads
        it every iteration)."""
        with self._lock:
            return len(self._agg)

    def tenants(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant aggregate dicts (the resettable window)."""
        with self._lock:
            return {t: agg.as_dict() for t, agg in self._agg.items()}

    def drift(self, prefill_tokens: int, decode_tokens: int,
              xfer_bytes: int) -> int:
        """The conservation residual against the engine's own mirrors:
        |sum over tenants - engine counter| over the integer fields.
        Zero whenever every consumed token/byte was attributed AND
        finalized (the bench reads it at quiescence; a mid-flight read
        legitimately shows the live requests' unfinalized usage)."""
        with self._lock:
            pf = sum(a.prefill_tokens for a in self._agg.values())
            dc = sum(a.decode_tokens for a in self._agg.values())
            xf = sum(a.xfer_bytes for a in self._agg.values())
        return (abs(pf - int(prefill_tokens))
                + abs(dc - int(decode_tokens))
                + abs(xf - int(xfer_bytes)))

    def heartbeat_rows(self, limit: int = 8) -> Dict[str, float]:
        """Top-``limit`` tenants by cost, for replica heartbeat rows
        (small by construction — the wire stays bounded even at the
        cardinality cap)."""
        with self._lock:
            items = sorted(self._agg.items(),
                           key=lambda kv: -kv[1].cost)[: limit]
            return {t: round(a.cost, 3) for t, a in items}

    def stats(self) -> Dict[str, Any]:
        """The engine ``stats()`` contribution (gated on the ledger,
        so off-ledger engines' stats stay byte-identical)."""
        with self._lock:
            return {"tenants_live": len(self._agg),
                    "tenant_cost_units": round(self.totals.cost, 6),
                    "tenant_requests": self.totals.requests}

    def reset(self) -> None:
        """Zero the resettable window (``reset_stats`` sibling): per-
        tenant aggregates and totals; the monotonic TENANT_* counters
        keep counting (MetricsExporter-rate contract), and latency
        histograms reset like the engine's own."""
        with self._lock:
            self._agg.clear()
            self.totals = _TenantAgg()
            hists = [b["lat"] for b in self._instruments.values()]
        for h in hists:
            h.reset()
