"""Request router: named models -> micro-batchers or decode engines.

Counterpart of ``multiverso_tpu/serving/server.py``. ``register``
attaches a workload (``serving/workloads.py``) behind a
:class:`MicroBatcher` and a :class:`SnapshotManager`: a flush takes one
snapshot decision for the whole batch and stamps every reply with the
snapshot version and its staleness. ``register_decoder`` attaches a
continuous-batching :class:`DecodeEngine`. ``submit`` routes a payload to
either and returns a Future; ``stop`` drains and retires everything. A
started session registers the server, so ``shutdown()`` stops serving.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Union

from .. import trace
from ..log import Log
from .batcher import BatcherConfig, MicroBatcher
from .decode_engine import DecodeEngine, DecodeEngineConfig
from .snapshot import SnapshotManager

# payload keys of the JAX server whose features this port does not have
_UNPORTED_PAYLOAD_KEYS = ("tenant",)


class _DecoderEntry:
    def __init__(self, name: str, engine: DecodeEngine) -> None:
        self.name = name
        self.engine = engine

    def submit(self, payload: Any,
               ctx: Optional[trace.SpanContext] = None) -> Future:
        """Payload: a 1-D prompt id array, or a dict with ``prompt`` and
        the optional per-request ``max_new``, ``priority`` (class 0..7)
        and ``deadline_s``."""
        if isinstance(payload, dict):
            if "prompt" not in payload:
                raise ValueError("decoder payload dict needs a 'prompt' key")
            for key in _UNPORTED_PAYLOAD_KEYS:
                if payload.get(key) is not None:
                    Log.fatal(f"serving: payload key {key!r} is not ported "
                              f"to multiverso_tpu_torch yet")
            return self.engine.submit(
                payload["prompt"], payload.get("max_new"), ctx=ctx,
                priority=payload.get("priority"),
                deadline_s=payload.get("deadline_s"))
        return self.engine.submit(payload, ctx=ctx)


class _ModelEntry:
    """A micro-batched workload: one batcher, one snapshot manager."""

    def __init__(self, name: str, workload, manager: SnapshotManager,
                 batcher_cfg: BatcherConfig, max_staleness_s: float) -> None:
        self.name = name
        self.workload = workload
        self.manager = manager
        self.max_staleness_s = float(max_staleness_s)
        self.batcher = MicroBatcher(name, self._run, batcher_cfg)

    def _run(self, payloads: List[Any], bucket: int) -> List[dict]:
        # one freshness decision per flush: every reply of the batch comes
        # from the same snapshot, at most max_staleness_s stale
        snap = self.manager.ensure_fresh(self.max_staleness_s)
        staleness = self.manager.staleness_s(snap)
        results = self.workload.run(payloads, bucket, snap)
        return [{"result": r, "snapshot_version": snap.version,
                 "staleness_s": staleness} for r in results]


_Entry = Union[_ModelEntry, _DecoderEntry]


class InferenceServer:
    """Batched low-latency inference over live parameter state."""

    def __init__(self, name: str = "serving") -> None:
        self.name = name
        self._models: Dict[str, _Entry] = {}
        self._lock = threading.Lock()
        self._stopped = False
        from ..runtime import Session

        sess = Session.get()
        if sess.started:
            sess.register_server(self)

    def register(self, name: str, workload, max_batch: int = 32,
                 deadline_ms: float = 2.0, max_queue: int = 256,
                 max_staleness_s: float = 0.05,
                 buckets: Optional[tuple] = None) -> None:
        """Attach a workload under ``name``: it exposes ``source`` (a table
        or model with the snapshot contract, or a ``(read, version_fn)``
        pair), ``run(payloads, bucket, snap)`` and optionally
        ``validate(payload)``. ``max_batch``/``deadline_ms`` set the flush
        triggers, ``max_queue`` the shed threshold, ``max_staleness_s``
        the snapshot refresh bound; the ``-slo_lat_ms`` flag sets the
        reply-latency SLO."""
        cfg = BatcherConfig(max_batch=max_batch, deadline_ms=deadline_ms,
                            max_queue=max_queue, buckets=buckets)
        manager = SnapshotManager.of(workload.source, name=name)
        with self._lock:
            if self._stopped:
                Log.fatal(f"serving: register({name!r}) on a stopped "
                          f"server")
            if name in self._models:
                Log.fatal(f"serving: model {name!r} already registered")
            self._models[name] = _ModelEntry(
                name, workload, manager, cfg, max_staleness_s)
        Log.info("serving: model %r up (max_batch %d, deadline %.1f ms, "
                 "queue cap %d)", name, max_batch, deadline_ms, max_queue)

    def register_decoder(self, name: str, lm, *, slots: int = 8,
                         max_prompt: int = 64, max_new: int = 32,
                         eos_id: Optional[int] = None, max_queue: int = 256,
                         max_staleness_s: float = 0.05,
                         prompt_buckets: Optional[tuple] = None,
                         prefill_token_budget: Optional[int] = None,
                         kv_block_size: Optional[int] = None,
                         kv_pool_blocks: Optional[int] = None,
                         decode_tp: Optional[int] = None,
                         prefix_cache: Optional[bool] = None,
                         prefill_sp: Optional[bool] = None,
                         spec_k: Optional[int] = None,
                         kv_quant: Optional[str] = None,
                         decode_param_quant: Optional[str] = None,
                         preempt: Optional[bool] = None,
                         preempt_budget: Optional[int] = None,
                         sched_lookahead: Optional[int] = None,
                         flight_recorder: Optional[bool] = None,
                         watchdog: Optional[bool] = None,
                         debug_dump_dir: Optional[str] = None,
                         slo_ttft_ms: Optional[float] = None,
                         slo_itl_ms: Optional[float] = None,
                         cost_ledger: Optional[bool] = None
                         ) -> DecodeEngine:
        """Attach a continuous-batching decode engine under ``name``. The
        arguments are the JAX server's knobs, plus ``flight_recorder``
        (None = the matching flag; the defaults serve chunked, paged,
        prefix-cached and preemptive admission with the recorder and the
        watchdog on, see :mod:`.decode_engine`). ``spec_k`` > 0 turns on
        speculative decoding, ``kv_quant="int8"`` int8 KV pools and
        ``decode_param_quant="int8"`` int8 parameter pins (all three need
        the paged KV cache where JAX does); ``slo_ttft_ms``/``slo_itl_ms``
        > 0 register the latency SLOs. The features this port does not
        have yet (``decode_tp``, ``prefill_sp``, ``cost_ledger``) raise
        :class:`~..log.FatalError` when their resolved value turns them
        on."""
        cfg = DecodeEngineConfig(
            slots=slots, max_prompt=max_prompt, max_new=max_new,
            eos_id=eos_id, max_queue=max_queue,
            max_staleness_s=max_staleness_s, prompt_buckets=prompt_buckets,
            prefill_token_budget=prefill_token_budget,
            kv_block_size=kv_block_size, kv_pool_blocks=kv_pool_blocks,
            decode_tp=decode_tp, prefix_cache=prefix_cache,
            prefill_sp=prefill_sp, spec_k=spec_k, kv_quant=kv_quant,
            decode_param_quant=decode_param_quant, preempt=preempt,
            preempt_budget=preempt_budget, sched_lookahead=sched_lookahead,
            flight_recorder=flight_recorder, watchdog=watchdog,
            debug_dump_dir=debug_dump_dir, slo_ttft_ms=slo_ttft_ms,
            slo_itl_ms=slo_itl_ms, cost_ledger=cost_ledger)
        with self._lock:
            if self._stopped:
                Log.fatal(f"serving: register_decoder({name!r}) on a "
                          f"stopped server")
            if name in self._models:
                Log.fatal(f"serving: model {name!r} already registered")
        entry = _DecoderEntry(name, DecodeEngine(name, lm, cfg))
        with self._lock:
            raced = name in self._models
            stopped = self._stopped
            if not raced and not stopped:
                self._models[name] = entry
        if raced or stopped:
            entry.engine.stop()
            Log.fatal(f"serving: model {name!r} already registered" if raced
                      else f"serving: server stopped during decoder "
                           f"{name!r} registration")
        Log.info("serving: decoder %r up (%d slots, max_prompt %d, "
                 "max_new %d)", name, slots, max_prompt, max_new)
        return entry.engine

    def _entry(self, name: str) -> _Entry:
        with self._lock:
            entry = self._models.get(name)
        if entry is None:
            Log.fatal(f"serving: unknown model {name!r} "
                      f"(registered: {sorted(self._models)})")
        return entry

    def submit(self, model: str, payload: Any) -> Future:
        """Enqueue one request; raises :class:`OverloadedError` at the
        queue-depth cap and ``ValueError`` for a malformed payload (a
        workload's ``validate`` runs here, so a bad request never reaches
        a batch). The future resolves to ``{"result", "snapshot_version",
        "staleness_s"}``. With tracing on, each request gets a root span
        ``serve.request``."""
        entry = self._entry(model)
        root = trace.start_span("serve.request", root=True, model=model)
        try:
            if isinstance(entry, _DecoderEntry):
                fut = entry.submit(payload, ctx=root.context)
            else:
                validate = getattr(entry.workload, "validate", None)
                if validate is not None:
                    validate(payload)
                fut = entry.batcher.submit(payload, ctx=root.context)
        except Exception as exc:
            root.end(error=type(exc).__name__)
            raise
        if root is not trace.NULL_SPAN:
            fut.add_done_callback(lambda f, sp=root: sp.end(
                ok=(not f.cancelled()) and f.exception() is None))
        return fut

    def predict(self, model: str, payload: Any,
                timeout_s: float = 30.0) -> dict:
        return self.submit(model, payload).result(timeout=timeout_s)

    def stats(self, model: str) -> dict:
        entry = self._entry(model)
        if isinstance(entry, _DecoderEntry):
            return entry.engine.stats()
        return {**entry.batcher.stats(),
                "snapshot_publishes": entry.manager.publishes,
                "queue_depth": entry.batcher.queue_depth()}

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def stop(self) -> None:
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            entries = list(self._models.values())
        for entry in entries:
            if isinstance(entry, _DecoderEntry):
                entry.engine.stop()
            else:
                entry.batcher.stop()
