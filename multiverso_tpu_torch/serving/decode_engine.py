"""Continuous-batching decode engine: slot KV cache + iteration scheduling.

Counterpart of ``multiverso_tpu/serving/decode_engine.py`` for its
monolithic, contiguous configuration (``prefill_token_budget=0``,
``kv_block_size=0``): the Orca design of iteration-level scheduling over
a persistent slotted KV cache.

* **slots** — a slot is one in-flight sequence; the cache is one pair of
  contiguous strips ``[L, S, T, D]`` with ``T = max_prompt + max_new``.
* **monolithic admission** — each iteration admits as many queued
  prompts as there are free slots. Each arrival is right-padded to its
  prompt bucket and prefilled by :func:`models.transformer.prefill` (on
  the card, the flash kernel with ``attention="flash_force"``), its first
  token taken at its last real position, and its K/V inserted into its
  slot. The JAX engine prefills an admission group as one padded batch;
  here each arrival is its own ``[1, bucket]`` prefill, so a request's
  numbers never depend on which strangers it was admitted with (on the
  card the GEMM library picks its kernel by shape).
* **one fused step per iteration** — every iteration runs ONE
  :func:`models.transformer.decode_step` over all S slots, live or dead.
* **iteration-granular completion** — a slot frees the moment its
  sequence emits ``eos_id`` or reaches its per-request ``max_new``.

Snapshot pinning as in the JAX engine: an admission pins the current
params snapshot, and the pin only moves while no slot is live.

Every other feature of the JAX engine (chunked prefill, the paged KV
pool, prefix caching, tensor-parallel decode, speculative decoding, int8
KV or params, sequence-parallel prefill, preemption, the flight
recorder, the watchdog, latency SLOs and the cost ledger) is not ported
yet: turning one on raises :class:`~..log.FatalError` naming its flag.
The flag defaults stay the JAX package's, so callers of this engine pass
the values that turn them off.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from .. import trace
from ..dashboard import Dashboard
from ..log import Log
from .batcher import OverloadedError, bucket_for, shape_buckets
from .snapshot import SnapshotManager


@dataclass
class DecodeEngineConfig:
    slots: int = 8              # S: concurrent sequences (fused-step width)
    max_prompt: int = 64        # longest admissible prompt
    max_new: int = 32           # per-request cap AND default generation length
    eos_id: Optional[int] = None
    max_queue: int = 256        # admission queue depth before shedding
    max_staleness_s: float = 0.05
    # prompt pad buckets (powers of two up to max_prompt by default)
    prompt_buckets: Optional[Tuple[int, ...]] = None
    # the switches of the JAX engine's other features, None = the
    # matching flag; only the values that turn each feature off are
    # served by this port (their sub-knobs come with the features)
    prefill_token_budget: Optional[int] = None
    kv_block_size: Optional[int] = None
    decode_tp: Optional[int] = None
    prefix_cache: Optional[bool] = None
    prefill_sp: Optional[bool] = None
    spec_k: Optional[int] = None
    kv_quant: Optional[str] = None
    decode_param_quant: Optional[str] = None
    preempt: Optional[bool] = None
    flight_recorder: Optional[bool] = None
    watchdog: Optional[bool] = None
    slo_ttft_ms: Optional[float] = None
    slo_itl_ms: Optional[float] = None
    cost_ledger: Optional[bool] = None

    def _resolved(self, field: str):
        value = getattr(self, field)
        if value is None:
            from ..config import get_flag

            value = get_flag(field)
        return value

    def resolved_prompt_buckets(self) -> Tuple[int, ...]:
        if self.prompt_buckets:
            return tuple(self.prompt_buckets)
        return shape_buckets(self.max_prompt)

    def unported(self) -> List[str]:
        """``flag=value`` for every resolved setting that turns on a
        feature this port does not have."""
        on = []
        checks = (
            ("prefill_token_budget", lambda v: int(v) != 0),
            ("kv_block_size", lambda v: int(v) != 0),
            ("decode_tp", lambda v: int(v) != 1),
            ("prefix_cache", bool),
            ("spec_k", lambda v: int(v) != 0),
            ("kv_quant", lambda v: str(v) != "none"),
            ("decode_param_quant", lambda v: str(v) != "none"),
            ("prefill_sp", bool),
            ("preempt", bool),
            ("flight_recorder", bool),
            ("watchdog", bool),
            ("slo_ttft_ms", lambda v: float(v) > 0),
            ("slo_itl_ms", lambda v: float(v) > 0),
            ("cost_ledger", bool),
        )
        for field, is_on in checks:
            value = self._resolved(field)
            if is_on(value):
                on.append(f"{field}={value!r}")
        return on


class _Request:
    __slots__ = ("prompt", "max_new", "future", "t_enq", "t_last", "slot",
                 "out", "version", "ctx")

    def __init__(self, prompt: np.ndarray, max_new: int,
                 ctx: Optional[trace.SpanContext] = None) -> None:
        self.prompt = prompt
        self.max_new = max_new
        self.future: Future = Future()
        self.t_enq = time.monotonic()
        self.t_last = self.t_enq     # last token emission (ITL base)
        self.slot = -1
        self.out: List[int] = []
        self.version = -1
        self.ctx = ctx


class DecodeEngine:
    """One LM's continuous-batching decode loop.

    ``lm`` is a :class:`models.transformer.TransformerLM`; ``submit``
    enqueues a prompt and returns a Future resolving to
    ``{"result", "snapshot_version", "staleness_s"}`` where ``result`` is
    the generated id array (truncated at eos).
    """

    def __init__(self, name: str, lm,
                 config: Optional[DecodeEngineConfig] = None) -> None:
        from ..models import transformer

        self._tf = transformer
        self.name = name
        self.config = config or DecodeEngineConfig()
        ec = self.config
        cfg = lm.config
        self._model_cfg = cfg
        unported = ec.unported()
        if unported:
            Log.fatal(f"DecodeEngine {name!r}: not ported to "
                      f"multiverso_tpu_torch yet: {', '.join(unported)} "
                      f"(this engine serves prefill_token_budget=0, "
                      f"kv_block_size=0 with every other feature off)")
        if ec.max_prompt + ec.max_new > cfg.max_seq:
            Log.fatal(f"DecodeEngine {name!r}: max_prompt {ec.max_prompt} + "
                      f"max_new {ec.max_new} exceeds max_seq {cfg.max_seq}")
        self._prompt_buckets = ec.resolved_prompt_buckets()
        if self._prompt_buckets[-1] < ec.max_prompt:
            Log.fatal(f"DecodeEngine {name!r}: largest prompt bucket "
                      f"{self._prompt_buckets[-1]} < max_prompt "
                      f"{ec.max_prompt}")
        S = ec.slots
        L, D = cfg.n_layers, cfg.d_model
        T = ec.max_prompt + ec.max_new
        self.device = lm.device

        self._manager = SnapshotManager.of(lm, name=name)
        self._snap = None            # pinned while any slot is live
        self._pinned = None
        self.pin_copies = 0

        # -- device state (owned by the loop thread) --------------------------
        self._k_cache = torch.zeros((L, S, T, D), dtype=cfg.dtype,
                                    device=self.device)
        self._v_cache = torch.zeros_like(self._k_cache)
        # -- host state -------------------------------------------------------
        self._slot_req: List[Optional[_Request]] = [None] * S
        self._free_q: Deque[int] = collections.deque(range(S))
        self._tok = np.zeros(S, np.int64)
        self._pos = np.zeros(S, np.int64)
        self._active = np.zeros(S, bool)
        self._q: Deque[_Request] = collections.deque()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._stop = threading.Event()
        # -- stats ------------------------------------------------------------
        self.ttft_hist = Dashboard.get_or_create_histogram(
            f"SERVE_TTFT[{name}]")
        self.itl_hist = Dashboard.get_or_create_histogram(
            f"SERVE_ITL[{name}]")
        self.tps_gauge = Dashboard.get_or_create_gauge(f"DECODE_TPS[{name}]")
        self.occ_gauge = Dashboard.get_or_create_gauge(f"SLOT_OCC[{name}]")
        self.shed_counter = Dashboard.get_or_create_counter(
            f"SERVE_SHED[{name}]")
        self.steps_counter = Dashboard.get_or_create_counter(
            f"DECODE_STEPS[{name}]")
        self.prefill_tok_counter = Dashboard.get_or_create_counter(
            f"PREFILL_TOKENS[{name}]")
        self.decode_tok_counter = Dashboard.get_or_create_counter(
            f"DECODE_TOKENS[{name}]")
        self.iters_counter = Dashboard.get_or_create_counter(
            f"ENGINE_ITERS[{name}]")
        self.iters_total = 0
        self.completed = 0
        self.shed = 0
        self.tokens = 0
        self.prefill_tokens = 0
        self.peak_live = 0
        # host-clock seconds in admission (prefill + insert + first-token
        # readback) and in fused decode steps (dispatch to readback)
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.t_first: Optional[float] = None
        self._occ_sum = 0.0
        self._occ_n = 0
        self._thread = threading.Thread(
            target=self._loop, name=f"serve-decode-{name}", daemon=True)
        self._thread.start()

    # -- client side ----------------------------------------------------------
    def validate(self, prompt, max_new: Optional[int]) -> None:
        p = np.asarray(prompt, np.int64).ravel()
        if not 1 <= p.shape[0] <= self.config.max_prompt:
            raise ValueError(f"prompt length {p.shape[0]} outside "
                             f"[1, {self.config.max_prompt}]")
        if max_new is not None and not 1 <= int(max_new) <= self.config.max_new:
            raise ValueError(f"max_new {max_new} outside "
                             f"[1, {self.config.max_new}]")

    def submit(self, prompt, max_new: Optional[int] = None,
               ctx: Optional[trace.SpanContext] = None) -> Future:
        """Enqueue one prompt; fast-rejects with :class:`OverloadedError`
        at the admission-queue cap. ``ctx`` is the request's trace
        handoff token (or None)."""
        self.validate(prompt, max_new)
        p = np.asarray(prompt, np.int64).ravel()
        req = _Request(p, int(max_new or self.config.max_new), ctx)
        with self._cv:
            if self._stop.is_set():
                raise RuntimeError(f"decode engine {self.name!r} is stopped")
            if len(self._q) >= self.config.max_queue:
                self.shed += 1
                self.shed_counter.inc()
                raise OverloadedError(self.name, len(self._q),
                                      self.config.max_queue)
            if self.t_first is None:
                self.t_first = req.t_enq
            self._q.append(req)
            self._cv.notify()
        return req.future

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._q)

    # -- engine thread --------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cv:
                while (not self._q and not self._active.any()
                       and not self._stop.is_set()):
                    self._cv.wait()
                if self._stop.is_set() and not self._q \
                        and not self._active.any():
                    return
                arrivals: List[_Request] = []
                while len(arrivals) < len(self._free_q) and self._q:
                    arrivals.append(self._q.popleft())
            try:
                if arrivals:
                    t0 = time.monotonic()
                    self._admit(arrivals)
                    self.prefill_s += time.monotonic() - t0
                live = int(self._active.sum())
                self.peak_live = max(self.peak_live, live)
                if self._active.any():
                    t0 = time.monotonic()
                    self._step()
                    self.decode_s += time.monotonic() - t0
            except Exception as exc:          # pragma: no cover - defensive
                self._fail_all(exc, arrivals)
                return
            self.iters_total += 1
            self.iters_counter.inc()

    def _maybe_refresh(self) -> None:
        """Move the pinned snapshot only while no generation is live."""
        snap = self._snap
        if snap is None:
            snap = self._manager.current()
        elif not self._active.any():
            snap = self._manager.ensure_fresh(self.config.max_staleness_s)
        if snap is not self._snap:
            with trace.span("snapshot.pin", engine=self.name,
                            version=snap.version):
                # the snapshot is already a private copy on the model's
                # device: pinning it copies nothing more
                self._pinned = snap.value
            self.pin_copies += 1
            self._snap = snap

    @torch.no_grad()
    def _admit(self, arrivals: List[_Request]) -> None:
        t_admit = time.monotonic()
        self._maybe_refresh()
        version = self._snap.version
        cfg = self._model_cfg
        firsts = []
        buckets = []
        for req in arrivals:
            pb = bucket_for(len(req.prompt), self._prompt_buckets)
            toks = np.zeros((1, pb), np.int64)
            toks[0, : len(req.prompt)] = req.prompt
            slot = self._free_q.popleft()
            req.slot = slot
            logits, ks, vs = self._tf.prefill(
                cfg, self._pinned, torch.from_numpy(toks).to(self.device))
            lens = torch.tensor([len(req.prompt)], device=self.device)
            firsts.append(self._tf.first_tokens(logits, lens))
            self._tf.cache_insert(self._k_cache, self._v_cache, [slot], ks,
                                  vs)
            buckets.append(pb)
            self.prefill_tokens += len(req.prompt)
            self.prefill_tok_counter.inc(len(req.prompt))
        first = torch.cat(firsts).cpu().numpy()   # one sync per admission
        now = time.monotonic()
        tracing = trace.enabled()
        for i, req in enumerate(arrivals):
            tok0 = int(first[i])
            req.version = version
            req.t_last = now
            self.ttft_hist.record((now - req.t_enq) * 1e3)
            self.tokens += 1
            self.decode_tok_counter.inc()
            req.out.append(tok0)
            if tracing and req.ctx is not None:
                trace.record_span("queue.wait", req.ctx, req.t_enq, t_admit,
                                  cause="admission")
                trace.record_span(
                    "decode.admit", req.ctx, t_admit, now, slot=req.slot,
                    prompt_len=len(req.prompt), prompt_bucket=buckets[i],
                    snapshot_version=version)
            if self._finished(req, tok0):
                self._free_q.append(req.slot)
                self._resolve(req)
                continue
            self._slot_req[req.slot] = req
            self._tok[req.slot] = tok0
            self._pos[req.slot] = len(req.prompt)
            self._active[req.slot] = True

    @torch.no_grad()
    def _step(self) -> None:
        tracing = trace.enabled()
        t_it0 = time.monotonic()
        dev = self.device
        _, _, nxt, _ = self._tf.decode_step(
            self._model_cfg, self._pinned, self._k_cache, self._v_cache,
            torch.from_numpy(self._tok).to(dev),
            torch.from_numpy(self._pos).to(dev),
            torch.from_numpy(self._active).to(dev))
        nxt = nxt.cpu().numpy()       # the host sync point
        now = time.monotonic()
        self.steps_counter.inc()
        n_active = 0
        for s in range(self.config.slots):
            req = self._slot_req[s]
            if req is None:
                continue
            n_active += 1
            tok = int(nxt[s])
            self._pos[s] += 1
            self._tok[s] = tok
            req.out.append(tok)
            self.tokens += 1
            self.decode_tok_counter.inc()
            self.itl_hist.record((now - req.t_last) * 1e3)
            req.t_last = now
            if tracing and req.ctx is not None:
                trace.record_span("decode.iter", req.ctx, t_it0, now,
                                  slot=s, token_index=len(req.out))
            if self._finished(req, tok):
                self._active[s] = False
                self._slot_req[s] = None
                self._free_q.append(s)
                self._resolve(req)
        self._occ_sum += n_active / self.config.slots
        self._occ_n += 1
        self.occ_gauge.set(int(self._active.sum()) / self.config.slots)
        t_first = self.t_first
        if t_first is not None and now > t_first:
            self.tps_gauge.set(self.tokens / (now - t_first))

    def _finished(self, req: _Request, tok: int) -> bool:
        eos = self.config.eos_id
        return (eos is not None and tok == eos) or len(req.out) >= req.max_new

    def _resolve(self, req: _Request) -> None:
        self.completed += 1
        if req.future.set_running_or_notify_cancel():
            req.future.set_result({
                "result": np.asarray(req.out, np.int32),
                "snapshot_version": req.version,
                "staleness_s": self._manager.staleness_s(self._snap),
            })

    def _fail_all(self, exc: Exception,
                  in_flight: Optional[List[_Request]] = None) -> None:
        with self._cv:
            self._stop.set()
            pending = list(self._q)
            self._q.clear()
        live = [r for r in self._slot_req if r is not None]
        self._active[:] = False
        self._slot_req = [None] * self.config.slots
        self._free_q = collections.deque(range(self.config.slots))
        seen = set()
        for req in pending + live + (in_flight or []):
            if id(req) in seen or req.future.done():
                continue
            seen.add(id(req))
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(exc)

    # -- introspection --------------------------------------------------------
    def stats(self) -> dict:
        t_first = self.t_first
        elapsed = (time.monotonic() - t_first) if t_first else 0.0
        ttft = self.ttft_hist.percentiles((50, 99))
        itl = self.itl_hist.percentiles((50, 99))
        issued = self.completed + self.shed
        busy = self.prefill_s + self.decode_s
        return {
            "kv_block_size": 0,
            "prefill_token_budget": 0,
            "pin_copies": self.pin_copies,
            "iters_total": self.iters_total,
            "peak_live_seqs": self.peak_live,
            "completed": self.completed,
            "shed": self.shed,
            "shed_rate": self.shed / issued if issued else 0.0,
            "tokens": self.tokens,
            "tokens_per_s": self.tokens / elapsed if elapsed > 0 else 0.0,
            "ttft_p50_ms": ttft[50],
            "ttft_p99_ms": ttft[99],
            "itl_p50_ms": itl[50],
            "itl_p99_ms": itl[99],
            "slot_occupancy": (self._occ_sum / self._occ_n
                               if self._occ_n else 0.0),
            "active_slots": int(self._active.sum()),
            "queue_depth": self.queue_depth(),
            "snapshot_publishes": self._manager.publishes,
            "prefill_tokens": self.prefill_tokens,
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "prefill_share": self.prefill_s / busy if busy > 0 else 0.0,
        }

    # -- lifecycle ------------------------------------------------------------
    def stop(self) -> None:
        """Drain queued + in-flight generations, then retire the loop."""
        with self._cv:
            self._stop.set()
            self._cv.notify_all()
        self._thread.join(timeout=600)
