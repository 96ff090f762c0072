"""Continuous-batching decode engine: slot KV cache + iteration scheduling.

Counterpart of ``multiverso_tpu/serving/decode_engine.py`` at the JAX
package's default flags and in its A/B baselines: the Orca design of
iteration-level scheduling over a persistent KV cache, with

* **slots**: a slot is one in-flight sequence; the live set is an
  ``active`` lanes vector, and every iteration runs ONE fused decode step
  over all S slots, live or dead (:func:`models.transformer.decode_step`
  or :func:`~models.transformer.decode_step_paged`).
* **the paged KV cache** (``kv_block_size``, default 16): one block pool
  ``[L, n_blocks + 1, block_size, D]`` per K and V plus per-slot block
  tables ``[S, M]`` (``serving/block_pool.py`` keeps the books). A
  request whose ``prompt + max_new`` can never fit the pool sheds at
  submit. ``kv_block_size=0`` keeps the contiguous ``[L, S, T, D]``
  strips, ``T = max_prompt + max_new``.
* **chunked admission** (``prefill_token_budget``, default 32): an
  arriving prompt prefills in fixed-size chunks straight into its slot,
  at most one chunk per iteration beside the fused step, so a long
  prompt delays the live generations by one chunk of work an iteration.
  The first token falls out of the final chunk. ``prefill_token_budget=0``
  keeps monolithic admission: each arrival is its own ``[1, bucket]``
  whole-prompt :func:`~models.transformer.prefill` (the JAX engine pads
  an admission group into one batch; one request per prefill keeps a
  request's numbers independent of its neighbours on the card, where the
  GEMM library picks its kernel by shape), then its K/V is inserted.
* **prefix caching** (``prefix_cache``, paged + chunked only): every full
  block a prefill writes is registered under a hash chain seeded by the
  pinned snapshot version; an arriving prompt splices the longest cached
  prefix into its table and prefills from the first uncached token. A
  fully cached prompt goes live at ``P - 1`` after one copy-on-write of
  its last block, and its first token falls out of the next step.
* **priorities, deadlines and preemption** (``preempt``, paged + chunked
  only): requests carry a ``priority`` class (0-7) and an optional
  ``deadline_s``; the queue is a set of per-class lanes under a stride
  scheduler with bounded lookahead, and an expired request is dropped at
  pop time, before any prefill. Admission reserves the prompt's blocks
  only and grows at decode time; on pool exhaustion the lowest-priority,
  youngest sequence is preempted (its blocks decref tail first) and
  recomputes from ``prompt + emitted tokens`` on re-admission. A
  per-request preemption budget and the rule that the oldest live
  sequence is never preempted keep it from livelocking.
* **the flight recorder and the watchdog** (on by default): one record
  per iteration into a ring, and a thread that trips on a stall, a
  queue-age breach or pool drift (``serving/watchdog.py``).
* **speculative decoding** (``spec_k``, default 0 = off; paged only): a
  host-side n-gram prompt-lookup drafter (:class:`_PromptLookup`)
  proposes up to ``spec_k`` tokens per live slot from the sequence's own
  history, and one :func:`~models.transformer.verify_step_paged` scores
  the ``[S, spec_k + 1]`` window. Greedy verification accepts the longest
  drafted prefix that matches the window's argmax chain plus one
  correction token, so the tokens are plain greedy decode's. Drafts clamp
  to ``remaining - 1``, so a window never writes past the request's
  reservation; an iteration without drafts runs the plain step.
* **int8 KV** (``kv_quant="int8"``; paged only): int8 pools with one fp32
  scale per (layer, block), the scales ``[L, N]`` tensors passed to every
  program beside the block tables (the ``_q`` programs of
  ``models/transformer.py``).
* **int8 parameter pins** (``decode_param_quant="int8"``): the pin
  quantizes on the host once per snapshot version
  (``snapshot.quantize_decode_params``; ``pin_copies`` counts it), the
  int8 copy stays resident, and every program dequantizes it at its top
  (``models.transformer.dequantize_decode_params``).
* **latency SLOs** (``slo_ttft_ms``/``slo_itl_ms`` > 0): windowed p99
  objectives over ``SERVE_TTFT[name]``/``SERVE_ITL[name]`` in
  ``Dashboard.snapshot()``.
* **disaggregated prefill/decode** (prefix-cache engines only,
  :attr:`DecodeEngine.supports_transfer`): :meth:`DecodeEngine.submit_prefill`
  chunk-prefills a prompt and resolves with its full blocks fetched to
  the host as a :mod:`.kv_transfer` payload; :meth:`DecodeEngine.splice`
  hands a received payload to the loop, which writes its blocks into
  the pool between iterations and registers them, so the follow-up
  admission of the same prompt is a full prefix hit.
* **per-tenant cost accounting** (``cost_ledger``): each request carries
  a :class:`.accounting.ResourceUsage` filled at the engine's own
  instrumentation sites and folded into its tenant's
  :class:`.accounting.CostLedger` row when it resolves.

The JAX engine's one-compiled-trace-per-program invariant has no compiler
here; its counterpart is :class:`_Program`, which records the distinct
shape/dtype signatures of each program's tensor arguments. Block tables,
positions, slot, offset and length are tensors of fixed shape, so every
program keeps one signature per engine config (``step_cache_size()``,
``prefill_cache_size()``; a monolithic engine has one per prompt bucket).
The block tables' device copy is uploaded only on an iteration that
changed the host mirror. Per iteration the host reads the step's next
tokens (a verify window's ``[S, spec_k + 1]`` tokens instead) and, on a
prompt's final chunk, its first token.

Snapshot pinning as in the JAX engine: an admission pins the current
params snapshot; the pin only moves while nothing is in flight and no
preempted request waits to resume.

Not ported yet, each raising :class:`~..log.FatalError` by name:
``decode_tp`` and ``prefill_sp`` (the distributed paths).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import trace
from ..dashboard import Dashboard
from . import accounting, kv_transfer
from ..log import Log
from .batcher import (DeadlineExceededError, OverloadedError, bucket_for,
                      shape_buckets)
from .block_pool import SCRATCH_BLOCK, BlockPool, chain_hashes, \
    kv_bytes_per_block
from .flight_recorder import FlightRecorder
from .snapshot import SnapshotManager, quantize_decode_params
from .watchdog import EngineWatchdog, WatchdogConfig


@dataclass
class DecodeEngineConfig:
    slots: int = 8              # S: concurrent sequences (fused-step width)
    max_prompt: int = 64        # longest admissible prompt
    max_new: int = 32           # per-request cap AND default generation length
    eos_id: Optional[int] = None
    max_queue: int = 256        # admission queue depth before shedding
    max_staleness_s: float = 0.05
    # prompt pad buckets (monolithic admission only; powers of two up to
    # max_prompt by default)
    prompt_buckets: Optional[Tuple[int, ...]] = None
    # None = the matching flag, for every knob below
    prefill_token_budget: Optional[int] = None   # 0 = monolithic
    kv_block_size: Optional[int] = None          # 0 = contiguous strips
    kv_pool_blocks: Optional[int] = None         # <= 0 = slots * M
    prefix_cache: Optional[bool] = None          # paged + chunked only
    preempt: Optional[bool] = None               # paged + chunked only
    preempt_budget: Optional[int] = None
    sched_lookahead: Optional[int] = None
    flight_recorder: Optional[bool] = None
    flight_recorder_capacity: Optional[int] = None
    watchdog: Optional[bool] = None
    watchdog_interval_s: Optional[float] = None
    watchdog_stall_s: Optional[float] = None
    watchdog_queue_age_s: Optional[float] = None
    debug_dump_dir: Optional[str] = None
    spec_k: Optional[int] = None                 # 0 = no speculation
    kv_quant: Optional[str] = None               # "none" or "int8"
    decode_param_quant: Optional[str] = None     # "none" or "int8"
    slo_ttft_ms: Optional[float] = None          # <= 0 = no SLO
    slo_itl_ms: Optional[float] = None
    cost_ledger: Optional[bool] = None           # per-tenant accounting
    # the JAX engine's features this port does not have yet; only the
    # values that turn each off are served
    decode_tp: Optional[int] = None
    prefill_sp: Optional[bool] = None

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

    def resolved_kv_pool_blocks(self, blocks_per_seq: int) -> int:
        n = int(self._resolved("kv_pool_blocks"))
        if n <= 0:                   # auto: contiguous-equivalent capacity
            n = self.slots * blocks_per_seq
        return n

    def resolved_watchdog_config(self) -> WatchdogConfig:
        return WatchdogConfig(
            interval_s=float(self._resolved("watchdog_interval_s")),
            stall_s=float(self._resolved("watchdog_stall_s")),
            queue_age_s=float(self._resolved("watchdog_queue_age_s")),
            dump_dir=str(self._resolved("debug_dump_dir")))

    def unported(self) -> List[str]:
        """``flag=value`` for every resolved setting that turns on a
        feature this port does not have."""
        on = []
        checks = (
            ("decode_tp", lambda v: int(v) != 1),
            ("prefill_sp", bool),
        )
        for field, is_on in checks:
            value = self._resolved(field)
            if is_on(value):
                on.append(f"{field}={value!r}")
        return on


class _Program:
    """One serving program and the distinct signatures (shape, dtype and
    device of each tensor argument; the value of each Python scalar) it
    was called with: the counterpart of the JAX engine's compiled-trace
    count. Parameter dicts are not part of the signature."""

    def __init__(self, fn) -> None:
        self.fn = fn
        self.signatures: set = set()

    def __call__(self, *args):
        sig = []
        for a in args:
            if isinstance(a, torch.Tensor):
                sig.append((tuple(a.shape), a.dtype, a.device.type))
            elif not isinstance(a, dict):
                sig.append((type(a).__name__, a))
        self.signatures.add(tuple(sig))
        return self.fn(*args)

    def cache_size(self) -> int:
        return len(self.signatures)


def _signatures(fn) -> int:
    size = getattr(fn, "cache_size", None)
    return size() if size is not None else 0


# process-unique small request ids: the flight recorder's admitted/
# completed columns join ring records to requests
_RIDS = itertools.count(1)

# prompt-lookup n-gram width: the drafter keys on the sequence's last
# _SPEC_NGRAM tokens (the JAX engine's value)
_SPEC_NGRAM = 2

# chain hashes a heartbeat advertises at most (the JAX engine's cap)
_CHAIN_ADVERT_CAP = 256


class _PromptLookup:
    """Per-slot n-gram prompt-lookup index (Saxena, "Prompt Lookup
    Decoding"): every :data:`_SPEC_NGRAM`-gram of the sequence so far
    (prompt + emitted tokens) maps to the position right after its most
    recent earlier occurrence. A proposal reads what followed the last
    time the current tail was seen. The tail n-gram is indexed only once
    a later token gives it a continuation, so a proposal never matches
    itself. Host state only, extended incrementally per emitted token."""

    __slots__ = ("toks", "index")

    def __init__(self) -> None:
        self.toks: List[int] = []
        self.index: dict = {}

    def extend(self, tokens) -> None:
        """Append tokens; each gives the n-gram ending just before it a
        continuation."""
        for t in tokens:
            p = len(self.toks)
            self.toks.append(int(t))
            if p >= _SPEC_NGRAM:
                self.index[tuple(self.toks[p - _SPEC_NGRAM: p])] = p

    def propose(self, limit: int) -> List[int]:
        """Up to ``limit`` draft tokens continuing the current tail, or
        ``[]`` when the tail n-gram has no earlier occurrence. When the
        matched continuation runs out before ``limit`` (a cycle shorter
        than the window), the tail of sequence + draft is looked up
        again, so a period-2 loop still fills a window of 4."""
        if limit <= 0 or len(self.toks) < _SPEC_NGRAM:
            return []
        out: List[int] = []
        key = tuple(self.toks[-_SPEC_NGRAM:])
        while len(out) < limit:
            start = self.index.get(key)
            if start is None:
                break
            take = self.toks[start: start + (limit - len(out))]
            if not take:
                break
            out.extend(take)
            key = tuple((list(key) + take)[-_SPEC_NGRAM:])
        return out


# priority classes 0..7, higher = more important; the stride scheduler
# weights class p by 2**p, so every non-empty class keeps a positive share
MAX_PRIORITY = 7
DEFAULT_PRIORITY = 1


class _PrioQueue:
    """Per-priority FIFO lanes under a stride (weighted-fair) scheduler.

    Each decision picks the non-empty lane with the smallest pass value
    and advances it by ``1 / 2**p``; ties go to the higher class, and an
    idle lane re-activates at the current frontier. Within a lane order
    is FIFO, except that a block-starved head lets up to ``lookahead``
    younger requests of its lane pass it (each bypass counts a skip on
    the head; at ``lookahead`` skips all admission freezes until it
    fits), and a preempted request re-enters at the FRONT of its lane
    (:meth:`appendleft`). Expired-deadline requests are dropped when the
    scan touches them and handed back to the caller. Callers hold the
    engine lock."""

    def __init__(self, name: str, lookahead: int) -> None:
        self._name = name
        self._lookahead = int(lookahead)
        self._lanes: Dict[int, Deque["_Request"]] = {}
        self._passes: Dict[int, float] = {}
        self._gauges: Dict[int, object] = {}
        self._n = 0
        # queued requests preempted mid-generation: while any wait, the
        # engine holds its snapshot pin (the resume recomputes under the
        # first life's params)
        self.n_resumed = 0

    def __len__(self) -> int:
        return self._n

    def _gauge(self, p: int):
        g = self._gauges.get(p)
        if g is None:
            g = Dashboard.get_or_create_gauge(
                f"QUEUE_DEPTH[{self._name}.p{p}]")
            self._gauges[p] = g
        return g

    def _min_pass(self) -> float:
        active = [self._passes[p] for p, lane in self._lanes.items()
                  if lane]
        return min(active) if active else 0.0

    def _charge(self, p: int) -> None:
        self._passes[p] += 1.0 / (1 << min(p, MAX_PRIORITY))

    def _add(self, req: "_Request", front: bool) -> None:
        lane = self._lanes.get(req.priority)
        if lane is None:
            lane = self._lanes[req.priority] = collections.deque()
            self._passes.setdefault(req.priority, 0.0)
        if not lane:
            self._passes[req.priority] = max(
                self._passes[req.priority], self._min_pass())
        (lane.appendleft if front else lane.append)(req)
        self._n += 1
        if req.resumed:
            self.n_resumed += 1
        self._gauge(req.priority).set(float(len(lane)))

    def _removed(self, req: "_Request") -> "_Request":
        self._n -= 1
        if req.resumed:
            self.n_resumed -= 1
        return req

    def append(self, req: "_Request") -> None:
        self._add(req, front=False)

    def appendleft(self, req: "_Request") -> None:
        """Preempted re-enqueue: the front of the request's lane."""
        self._add(req, front=True)

    def oldest_t_enq(self) -> Optional[float]:
        heads = [lane[0].t_enq for lane in self._lanes.values() if lane]
        return min(heads) if heads else None

    def pop_admissible(self, now: float, covers):
        """One scheduling decision: ``(request or None, expired)``;
        ``covers(req)`` is the admission gate (block coverage)."""
        expired: List["_Request"] = []

        def dead(r: "_Request") -> bool:
            return r.deadline is not None and r.deadline <= now

        def sweep(p) -> None:
            lane = self._lanes[p]
            while lane and dead(lane[0]):
                expired.append(self._removed(lane.popleft()))

        thresh = self._lookahead if self._lookahead > 0 else 1
        order = sorted((p for p, lane in self._lanes.items() if lane),
                       key=lambda p: (self._passes[p], -p))
        for p in list(order):
            sweep(p)
        # a head at its bypass bound freezes every other admission
        starved = [p for p in order
                   if self._lanes[p] and self._lanes[p][0].skips >= thresh]
        scan = starved or [p for p in order if self._lanes[p]]
        frozen = bool(starved)
        checked: List["_Request"] = []   # heads found non-coverable
        try:
            for p in scan:
                lane = self._lanes[p]
                head = lane[0]
                if covers(head):
                    self._removed(lane.popleft())
                    self._charge(p)
                    for h in checked:
                        h.skips += 1
                    return head, expired
                checked.append(head)
                if frozen or self._lookahead <= 0 \
                        or head.skips >= self._lookahead:
                    continue
                i, scanned = 1, 0
                while i < len(lane) and scanned < self._lookahead:
                    cand = lane[i]
                    if dead(cand):
                        del lane[i]
                        expired.append(self._removed(cand))
                        continue
                    scanned += 1
                    if covers(cand):
                        del lane[i]
                        self._removed(cand)
                        self._charge(p)
                        for h in checked:
                            h.skips += 1
                        return cand, expired
                    i += 1
            return None, expired
        finally:
            for p in order:
                self._gauge(p).set(float(len(self._lanes[p])))

    def drain(self) -> List["_Request"]:
        """Remove and return everything (the failure path)."""
        out: List["_Request"] = []
        for p, lane in self._lanes.items():
            out.extend(lane)
            lane.clear()
            self._gauge(p).set(0.0)
        self._n = 0
        self.n_resumed = 0
        return out


class _Request:
    __slots__ = ("prompt", "max_new", "future", "t_enq", "t_last", "slot",
                 "out", "version", "ctx", "pf_off", "pf_chunks", "t_admit",
                 "blocks", "rid", "hashes", "hash_seed", "n_hit",
                 "full_hit", "saved", "pf_reg", "ttft_pending", "priority",
                 "deadline", "preempts", "resumed", "skips", "prompt0",
                 "drafter", "pf_only", "known", "xfer", "tenant", "usage")

    def __init__(self, prompt: np.ndarray, max_new: int,
                 ctx: Optional[trace.SpanContext] = None,
                 priority: int = DEFAULT_PRIORITY,
                 deadline: Optional[float] = None,
                 tenant: Optional[str] = None) -> None:
        self.rid = next(_RIDS)
        self.prompt = prompt
        self.max_new = max_new
        self.future: Future = Future()
        self.t_enq = time.monotonic()
        self.t_last = self.t_enq     # last token emission (ITL base)
        self.slot = -1
        self.out: List[int] = []
        self.version = -1
        self.blocks: List[int] = []  # paged: the reservation's block ids
        self.ctx = ctx
        # chunked prefill: next chunk's offset, chunks run, admission time
        self.pf_off = 0
        self.pf_chunks = 0
        self.t_admit = 0.0
        # prefix caching: the prompt's hash chain (memoized per seed),
        # blocks matched at admission, whether the whole prompt was
        # cached, prefill tokens skipped, prompt blocks registered so far,
        # and whether the next step's token is the request's first
        self.hashes: Optional[List[bytes]] = None
        self.hash_seed: Optional[bytes] = None
        self.n_hit = 0
        self.full_hit = False
        self.saved = 0
        self.pf_reg = 0
        self.ttft_pending = False
        # overload scheduling: class, absolute monotonic deadline, times
        # preempted, whether a preemption interrupted emitted output,
        # lookahead bypasses at the lane head, and the original prompt
        # (``prompt`` grows to prompt0 + emitted tokens on preemption)
        self.priority = int(priority)
        self.deadline = deadline
        self.preempts = 0
        self.resumed = False
        self.skips = 0
        self.prompt0 = prompt
        # speculative decoding: the slot's prompt-lookup index (None on
        # spec_k=0 engines; made at admission)
        self.drafter: Optional[_PromptLookup] = None
        # disaggregated serving: a prefill-only admission resolves with a
        # transfer payload instead of tokens; ``known`` are the hex chain
        # hashes the receiver already holds (shipped as metadata only);
        # ``xfer`` is the splice accounting that warmed this prompt
        self.pf_only = False
        self.known: frozenset = frozenset()
        self.xfer: Optional[Dict[str, int]] = None
        # accounting: the tenant id (None = the ledger's default) and the
        # resource vector (None on ledger-off engines)
        self.tenant = tenant
        self.usage: Optional[accounting.ResourceUsage] = None


class DecodeEngine:
    """One LM's continuous-batching decode loop.

    ``lm`` is a :class:`models.transformer.TransformerLM`; ``submit``
    enqueues a prompt and returns a Future resolving to
    ``{"result", "snapshot_version", "staleness_s"}`` where ``result`` is
    the generated id array (truncated at eos). The device state lives on
    ``lm.device``.
    """

    def __init__(self, name: str, lm,
                 config: Optional[DecodeEngineConfig] = None) -> None:
        from ..models import transformer as tf

        self._tf = tf
        self.name = name
        self.config = config or DecodeEngineConfig()
        ec = self.config
        cfg = lm.config
        self._model_cfg = cfg
        unported = ec.unported()
        if unported:
            Log.fatal(f"DecodeEngine {name!r}: not ported to "
                      f"multiverso_tpu_torch yet: {', '.join(unported)}")
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
        self._cache_len = T = ec.max_prompt + ec.max_new
        self.device = lm.device

        # -- paged KV geometry -----------------------------------------------
        self._block_size = int(ec._resolved("kv_block_size"))
        if self._block_size < 0:
            Log.fatal(f"DecodeEngine {name!r}: negative kv_block_size "
                      f"{self._block_size}")
        self._paged = self._block_size > 0
        self._pool: Optional[BlockPool] = None
        self._blocks_per_seq = 0
        if self._paged:
            self._blocks_per_seq = -(-T // self._block_size)
            self._pool = BlockPool(
                ec.resolved_kv_pool_blocks(self._blocks_per_seq),
                self._block_size, name=name)
            # host mirror [S, M] (all-scratch rows until an admission
            # installs its reservation) and its device copy, uploaded on
            # the iterations that changed the mirror
            self._block_tables = np.full((S, self._blocks_per_seq),
                                         SCRATCH_BLOCK, np.int64)
            self._bt_dev = torch.zeros((S, self._blocks_per_seq),
                                       dtype=torch.int64, device=self.device)
            self._bt_dirty = False
        self.table_uploads = 0

        # -- admission knobs -------------------------------------------------
        self._budget = int(ec._resolved("prefill_token_budget"))
        if self._budget < 0:
            Log.fatal(f"DecodeEngine {name!r}: negative "
                      f"prefill_token_budget {self._budget}")
        # a chunk never needs more than the longest admissible prompt
        self._budget = min(self._budget, ec.max_prompt)
        chunked = self._budget > 0
        # prefix caching and preemption need paged blocks AND chunked
        # prefill; they are inert otherwise, as in the JAX engine
        self._prefix = (self._paged and chunked
                        and bool(ec._resolved("prefix_cache")))
        self._hash_seed = b""        # pinned-version scope for the chain
        self._preempt_on = (self._paged and chunked
                            and bool(ec._resolved("preempt")))
        self._preempt_budget = int(ec._resolved("preempt_budget"))
        if self._preempt_budget < 0:
            Log.fatal(f"DecodeEngine {name!r}: negative preempt_budget "
                      f"{self._preempt_budget}")
        self._lookahead = int(ec._resolved("sched_lookahead"))
        if self._lookahead < 0:
            Log.fatal(f"DecodeEngine {name!r}: negative sched_lookahead "
                      f"{self._lookahead}")

        # -- int8 KV pools, int8 parameter pins, speculation -----------------
        self._kv_quant_mode = str(ec._resolved("kv_quant"))
        if self._kv_quant_mode not in ("none", "int8"):
            Log.fatal(f"DecodeEngine {name!r}: kv_quant must be 'none' or "
                      f"'int8', got {self._kv_quant_mode!r}")
        self._kv_quant = self._kv_quant_mode == "int8"
        if self._kv_quant and not self._paged:
            Log.fatal(f"DecodeEngine {name!r}: kv_quant=int8 needs the "
                      f"paged KV cache (kv_block_size > 0): the scales are "
                      f"per block")
        self._param_quant = str(ec._resolved("decode_param_quant"))
        if self._param_quant not in ("none", "int8"):
            Log.fatal(f"DecodeEngine {name!r}: decode_param_quant must be "
                      f"'none' or 'int8', got {self._param_quant!r}")
        self._spec = int(ec._resolved("spec_k"))
        if self._spec < 0:
            Log.fatal(f"DecodeEngine {name!r}: negative spec_k "
                      f"{self._spec}")
        if self._spec and not self._paged:
            Log.fatal(f"DecodeEngine {name!r}: spec_k={self._spec} needs "
                      f"the paged KV cache (kv_block_size > 0): the verify "
                      f"window parks rejected and pad writes in the "
                      f"scratch block")

        # -- programs --------------------------------------------------------
        # an int8 pin dequantizes at the top of every program
        if self._param_quant == "int8":
            def pf(p):
                return tf.dequantize_decode_params(p, cfg.dtype)
        else:
            def pf(p):
                return p
        self._verify_fn: Optional[_Program] = None
        if self._paged:
            # the tensor arguments after the parameters: the pools (and,
            # int8, their scales, see _pools), the block tables, then the
            # program's own
            q = self._kv_quant
            step = tf.decode_step_paged_q if q else tf.decode_step_paged
            chunk = tf.prefill_chunk_paged_q if q else tf.prefill_chunk_paged
            admit = tf.admit_insert_paged_q if q else tf.admit_insert_paged
            verify = tf.verify_step_paged_q if q else tf.verify_step_paged
            self._step_fn = _Program(
                lambda p, *a: step(cfg, pf(p), *a, t_logical=T))
            self._chunk_fn = _Program(
                lambda p, *a: chunk(cfg, pf(p), *a, t_logical=T))
            self._admit_fn = _Program(
                lambda p, *a: admit(cfg, pf(p), *a))
            if self._spec:
                self._verify_fn = _Program(
                    lambda p, *a: verify(cfg, pf(p), *a, t_logical=T))
        else:
            self._step_fn = _Program(
                lambda p, kc, vc, tok, pos, active:
                tf.decode_step(cfg, pf(p), kc, vc, tok, pos, active))
            self._chunk_fn = _Program(
                lambda p, kc, vc, slot, toks, off, n:
                tf.prefill_chunk(cfg, pf(p), kc, vc, slot, toks, off, n))
            self._admit_fn = _Program(
                lambda p, kc, vc, slot, toks, lens:
                self._admit_contiguous(pf(p), kc, vc, slot, toks, lens))
        self._cow_fn = None
        if self._prefix:
            # a copy-on-write copy takes its source's scales with it
            self._cow_fn = _Program(tf.cow_block_copy_q if self._kv_quant
                                    else tf.cow_block_copy)

        self._manager = SnapshotManager.of(lm, name=name)
        self._snap = None            # pinned while anything is in flight
        self._pinned = None
        self._pinned_version: Optional[int] = None
        self.pin_copies = 0

        # -- device state (owned by the loop thread) --------------------------
        if self._paged:
            shape = (L, self._pool.capacity + 1, self._block_size, D)
        else:
            shape = (L, S, T, D)
        self._k_cache = torch.zeros(
            shape, dtype=torch.int8 if self._kv_quant else cfg.dtype,
            device=self.device)
        self._v_cache = torch.zeros_like(self._k_cache)
        # int8 pools: one fp32 scale per (layer, block), 0 = never written
        self._k_scales: Optional[torch.Tensor] = None
        self._v_scales: Optional[torch.Tensor] = None
        if self._kv_quant:
            self._k_scales = torch.zeros((L, self._pool.capacity + 1),
                                         dtype=torch.float32,
                                         device=self.device)
            self._v_scales = torch.zeros_like(self._k_scales)
        # -- host state -------------------------------------------------------
        self._slot_req: List[Optional[_Request]] = [None] * S
        self._free_q: Deque[int] = collections.deque(range(S))
        self._tok = np.zeros(S, np.int64)
        self._pos = np.zeros(S, np.int64)
        self._active = np.zeros(S, bool)
        # the one admission prefilling in chunks (slot reserved, not live)
        self._pf: Optional[_Request] = None
        # a monolithic admission in progress holds reservations before
        # any slot goes live (the watchdog's leak check must not fire)
        self._admitting = False
        self._q = _PrioQueue(name, self._lookahead)
        # chaos/test hook (faultinject pool_squeeze=): block ids held
        # hostage to force pool pressure, left out of the leak check
        self._squeezed: List[int] = []
        # inbound KV transfers awaiting the loop thread, which owns the
        # pools: splice() parks (payload, done-event, out-dict) triples
        # here and the loop applies them between iterations
        self._splice_q: Deque = collections.deque()
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
        # seconds since the served source last moved, refreshed on each
        # health() poll: the signal the obs plane ships and
        # -params_stale_after_s turns into a STALE verdict
        self.params_age_gauge = Dashboard.get_or_create_gauge(
            f"SERVE_PARAMS_AGE[{name}]")
        self.shed_counter = Dashboard.get_or_create_counter(
            f"SERVE_SHED[{name}]")
        self.preempt_counter = Dashboard.get_or_create_counter(
            f"PREEMPTIONS[{name}]")
        self.deadline_counter = Dashboard.get_or_create_counter(
            f"DEADLINE_DROPS[{name}]")
        self._shed_class_counters: Dict[int, object] = {}
        self.steps_counter = Dashboard.get_or_create_counter(
            f"DECODE_STEPS[{name}]")
        self.prefill_tok_counter = Dashboard.get_or_create_counter(
            f"PREFILL_TOKENS[{name}]")
        self.decode_tok_counter = Dashboard.get_or_create_counter(
            f"DECODE_TOKENS[{name}]")
        # speculation's counters exist on spec engines only, so a spec_k=0
        # engine's dashboard is the plain engine's
        self.spec_prop_counter = self.spec_acc_counter = None
        if self._spec:
            self.spec_prop_counter = Dashboard.get_or_create_counter(
                f"SPEC_PROPOSED[{name}]")
            self.spec_acc_counter = Dashboard.get_or_create_counter(
                f"SPEC_ACCEPTED[{name}]")
        # the KV transfer plane's counters exist on prefix-cache engines
        # only (its gate), in raw K/V bytes moved
        self.xfer_bytes_counter = self.xfer_blocks_counter = None
        self.xfer_dedup_counter = None
        if self._prefix:
            self.xfer_bytes_counter = Dashboard.get_or_create_counter(
                f"KV_XFER_BYTES[{name}]")
            self.xfer_blocks_counter = Dashboard.get_or_create_counter(
                f"KV_XFER_BLOCKS[{name}]")
            self.xfer_dedup_counter = Dashboard.get_or_create_counter(
                f"KV_XFER_DEDUP[{name}]")
        self.iters_counter = Dashboard.get_or_create_counter(
            f"ENGINE_ITERS[{name}]")
        self.iters_total = 0
        self._last_progress = time.monotonic()
        # windowed latency SLOs (their rows ride Dashboard.snapshot())
        slo_ttft = float(ec._resolved("slo_ttft_ms"))
        if slo_ttft > 0:
            Dashboard.set_slo(f"SERVE_TTFT[{name}]", slo_ttft)
        slo_itl = float(ec._resolved("slo_itl_ms"))
        if slo_itl > 0:
            Dashboard.set_slo(f"SERVE_ITL[{name}]", slo_itl)
        # per-tenant cost attribution: host state on the loop thread only,
        # so it adds no program signature
        self.ledger: Optional[accounting.CostLedger] = None
        if bool(ec._resolved("cost_ledger")):
            self.ledger = accounting.CostLedger(
                name,
                block_bytes=(kv_bytes_per_block(
                    cfg.n_layers, cfg.d_model, self._block_size, cfg.dtype,
                    quant=self._kv_quant_mode) if self._paged else 0))
        self.recorder: Optional[FlightRecorder] = None
        if bool(ec._resolved("flight_recorder")):
            self.recorder = FlightRecorder(
                int(ec._resolved("flight_recorder_capacity")), name=name)
            self.recorder.meta.update(decode_tp=1, mesh_devices=1)
            if self._spec:
                self.recorder.meta["spec_k"] = self._spec
        # per-iteration scratch the recorder drains
        self._it_admitted: List[int] = []
        self._it_completed: List[int] = []
        self._it_prefill = 0
        self._it_decode = 0
        self._it_spec_proposed = 0
        self._it_spec_accepted = 0
        self.completed = 0
        self.shed = 0
        self.tokens = 0
        # peak concurrent sequences (live slots + the mid-prefill one)
        self.peak_live = 0
        self.prefill_tokens = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefill_tokens_saved = 0
        self.cow_copies = 0
        # preemption events, distinct requests preempted, deadline drops
        self.preemptions = 0
        self.preempted = 0
        self.deadline_drops = 0
        # the transfer plane: blocks and raw bytes fetched out or spliced
        # in, and blocks deduped at either end
        self.xfer_blocks = 0
        self.xfer_bytes = 0
        self.xfer_dedup = 0
        # speculation: drafts proposed and accepted, verify dispatches
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_steps = 0
        # int8 quality: the argmax-match rate against an fp engine, which
        # only a caller holding both outputs can measure (-1 = not yet)
        self._argmax_match = -1.0
        self._evictions_base = 0
        # host-clock seconds in admission (prefill chunks or whole-prompt
        # prefills, with their readbacks) and in fused decode steps
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.t_first: Optional[float] = None
        self._occ_sum = 0.0
        self._occ_n = 0
        self._thread = threading.Thread(
            target=self._loop, name=f"serve-decode-{name}", daemon=True)
        self._thread.start()
        # the watchdog reads the public health surface, so it starts
        # after the loop thread exists
        self.watchdog: Optional[EngineWatchdog] = None
        if bool(ec._resolved("watchdog")):
            self.watchdog = EngineWatchdog(
                self, ec.resolved_watchdog_config())

    # -- client side ----------------------------------------------------------
    def validate(self, prompt, max_new: Optional[int]) -> None:
        p = np.asarray(prompt, np.int64).ravel()
        if not 1 <= p.shape[0] <= self.config.max_prompt:
            raise ValueError(f"prompt length {p.shape[0]} outside "
                             f"[1, {self.config.max_prompt}]")
        if max_new is not None and not 1 <= int(max_new) <= self.config.max_new:
            raise ValueError(f"max_new {max_new} outside "
                             f"[1, {self.config.max_new}]")

    def _shed_class(self, priority: int) -> None:
        counter = self._shed_class_counters.get(priority)
        if counter is None:
            counter = Dashboard.get_or_create_counter(
                f"SHED_BY_CLASS[{self.name}.p{priority}]")
            self._shed_class_counters[priority] = counter
        counter.inc()

    def _shed(self, priority: int) -> None:
        self.shed += 1
        self.shed_counter.inc()
        self._shed_class(priority)

    def submit(self, prompt, max_new: Optional[int] = None,
               ctx: Optional[trace.SpanContext] = None,
               priority: Optional[int] = None,
               deadline_s: Optional[float] = None,
               xfer_info: Optional[Dict[str, int]] = None,
               tenant: Optional[str] = None) -> Future:
        """Enqueue one prompt. Sheds with :class:`OverloadedError` at the
        queue cap, and (paged) when ``prompt + max_new`` needs more blocks
        than the whole pool (``retriable=False``). ``priority`` is the
        class (0..7, None = 1); ``deadline_s`` (None = none) is seconds
        from now past which the request is dropped at queue pop with
        :class:`DeadlineExceededError`, before any prefill. ``ctx`` is the
        request's trace handoff token. ``xfer_info`` is the :meth:`splice`
        accounting of the transfer that warmed this prompt (it rides the
        admit span); ``tenant`` (None = ``-default_tenant``) is who pays
        on a ``cost_ledger`` engine."""
        self.validate(prompt, max_new)
        prio = DEFAULT_PRIORITY if priority is None else int(priority)
        if not 0 <= prio <= MAX_PRIORITY:
            raise ValueError(f"priority {prio} outside "
                             f"[0, {MAX_PRIORITY}]")
        deadline = None
        if deadline_s is not None:
            if float(deadline_s) <= 0:
                raise ValueError(f"deadline_s must be > 0, "
                                 f"got {deadline_s}")
            deadline = time.monotonic() + float(deadline_s)
        p = np.asarray(prompt, np.int64).ravel()
        req = _Request(p, int(max_new or self.config.max_new), ctx,
                       priority=prio, deadline=deadline, tenant=tenant)
        if xfer_info:
            req.xfer = dict(xfer_info)
        return self._enqueue(req, p.shape[0] + req.max_new)

    def _enqueue(self, req: _Request, positions: int) -> Future:
        """Queue ``req`` under the engine lock, shedding (and billing the
        shed) when ``positions`` can never fit the pool or the queue is
        full."""
        if self.ledger is not None:
            req.usage = self.ledger.usage(req.tenant)
        with self._cv:
            if self._stop.is_set():
                raise RuntimeError(f"decode engine {self.name!r} is stopped")
            if self._paged:
                need = self._pool.blocks_needed(positions)
                if need > self._pool.capacity:
                    self._shed(req.priority)
                    self._finalize_usage(req, "shed")
                    raise OverloadedError(self.name, need,
                                          self._pool.capacity,
                                          what="kv block pool",
                                          retriable=False)
            if len(self._q) >= self.config.max_queue:
                self._shed(req.priority)
                self._finalize_usage(req, "shed")
                raise OverloadedError(self.name, len(self._q),
                                      self.config.max_queue)
            if self.t_first is None:
                self.t_first = req.t_enq
            self._q.append(req)
            self._cv.notify()
        return req.future

    # -- disaggregated prefill/decode (kv_transfer) ---------------------------
    @property
    def supports_transfer(self) -> bool:
        """Whether this engine can be a disaggregation endpoint: the
        transfer plane moves chain-addressed full blocks, so it rides the
        prefix cache's gate (paged + chunked + prefix_cache)."""
        return self._prefix

    def submit_prefill(self, prompt, known_hashes: Sequence[str] = (),
                       ctx: Optional[trace.SpanContext] = None,
                       tenant: Optional[str] = None) -> Future:
        """Enqueue a prefill-only admission (a disaggregated fleet's
        stage 1): the prompt chunk-prefills into paged blocks like any
        admission, then resolves with ``{"xfer": payload,
        "snapshot_version", "staleness_s"}``, the prompt's full blocks
        fetched to the host as a :mod:`.kv_transfer` payload, and
        releases its reservation (the blocks stay cached, so a repeat
        full-hits here). ``known_hashes`` (hex) are the receiver's
        advertised chains: those blocks ride as metadata only. Sheds like
        :meth:`submit`; raises on an engine without
        :attr:`supports_transfer`."""
        if not self.supports_transfer:
            raise RuntimeError(
                f"decode engine {self.name!r} cannot serve prefill-only "
                f"admissions (needs paged KV + chunked prefill + "
                f"prefix_cache, the transfer plane's gate)")
        self.validate(prompt, None)
        p = np.asarray(prompt, np.int64).ravel()
        # max_new 1 keeps the arithmetic in range; the reservation is the
        # prompt's blocks only (nothing decodes)
        req = _Request(p, 1, ctx, tenant=tenant)
        req.pf_only = True
        req.known = frozenset(str(h) for h in known_hashes)
        return self._enqueue(req, p.shape[0])

    def splice(self, payload: dict, timeout_s: float = 30.0) -> Dict:
        """Splice a :mod:`.kv_transfer` payload into this engine's pool
        (a disaggregated fleet's arrival side) and return the accounting
        ``{"xfer_blocks", "xfer_bytes", "dedup_blocks"}`` (plus
        ``"skipped"`` when nothing could apply). Blocking and thread-safe:
        the loop thread owns the pools, so the payload waits on
        ``_splice_q`` until the loop applies it between iterations, and a
        follow-up :meth:`submit` of the same prompt sees the warm prefix.
        Degrades, never raises: an unsupported engine, a stopped loop or
        a timeout returns zero accounting and the prompt re-prefills."""
        zero = {"xfer_blocks": 0, "xfer_bytes": 0, "dedup_blocks": 0}
        if not self.supports_transfer:
            return dict(zero, skipped="unsupported")
        done = threading.Event()
        info: Dict = {}
        with self._cv:
            if self._stop.is_set():
                return dict(zero, skipped="stopped")
            self._splice_q.append((payload, done, info))
            self._cv.notify()
        if not done.wait(timeout_s):
            return dict(zero, skipped="timeout")
        out = dict(zero)
        out.update(info)
        return out

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._q)

    def health(self) -> dict:
        """The watchdog's poll surface: progress, liveness and queue age,
        without the histogram sorts of ``stats()``."""
        now = time.monotonic()
        with self._lock:
            depth = len(self._q)
            oldest = self._q.oldest_t_enq()
            pinned = self._pinned_version
            snap = self._snap
        from ..config import get_flag

        # params staleness: how long since the served source last moved.
        # The verdict is advisory: the engine keeps serving its pinned
        # snapshot, and the verdict clears when training moves again
        params_age = self._manager.params_age_s()
        stale_after = float(get_flag("params_stale_after_s"))
        self.params_age_gauge.set(params_age)
        out = {
            "iters_total": self.iters_total,
            "last_iter_age_s": now - self._last_progress,
            "snapshot_version": -1 if pinned is None else int(pinned),
            "snapshot_epoch": (0 if snap is None
                               else int(getattr(snap, "epoch", 0))),
            "params_age_s": round(params_age, 4),
            "params_stale": self._manager.params_stale(
                stale_after, age_s=params_age),
            # an admission in flight (chunked or monolithic) is live work
            "live_seqs": int(self._active.sum())
            + (1 if self._pf is not None else 0)
            + (1 if self._admitting else 0),
            "active_slots": int(self._active.sum()),
            "queue_depth": depth,
            "queue_age_s": (now - oldest) if oldest is not None else 0.0,
            "preemptions": self.preemptions,
            "stopped": self._stop.is_set(),
        }
        if self._prefix:
            # the dedup advertisement: chains content-addressed here ride
            # replica heartbeats, so a prefill stage skips shipping them
            out["cached_chains"] = [
                h.hex() for h in self._pool.indexed_hashes(
                    limit=_CHAIN_ADVERT_CAP)]
        if self.ledger is not None:
            # top tenants by cost, for replica heartbeats
            out["tenants"] = self.ledger.heartbeat_rows()
        return out

    def pool_drift(self) -> Optional[str]:
        """Paged-KV books: allocator invariant violations, or live blocks
        while nothing is alive to hold them. Sampled racily; the watchdog
        needs the verdict on two consecutive polls."""
        if not self._paged:
            return None
        msg = self._pool.drift()
        if msg is not None:
            return msg
        # squeezed blocks are held with no sequence by design
        live_blocks = self._pool.n_live - len(self._squeezed)
        if (live_blocks > 0 and not self._active.any()
                and self._pf is None and not self._admitting
                and not self._q):
            return (f"{live_blocks} live block(s) with zero live "
                    f"sequences (leaked reservation)")
        return None

    # -- admission gate -------------------------------------------------------
    def _req_hashes(self, req: _Request) -> List[bytes]:
        """The prompt's full-block hash chain, memoized per seed."""
        if req.hashes is None or req.hash_seed != self._hash_seed:
            req.hashes = chain_hashes(req.prompt, self._block_size,
                                      self._hash_seed)
            req.hash_seed = self._hash_seed
        return req.hashes

    def _prefix_usable_hits(self, req: _Request) -> int:
        """Net blocks the prefix cache saves ``req`` against the
        reclaimable supply (free + cached). A live-shared hit saves a
        block; a cached one is claimed out of that supply and cancels
        out; a fully cached prompt pays one fresh block for the
        copy-on-write of its last block. Floored at 0: the copy's source
        returns to the supply before the fresh allocation."""
        m, cached = self._pool.peek_counts(self._req_hashes(req))
        usable = m - 1 if (m and m * self._block_size == len(req.prompt)) \
            else m
        return max(0, usable - cached)

    def _reservation_blocks(self, req: _Request) -> int:
        """Prompt + remaining generation worth of blocks, or (optimistic,
        ``preempt``) the prompt's blocks only, unless the request spent
        its preemption budget: then it re-admits pessimistically. A
        prefill-only admission never decodes: its prompt is the whole
        reservation."""
        if req.pf_only:
            return self._pool.blocks_needed(len(req.prompt))
        if self._preempt_on and req.preempts < self._preempt_budget:
            return self._pool.blocks_needed(len(req.prompt))
        return self._pool.blocks_needed(
            len(req.prompt) + req.max_new - len(req.out))

    def _blocks_cover(self, req: _Request, reserved: int) -> bool:
        """Paged gate: the reservation (less what earlier arrivals of the
        same wave take, less usable prefix hits) fits free + cached."""
        if not self._paged:
            return True
        need = self._reservation_blocks(req)
        if self._prefix:
            need -= self._prefix_usable_hits(req)
        return need + reserved <= self._pool.n_free + self._pool.n_cached

    def _drop_expired(self, dropped: List[_Request]) -> None:
        """Fail requests whose deadline passed while queued, before any
        prefill (futures resolve outside the engine lock)."""
        now = time.monotonic()
        for req in dropped:
            self.deadline_drops += 1
            self.deadline_counter.inc()
            if req.usage is not None:
                # the whole life was queue wait
                req.usage.queue_wait_ms += (now - req.usage.t_wait0) * 1e3
                self._finalize_usage(req, "deadline", now)
            if trace.enabled() and req.ctx is not None:
                trace.record_span("queue.wait", req.ctx, req.t_enq, now,
                                  cause="deadline")
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(DeadlineExceededError(
                    f"decode request rid {req.rid} missed its deadline "
                    f"after {now - req.t_enq:.3f}s queued "
                    f"(engine {self.name!r})"))

    # -- engine thread --------------------------------------------------------
    def _loop(self) -> None:
        chunked = self._budget > 0
        while True:
            splices: List[tuple] = []
            with self._cv:
                while (not self._q and self._pf is None
                       and not self._active.any()
                       and not self._splice_q
                       and not self._stop.is_set()):
                    self._cv.wait()
                if (self._stop.is_set() and not self._q
                        and self._pf is None and not self._active.any()):
                    # release splice waiters: the loop applies no more
                    while self._splice_q:
                        _, done, info = self._splice_q.popleft()
                        info["skipped"] = "stopped"
                        done.set()
                    return
                if self._splice_q:
                    splices = list(self._splice_q)
                    self._splice_q.clear()
                now = time.monotonic()
                arrivals: List[_Request] = []
                expired: List[_Request] = []
                if chunked:
                    # one admission prefills at a time
                    if self._pf is None and self._free_q and self._q:
                        req, expired = self._q.pop_admissible(
                            now, lambda r: self._blocks_cover(r, 0))
                        if req is not None:
                            arrivals.append(req)
                else:
                    reserved = 0
                    while len(arrivals) < len(self._free_q) and self._q:
                        req, exp = self._q.pop_admissible(
                            now, lambda r, res=reserved:
                            self._blocks_cover(r, res))
                        expired.extend(exp)
                        if req is None:
                            break
                        if self._paged:
                            reserved += self._reservation_blocks(req)
                        arrivals.append(req)
            if expired:
                self._drop_expired(expired)
            # the progress clock restarts when the loop picks work up: an
            # idle engine is not a stalled one
            t_work0 = time.monotonic()
            self._last_progress = t_work0
            self._it_admitted.clear()
            self._it_completed.clear()
            self._it_prefill = self._it_decode = 0
            self._it_spec_proposed = self._it_spec_accepted = 0
            step_ms = 0.0
            worked = False
            try:
                # inbound KV transfers apply on this thread, which owns
                # the pools; a bad payload degrades, and its waiter is
                # released either way
                for payload, done, info in splices:
                    try:
                        info.update(self._apply_splice(payload))
                    except Exception as exc:    # pragma: no cover
                        info["skipped"] = f"splice failed: {exc}"
                    finally:
                        done.set()
                    worked = True
                if chunked:
                    if arrivals:
                        self._begin_prefill(arrivals[0],
                                            self._free_q.popleft())
                    # a full prefix hit costs no chunk: keep admitting
                    # until a chunk is pending or nothing is admissible
                    while self._pf is None and self._free_q:
                        with self._cv:
                            if not self._q:
                                break
                            req, exp = self._q.pop_admissible(
                                time.monotonic(),
                                lambda r: self._blocks_cover(r, 0))
                        if exp:
                            self._drop_expired(exp)
                        if req is None:
                            break
                        arrivals.append(req)
                        self._begin_prefill(req, self._free_q.popleft())
                        if req.slot == -1:
                            # its reservation raced a pool squeeze and it
                            # was requeued: retry next iteration
                            break
                    if self._pf is not None:
                        # at most one budget-sized chunk per iteration
                        self._prefill_one_chunk()
                        worked = True
                elif arrivals:
                    self._admitting = True
                    try:
                        self._admit(arrivals)
                    finally:
                        self._admitting = False
                    worked = True
                t_step0 = time.monotonic()
                self.prefill_s += t_step0 - t_work0
                live = int(self._active.sum()) + (self._pf is not None)
                self.peak_live = max(self.peak_live, live)
                if self._active.any():
                    self._step()
                    step_s = time.monotonic() - t_step0
                    self.decode_s += step_s
                    step_ms = step_s * 1e3
                    worked = True
            except Exception as exc:          # pragma: no cover - defensive
                # popped arrivals may not be slotted yet: fail them too
                self._fail_all(exc, arrivals)
                return
            if worked:
                self._record_iteration(t_work0, step_ms)
            elif not arrivals and not expired:
                # only block-starved waiters: yield instead of spinning
                time.sleep(0.0005)

    def _record_iteration(self, t_work0: float, step_ms: float) -> None:
        """One iteration retired: the progress clock, the counters, and
        the flight-recorder record (gauge samples, not accounting)."""
        now = time.monotonic()
        self.iters_total += 1
        self.iters_counter.inc()
        self._last_progress = now
        it_block_s = 0.0
        if self.ledger is not None:
            # KV residency: every admitted sequence pays its reserved
            # blocks x this iteration's wall
            dt = now - t_work0
            reqs = self._admitted_requests()
            self.ledger.charge_iteration(reqs, dt)
            it_block_s = dt * sum(len(r.blocks) for r in reqs)
        recorder = self.recorder
        if recorder is None:
            return
        try:
            oldest = self._q.oldest_t_enq()
        except (IndexError, RuntimeError):   # racing a concurrent submit
            oldest = None
        paged = self._paged
        recorder.record((
            self.iters_total, now, (now - t_work0) * 1e3, step_ms,
            int(self._active.sum()), 1 if self._pf is not None else 0,
            len(self._q),
            0.0 if oldest is None else (now - oldest) * 1e3,
            self._it_prefill, self._it_decode,
            self._pool.n_free if paged else -1,
            self._pool.n_live if paged else -1,
            self._pool.n_shared if paged else -1,
            self._snap.version if self._snap is not None else -1,
            tuple(self._it_admitted), tuple(self._it_completed),
            self._it_spec_proposed if self._spec else -1,
            self._it_spec_accepted if self._spec else -1,
            (1 if self._kv_quant else 0) if paged else -1,
            # written-block proxy (live + cached): the real count of
            # nonzero scales would cost a device read per iteration
            (self._pool.n_live + self._pool.n_cached)
            if self._kv_quant else -1,
            # the ledger's columns (-1 when it is off): this iteration's
            # KV block-seconds and the live tenant count
            round(it_block_s, 6) if self.ledger is not None else -1.0,
            self.ledger.tenant_count() if self.ledger is not None else -1,
            # sequence-parallel chunks: prefill_sp is not ported
            -1))

    def _seed_for(self, version: int) -> bytes:
        """The hash chain's seed for a pinned snapshot version, tagged by
        the pool's encoding (an int8 block and an fp block of one prefix
        hold different bytes), as in the JAX engine: a cross-encoding
        transfer then fails the seed check and re-prefills."""
        if self._kv_quant:
            return f"{int(version)}/int8".encode()
        return str(int(version)).encode()

    def _maybe_refresh(self, hold: bool = False) -> None:
        """Move the pinned snapshot only while no generation is in flight:
        no live slot, no mid-prefill admission, and no preempted request
        waiting to resume (``hold`` covers the one being re-admitted). The
        pinned params memoize on snapshot version; when the pin moves, the
        prefix cache of the old version is flushed."""
        snap = self._snap
        if snap is None:
            snap = self._manager.current()
        elif (not hold and not self._active.any() and self._pf is None
                and self._q.n_resumed == 0):
            snap = self._manager.ensure_fresh(self.config.max_staleness_s)
        if self._snap is not snap or self._pinned is None:
            if self._pinned is None or snap.version != self._pinned_version:
                with trace.span("snapshot.pin", engine=self.name,
                                version=snap.version):
                    # the snapshot is already a private copy on the
                    # model's device: pinning it copies nothing more,
                    # unless the pin is int8 (quantized on the host once
                    # per version, the int8 copy kept on the device)
                    self._pinned = (quantize_decode_params(snap.value)
                                    if self._param_quant == "int8"
                                    else snap.value)
                self._pinned_version = snap.version
                self.pin_copies += 1
            self._snap = snap
            if self._prefix:
                seed = self._seed_for(snap.version)
                if seed != self._hash_seed:
                    self._hash_seed = seed
                    self._pool.flush_cache()

    # -- device inputs --------------------------------------------------------
    def _upload(self, host: np.ndarray) -> torch.Tensor:
        """One host-to-device copy of a packed int64 array."""
        return torch.from_numpy(host).to(self.device)

    def _tables(self) -> torch.Tensor:
        """The block tables' device copy, uploaded if the host mirror
        changed since the last upload."""
        if self._bt_dirty:
            self._bt_dev.copy_(torch.from_numpy(self._block_tables))
            self._bt_dirty = False
            self.table_uploads += 1
        return self._bt_dev

    def _set_row(self, slot: int, blocks: List[int]) -> None:
        row = self._block_tables[slot]
        row[:] = SCRATCH_BLOCK
        row[: len(blocks)] = blocks
        self._bt_dirty = True

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _pools(self) -> Tuple[torch.Tensor, ...]:
        """The KV pools, and their scales on an int8 engine: the leading
        tensor arguments of every program."""
        if self._kv_quant:
            return (self._k_cache, self._v_cache, self._k_scales,
                    self._v_scales)
        return self._k_cache, self._v_cache

    # -- admission ------------------------------------------------------------
    def _reserve_blocks(self, req: _Request, slot: int) -> None:
        """Paged: claim the reservation and install it in the slot's
        table row (the gate guaranteed coverage). With prefix caching the
        longest cached prefix splices in with a refcount bump; a fully
        cached prompt copy-on-writes its last block before the table
        reaches the step, which will rewrite position ``P - 1`` there."""
        if not self._paged:
            return
        total = self._reservation_blocks(req)
        matched: List[int] = []
        hashes: List[bytes] = []
        full_hit_cow = False
        if self._prefix:
            hashes = self._req_hashes(req)
            matched = self._pool.lookup(hashes)
            req.n_hit = len(matched)
            req.full_hit = bool(matched) and (
                len(matched) * self._block_size == len(req.prompt))
            req.blocks = matched
            # a prefill-only full hit skips the copy: nothing writes this
            # sequence, so its payload fetches from the shared blocks
            if req.full_hit and not req.pf_only:
                shared_last = matched[-1]
                dup = self._pool.alloc(1)[0]
                ids = self._upload(np.array([shared_last, dup], np.int64))
                self._cow_fn(*self._pools(), ids[0], ids[1])
                self._pool.decref([shared_last])
                matched[-1] = dup
                full_hit_cow = True
            req.saved = (len(req.prompt) if req.full_hit
                         else req.n_hit * self._block_size)
        req.blocks = matched + self._pool.alloc(total - len(matched))
        # the stats commit once the whole reservation stands (a raced
        # allocation requeues the request without them)
        if self._prefix:
            if full_hit_cow:
                self.cow_copies += 1
            self.prefix_hits += req.n_hit
            self.prefix_misses += len(hashes) - req.n_hit
            self.prefill_tokens_saved += req.saved
            if req.usage is not None:
                req.usage.prefill_tokens_saved += req.saved
        self._set_row(slot, req.blocks)

    def _release_seq(self, req: _Request) -> None:
        """Completion: the slot returns to the free set and (paged) the
        reservation drops this holder, TAIL first: release order is LRU
        order and lookups walk a chain head first, so eviction must
        shrink a chain from its end."""
        if self._paged and req.blocks:
            self._pool.decref(reversed(req.blocks))
            req.blocks = []
            self._set_row(req.slot, [])
        self._free_q.append(req.slot)

    def _begin_prefill(self, req: _Request, slot: int) -> None:
        """Reserve ``slot`` (and its blocks) and pin the snapshot for one
        chunked admission; its prompt then prefills one chunk per
        iteration, from the first uncached token."""
        self._maybe_refresh(hold=req.resumed)
        req.version = self._snap.version
        req.slot = slot
        try:
            self._reserve_blocks(req, slot)
        except RuntimeError:
            # a concurrent pool claimant (a chaos pool squeeze) raced the
            # admission gate: requeue, as a preemption before any work
            if req.blocks:
                self._pool.decref(reversed(req.blocks))
                req.blocks = []
            self._set_row(slot, [])
            self._free_q.append(slot)
            req.slot = -1
            req.hashes = None
            req.n_hit = 0
            req.full_hit = False
            with self._cv:
                self._q.appendleft(req)
            return
        req.pf_chunks = 0
        req.t_admit = time.monotonic()
        if req.usage is not None:
            req.usage.queue_wait_ms += (req.t_admit
                                        - req.usage.t_wait0) * 1e3
        if self._spec:
            # the drafter indexes the prompt now and each emitted token
            # from here on
            req.drafter = _PromptLookup()
            req.drafter.extend(req.prompt)
        self._it_admitted.append(req.rid)
        if self._prefix and req.full_hit and req.pf_only:
            # a prefill-only admission of a fully cached prompt: every
            # block is resident, so the payload fetches now
            self._pf = None
            self._finish_prefill_only(req, chunks=0)
            return
        if self._prefix and req.full_hit:
            # no prefill at all: the slot goes live at P - 1 with the
            # prompt's last token; the next step rewrites that position's
            # K/V (into the copied block) and emits the first token
            if trace.enabled() and req.ctx is not None:
                now = time.monotonic()
                extra = self._xfer_attrs(req)
                if req.preempts:
                    extra["preempted"] = req.preempts
                trace.record_span("queue.wait", req.ctx, req.t_enq,
                                  req.t_admit, cause="admission")
                trace.record_span(
                    "decode.admit", req.ctx, req.t_admit, now,
                    slot=slot, prompt_len=len(req.prompt), chunks=0,
                    budget=self._budget, snapshot_version=req.version,
                    blocks=len(req.blocks), pool_free=self._pool.n_free,
                    prefix_hit_blocks=req.n_hit,
                    prefill_tokens_saved=req.saved, **extra)
            # a resumed full hit recorded its TTFT in its first life
            req.ttft_pending = not req.resumed
            req.t_last = req.t_admit
            self._slot_req[slot] = req
            self._tok[slot] = int(req.prompt[-1])
            self._pos[slot] = len(req.prompt) - 1
            self._active[slot] = True
            self._pf = None
            return
        req.pf_off = req.n_hit * self._block_size if self._prefix else 0
        req.pf_reg = req.n_hit
        self._pf = req

    def _prefill_one_chunk(self) -> None:
        """ONE budget-sized chunk of the in-flight admission; on the final
        chunk the first token falls out and the slot goes live (or
        resolves at once on eos-at-first-token)."""
        req = self._pf
        C = self._budget
        off = req.pf_off
        n = min(C, len(req.prompt) - off)
        host = np.zeros(C + 3, np.int64)
        host[: n] = req.prompt[off: off + n]
        host[C:] = (req.slot, off, n)
        args = self._upload(host)
        toks, slot, off_t, n_t = args[:C], args[C], args[C + 1], args[C + 2]
        tracing = trace.enabled()
        t0 = time.monotonic() if tracing else 0.0
        if self._paged:
            logits = self._chunk_fn(
                self._pinned, *self._pools(), self._tables(), slot, toks,
                off_t, n_t)[-1]
        else:
            _, _, logits = self._chunk_fn(
                self._pinned, self._k_cache, self._v_cache, slot, toks,
                off_t, n_t)
        req.pf_off = off + n
        req.pf_chunks += 1
        self.prefill_tokens += n
        self.prefill_tok_counter.inc(n)
        self._it_prefill += n
        if req.usage is not None:
            req.usage.prefill_tokens += n
            if req.resumed:
                # a preemption's recompute, still counted as prefill: the
                # identity tracks work done
                req.usage.recompute_tokens += n
        if self._prefix:
            # every prompt block this chunk completed gains its identity
            # now: a concurrent same-prefix arrival can share it
            hashes = self._req_hashes(req)
            while (req.pf_reg < len(hashes)
                   and (req.pf_reg + 1) * self._block_size <= req.pf_off):
                self._pool.register(req.blocks[req.pf_reg],
                                    hashes[req.pf_reg])
                req.pf_reg += 1
        final = req.pf_off >= len(req.prompt)
        if not final or req.pf_only:
            # retire each chunk in its iteration: chunks queued ahead of
            # the device would all land on the next step's readback
            self._sync()
            if tracing and req.ctx is not None:
                trace.record_span(
                    "decode.prefill_chunk", req.ctx, t0, time.monotonic(),
                    slot=req.slot, offset=off, chunk=req.pf_chunks - 1,
                    tokens=n, budget=C)
            if final:
                # prefill-only: the finished blocks are the result, and
                # the decode side recomputes P - 1 through its full hit
                self._pf = None
                self._finish_prefill_only(req, chunks=req.pf_chunks)
            return
        # the final chunk's logits are the first token (the host read)
        tok0 = int(torch.argmax(logits))
        now = time.monotonic()
        if tracing and req.ctx is not None:
            trace.record_span(
                "decode.prefill_chunk", req.ctx, t0, now, slot=req.slot,
                offset=off, chunk=req.pf_chunks - 1, tokens=n, budget=C)
        if req.resumed:
            # a preemption's recompute: TTFT happened in the first life,
            # and this gap carries the whole preemption stall
            self.itl_hist.record((now - req.t_last) * 1e3)
        else:
            self.ttft_hist.record((now - req.t_enq) * 1e3)
        req.t_last = now
        self.tokens += 1
        self.decode_tok_counter.inc()
        self._it_decode += 1
        if req.usage is not None:
            req.usage.decode_tokens += 1
        req.out.append(tok0)
        if req.drafter is not None:
            req.drafter.extend((tok0,))
        if tracing and req.ctx is not None:
            trace.record_span("queue.wait", req.ctx, req.t_enq,
                              req.t_admit, cause="admission")
            extra = ({"blocks": len(req.blocks),
                      "pool_free": self._pool.n_free}
                     if self._paged else {})
            extra.update(self._xfer_attrs(req))
            if self._prefix:
                extra["prefix_hit_blocks"] = req.n_hit
                extra["prefill_tokens_saved"] = req.saved
            if req.preempts:
                extra["preempted"] = req.preempts
            trace.record_span(
                "decode.admit", req.ctx, req.t_admit, now, slot=req.slot,
                prompt_len=len(req.prompt), chunks=req.pf_chunks,
                budget=C, snapshot_version=req.version, **extra)
        self._pf = None
        if self._finished(req, tok0):
            # the slot never goes live; its K/V is dead weight a later
            # admission overwrites
            self._release_seq(req)
            self._resolve(req)
            return
        self._slot_req[req.slot] = req
        self._tok[req.slot] = tok0
        self._pos[req.slot] = len(req.prompt)
        self._active[req.slot] = True

    @staticmethod
    def _xfer_attrs(req: _Request) -> Dict[str, int]:
        """The admit span's link to the splice that warmed the prompt."""
        if not req.xfer:
            return {}
        return {k: req.xfer.get(k, 0)
                for k in ("xfer_blocks", "xfer_bytes", "dedup_blocks")}

    def _pool_dtype(self) -> str:
        """The pools' native dtype name: what a payload's blocks carry."""
        return ("int8" if self._kv_quant
                else kv_transfer.dtype_name(self._model_cfg.dtype))

    def _count_xfer(self, blocks: int, nbytes: int, dedup: int) -> None:
        self.xfer_blocks += blocks
        self.xfer_bytes += nbytes
        self.xfer_dedup += dedup
        if blocks:
            self.xfer_blocks_counter.inc(blocks)
            self.xfer_bytes_counter.inc(nbytes)
        if dedup:
            self.xfer_dedup_counter.inc(dedup)

    @torch.no_grad()
    def _finish_prefill_only(self, req: _Request, chunks: int) -> None:
        """A prefill-only admission is done (its full blocks prefilled or
        cache-resident): fetch the blocks the receiver did not advertise
        to the host in one copy, build the payload, release the
        reservation (the blocks stay cached) and resolve with the payload.
        Loop thread only: it owns the pools."""
        hashes = self._req_hashes(req)
        cfg = self._model_cfg
        payload = kv_transfer.new_payload(
            len(req.prompt), self._block_size, req.version,
            (cfg.n_layers, self._block_size, cfg.d_model),
            self._pool_dtype())
        if req.tenant:
            # the receiver's ledger bills the splice-in to this tenant
            payload["tenant"] = req.tenant
        ship = [i for i, h in enumerate(hashes) if h.hex() not in req.known]
        host = None
        if ship:
            ids = self._upload(np.asarray([req.blocks[i] for i in ship],
                                          np.int64))
            pools = (self._k_cache, self._v_cache)
            if self._kv_quant:
                pools += (self._k_scales, self._v_scales)
            # [L, n, Bs, D] blocks and [L, n] scales: one host read
            host = [t.index_select(1, ids).cpu() for t in pools]
        col = {i: j for j, i in enumerate(ship)}
        for i, h in enumerate(hashes):
            j = col.get(i)
            if j is None:
                # source-side dedup: the hash rides, the bytes stay home
                kv_transfer.add_block(payload, h.hex())
                continue
            scales = ((host[2][:, j], host[3][:, j]) if self._kv_quant
                      else (None, None))
            kv_transfer.add_block(payload, h.hex(), host[0][:, j],
                                  host[1][:, j], *scales)
        nbytes = kv_transfer.payload_bytes(payload)
        dedup = int(payload["dedup_blocks"])
        self._count_xfer(len(ship), nbytes, dedup)
        if req.usage is not None:
            req.usage.xfer_bytes += nbytes
        now = time.monotonic()
        if trace.enabled() and req.ctx is not None:
            trace.record_span("queue.wait", req.ctx, req.t_enq,
                              req.t_admit, cause="admission")
            trace.record_span(
                "decode.admit", req.ctx, req.t_admit, now, slot=req.slot,
                prompt_len=len(req.prompt), chunks=chunks,
                budget=self._budget, snapshot_version=req.version,
                blocks=len(req.blocks), pool_free=self._pool.n_free,
                prefix_hit_blocks=req.n_hit,
                prefill_tokens_saved=req.saved, prefill_only=True,
                xfer_blocks=len(ship), xfer_bytes=nbytes,
                dedup_blocks=dedup)
        self._finalize_usage(req, "completed", now)
        self._release_seq(req)
        self.completed += 1
        self._it_completed.append(req.rid)
        if req.future.set_running_or_notify_cancel():
            req.future.set_result({
                "xfer": payload, "snapshot_version": req.version,
                "staleness_s": self._manager.staleness_s(self._snap)})

    @torch.no_grad()
    def _apply_splice(self, payload: dict) -> Dict:
        """Splice one received payload into the pool (loop thread). The
        hash chain is walked head first: an indexed hash is an arrival
        dedup; a shipped one takes a fresh block, is registered and
        decrefs into the cached tier, where the follow-up admission's
        lookup claims it. The walk stops at the first gap (chain hashes
        mean prefixes), so a dropped payload or a full pool gives a
        shorter warm prefix, never a wrong one. A payload of another
        snapshot version, block size, shape or dtype is skipped whole."""
        info: Dict = {"xfer_blocks": 0, "xfer_bytes": 0,
                      "dedup_blocks": 0}
        why = kv_transfer.validate(payload)
        if why is not None:
            info["skipped"] = why
            return info
        # pin a snapshot if nothing has yet (a decode replica may see a
        # transfer before its first request)
        self._maybe_refresh()
        if self._seed_for(int(payload["snapshot_version"])) != \
                self._hash_seed:
            info["skipped"] = (
                f"snapshot version {payload['snapshot_version']} != "
                f"pinned {self._pinned_version}")
            return info
        if int(payload["block_size"]) != self._block_size:
            info["skipped"] = (f"block size {payload['block_size']} != "
                               f"{self._block_size}")
            return info
        cfg = self._model_cfg
        shape = tuple(int(d) for d in payload["shape"])
        if shape != (cfg.n_layers, self._block_size, cfg.d_model):
            info["skipped"] = f"block shape {shape} mismatch"
            return info
        try:
            dtype = kv_transfer.dtype_name(payload["dtype"])
        except ValueError as exc:
            info["skipped"] = str(exc)
            return info
        if dtype != self._pool_dtype():
            info["skipped"] = f"dtype {dtype} != {self._pool_dtype()}"
            return info
        per_block = kv_transfer.block_nbytes(shape, dtype)
        blocks = payload.get("blocks") or {}
        new: List[Tuple[int, bytes, tuple]] = []
        for hx in payload["hashes"]:
            h = bytes.fromhex(hx)
            if self._pool.peek([h]):
                info["dedup_blocks"] += 1
                continue
            rec = blocks.get(hx)
            if rec is None or not self._pool.can_alloc(1):
                break
            try:
                k, v = kv_transfer.unpack_block(rec, shape, dtype)
                scales = (kv_transfer.unpack_scales(rec, cfg.n_layers)
                          if self._kv_quant else None)
            except ValueError:
                break
            if self._kv_quant and scales is None:
                # int8 bytes without their scales are undecodable
                break
            new.append((self._pool.alloc(1)[0], h, (k, v) + (
                tuple(torch.from_numpy(np.array(x)) for x in scales)
                if scales is not None else ())))
        if new:
            # one upload, one indexed write per pool
            ids = self._upload(np.asarray([b for b, _, _ in new], np.int64))
            pools = [self._k_cache, self._v_cache]
            if self._kv_quant:
                pools += [self._k_scales, self._v_scales]
            for i, pool in enumerate(pools):
                vals = torch.stack([t[i] for _, _, t in new], dim=1)
                pool.index_copy_(1, ids, vals.to(pool.device, pool.dtype))
            for blk, h, _ in new:
                self._pool.register(blk, h)
                self._pool.decref([blk])
            info["xfer_blocks"] = len(new)
            info["xfer_bytes"] = len(new) * per_block
        self._count_xfer(info["xfer_blocks"], info["xfer_bytes"],
                         info["dedup_blocks"])
        if self.ledger is not None and info["xfer_bytes"]:
            # splice-in bytes bill the payload's tenant at once (no
            # request carries them yet), the same amount as the mirror
            self.ledger.charge(payload.get("tenant"),
                               xfer_bytes=info["xfer_bytes"])
        return info

    def _admit_contiguous(self, params, k_cache, v_cache, slot, toks,
                          lengths):
        """The contiguous monolithic admission program: whole-prompt
        prefill, the first token, and the K/V insert into ``slot`` [1]."""
        tf = self._tf
        logits, ks, vs = tf.prefill(self._model_cfg, params, toks)
        tf.cache_insert(k_cache, v_cache, slot, ks, vs)
        return tf.first_tokens(logits, lengths), k_cache, v_cache

    @torch.no_grad()
    def _admit(self, arrivals: List[_Request]) -> None:
        """Monolithic admission: each arrival its own ``[1, bucket]``
        whole-prompt prefill, one readback for the whole wave."""
        t_admit = time.monotonic()
        self._maybe_refresh()
        version = self._snap.version
        M = self._blocks_per_seq
        firsts, buckets = [], []
        for req in arrivals:
            pb = bucket_for(len(req.prompt), self._prompt_buckets)
            slot = self._free_q.popleft()
            req.slot = slot
            self._reserve_blocks(req, slot)
            if self._spec:
                req.drafter = _PromptLookup()
                req.drafter.extend(req.prompt)
            host = np.zeros(pb + 2 + M, np.int64)
            host[: len(req.prompt)] = req.prompt
            host[pb: pb + 2] = (len(req.prompt), slot)
            if self._paged:
                host[pb + 2:] = self._block_tables[slot]
            args = self._upload(host)
            toks, lens = args[:pb].view(1, pb), args[pb: pb + 1]
            if self._paged:
                first = self._admit_fn(
                    self._pinned, *self._pools(),
                    args[pb + 2:].view(1, M), toks, lens)[0]
            else:
                first, _, _ = self._admit_fn(
                    self._pinned, self._k_cache, self._v_cache,
                    args[pb + 1: pb + 2], toks, lens)
            firsts.append(first)
            buckets.append(pb)
            self.prefill_tokens += len(req.prompt)
            self.prefill_tok_counter.inc(len(req.prompt))
            self._it_prefill += len(req.prompt)
            if req.usage is not None:
                req.usage.queue_wait_ms += (t_admit
                                            - req.usage.t_wait0) * 1e3
                req.usage.prefill_tokens += len(req.prompt)
            self._it_admitted.append(req.rid)
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
            self._it_decode += 1
            if req.usage is not None:
                req.usage.decode_tokens += 1
            req.out.append(tok0)
            if req.drafter is not None:
                req.drafter.extend((tok0,))
            if tracing and req.ctx is not None:
                trace.record_span("queue.wait", req.ctx, req.t_enq, t_admit,
                                  cause="admission")
                extra = ({"blocks": len(req.blocks),
                          "pool_free": self._pool.n_free}
                         if self._paged else {})
                trace.record_span(
                    "decode.admit", req.ctx, t_admit, now, slot=req.slot,
                    prompt_len=len(req.prompt), prompt_bucket=buckets[i],
                    snapshot_version=version, **extra)
            if self._finished(req, tok0):
                self._release_seq(req)
                self._resolve(req)
                continue
            self._slot_req[req.slot] = req
            self._tok[req.slot] = tok0
            self._pos[req.slot] = len(req.prompt)
            self._active[req.slot] = True

    # -- preemption -----------------------------------------------------------
    def _admitted_requests(self) -> List[_Request]:
        reqs = [r for r in self._slot_req if r is not None]
        if self._pf is not None:
            reqs.append(self._pf)
        return reqs

    def _pick_victim(self, grower: _Request) -> Optional[_Request]:
        """Among admitted sequences, the lowest-priority then youngest,
        never the grower and never the oldest (the guaranteed-progress
        floor). Unless the grower is the oldest, a victim must have budget
        left and rank below the grower."""
        cands = [r for r in self._admitted_requests() if r is not grower]
        if not cands:
            return None
        oldest = min(cands + [grower], key=lambda r: r.t_enq)
        cands = [r for r in cands if r is not oldest]
        if not cands:
            return None
        if oldest is not grower:
            cands = [r for r in cands
                     if r.preempts < self._preempt_budget
                     and (r.priority < grower.priority
                          or (r.priority == grower.priority
                              and r.t_enq > grower.t_enq))]
            if not cands:
                return None
        return min(cands, key=lambda r: (r.priority, -r.t_enq))

    def _preempt(self, req: _Request, why: str = "") -> None:
        """Evict one admitted sequence and free its blocks (tail first);
        it re-enters the front of its lane and recomputes from ``prompt +
        emitted tokens`` on re-admission. Host-side scheduling only: the
        block tables are data."""
        t0 = time.monotonic()
        slot = req.slot
        freed = len(req.blocks)
        if req is self._pf:
            self._pf = None
        else:
            self._active[slot] = False
            self._slot_req[slot] = None
        if req.blocks:
            self._pool.decref(reversed(req.blocks))
            req.blocks = []
        self._set_row(slot, [])
        self._free_q.append(slot)
        req.slot = -1
        if req.preempts == 0:
            self.preempted += 1
        req.preempts += 1
        self.preemptions += 1
        self.preempt_counter.inc()
        if req.out:
            req.prompt = np.concatenate(
                [req.prompt0, np.asarray(req.out, np.int64)])
            req.resumed = True
        req.hashes = None
        req.n_hit = 0
        req.full_hit = False
        req.saved = 0
        req.pf_off = req.pf_chunks = req.pf_reg = 0
        req.ttft_pending = False
        # the drafter is rebuilt at re-admission from the same tokens
        req.drafter = None
        if req.usage is not None:
            # a fresh queue-wait interval opens until re-admission
            req.usage.t_wait0 = time.monotonic()
        if trace.enabled() and req.ctx is not None:
            trace.record_span(
                "decode.preempt", req.ctx, t0, time.monotonic(),
                victim=req.rid, slot=slot, blocks_freed=freed,
                preempts=req.preempts, priority=req.priority, why=why)
        with self._cv:
            self._q.appendleft(req)

    def _ensure_growth(self, n_valid: Optional[np.ndarray] = None) -> None:
        """Optimistic admission's decode-time half: before the step (or
        verify window), each live reservation must cover the positions
        this iteration writes, ``pos .. pos + window - 1`` (the window
        length is ``n_valid``, 1 without drafts). On pool exhaustion a
        victim is preempted; with no admissible victim the grower yields.
        Growers go highest class, oldest first."""
        order = [s for s in range(self.config.slots)
                 if self._slot_req[s] is not None]
        order.sort(key=lambda s: (-self._slot_req[s].priority,
                                  self._slot_req[s].t_enq))
        for s in order:
            req = self._slot_req[s]
            if req is None:          # victimized by an earlier grower
                continue
            win = 1 if n_valid is None else max(1, int(n_valid[s]))
            grow = (self._pool.blocks_needed(int(self._pos[s]) + win)
                    - len(req.blocks))
            if grow <= 0:
                continue
            while self._slot_req[s] is req:
                if self._pool.can_alloc(grow):
                    blocks = self._pool.alloc(grow)
                    base = len(req.blocks)
                    req.blocks.extend(blocks)
                    self._block_tables[s][base: base + grow] = blocks
                    self._bt_dirty = True
                    break
                victim = self._pick_victim(req)
                if victim is None:
                    self._preempt(req, why="yield: no admissible victim")
                    break
                self._preempt(victim, why=f"growth for rid {req.rid}")

    # -- speculation ----------------------------------------------------------
    def _propose_drafts(self):
        """This iteration's verification window: up to ``spec_k``
        prompt-lookup drafts per live slot, as ``(toks [S, K + 1],
        n_valid [S])``, or ``(None, None)`` when no slot drafted (the
        iteration then runs the plain step). Drafts clamp to the request's
        remaining budget minus one (the correction token fills the last
        emission), so a valid window write never passes position
        ``prompt + max_new - 2``, inside the reservation; under
        ``preempt`` :meth:`_ensure_growth` grows each slot by its window."""
        K = self._spec
        S = self.config.slots
        toks = n_valid = None
        for s in range(S):
            req = self._slot_req[s]
            if req is None:
                continue
            limit = min(K, req.max_new - len(req.out) - 1)
            if limit <= 0:
                continue
            drafts = req.drafter.propose(limit)
            if not drafts:
                continue
            if toks is None:
                toks = np.zeros((S, K + 1), np.int64)
                toks[:, 0] = self._tok
                n_valid = np.ones(S, np.int64)
            toks[s, 1: 1 + len(drafts)] = drafts
            n_valid[s] = 1 + len(drafts)
        return toks, n_valid

    def _accept(self, s: int, spec_toks: np.ndarray, n_valid: np.ndarray,
                out: np.ndarray) -> Tuple[List[int], int]:
        """Greedy verification of slot ``s``'s window: drafts are accepted
        while each matches the window's argmax after its predecessor;
        entry ``accepted`` of the outputs is the correction token. An eos
        inside the window truncates it there, and only realized drafts
        count as accepted. Returns ``(emitted tokens, accepted)``."""
        nv = int(n_valid[s])
        accepted = 0
        while (accepted + 1 < nv
               and int(spec_toks[s, accepted + 1]) == int(out[s, accepted])):
            accepted += 1
        emitted = [int(out[s, j]) for j in range(accepted + 1)]
        eos = self.config.eos_id
        if eos is not None and eos in emitted:
            emitted = emitted[: emitted.index(eos) + 1]
            accepted = len(emitted) - 1
        proposed = nv - 1
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        self._it_spec_proposed += proposed
        self._it_spec_accepted += accepted
        if proposed:
            self.spec_prop_counter.inc(proposed)
        if accepted:
            self.spec_acc_counter.inc(accepted)
        return emitted, accepted

    # -- the fused step -------------------------------------------------------
    @torch.no_grad()
    def _step(self) -> None:
        tracing = trace.enabled()
        ledger_on = self.ledger is not None
        t_it0 = time.monotonic() if (tracing or ledger_on) else 0.0
        spec_toks = n_valid = None
        if self._spec:
            spec_toks, n_valid = self._propose_drafts()
        if self._preempt_on:
            self._ensure_growth(n_valid)
            if not self._active.any():
                return
        S = self.config.slots
        if spec_toks is not None:
            # one upload: pos, active, n_valid and the window [S, K + 1]
            K1 = spec_toks.shape[1]
            host = np.empty((S, K1 + 3), np.int64)
            host[:, 0], host[:, 1], host[:, 2] = \
                self._pos, self._active, n_valid
            host[:, 3:] = spec_toks
            ctl = self._upload(host)
            self.spec_steps += 1
            nxt = self._verify_fn(
                self._pinned, *self._pools(), self._tables(), ctl[:, 3:],
                ctl[:, 0], ctl[:, 1] != 0, ctl[:, 2])[-1]
        else:
            host = np.empty((3, S), np.int64)
            host[0], host[1], host[2] = self._tok, self._pos, self._active
            ctl = self._upload(host)
            tok, pos, active = ctl[0], ctl[1], ctl[2] != 0
            if self._paged:
                nxt = self._step_fn(
                    self._pinned, *self._pools(), self._tables(), tok, pos,
                    active)[-2]
            else:
                _, _, nxt, _ = self._step_fn(
                    self._pinned, self._k_cache, self._v_cache, tok, pos,
                    active)
        nxt = nxt.cpu().numpy()       # the host sync point: [S] or [S, K1]
        now = time.monotonic()
        self.steps_counter.inc()
        if ledger_on:
            # the step's wall divides over the sequences it served, before
            # the loop below retires any of them
            self.ledger.charge_step(
                [r for r in self._slot_req if r is not None],
                (now - t_it0) * 1e3)
        n_active = 0
        for s in range(S):
            req = self._slot_req[s]
            if req is None:
                continue
            n_active += 1
            if spec_toks is None:
                emitted, accepted = [int(nxt[s])], 0
            else:
                emitted, accepted = self._accept(s, spec_toks, n_valid, nxt)
            # rejected window positions are never consumed: the next
            # window starts at the first unverified position and rewrites
            # them before any mask reaches them
            self._pos[s] += len(emitted)
            self._tok[s] = emitted[-1]
            # ITL per emitted token: the interval divides over the window
            share = (now - req.t_last) * 1e3 / len(emitted)
            done = False
            for tok in emitted:
                req.out.append(tok)
                self.tokens += 1
                self.decode_tok_counter.inc()
                self._it_decode += 1
                if req.usage is not None:
                    req.usage.decode_tokens += 1
                if req.ttft_pending:
                    # a fully cached admission's first token is TTFT
                    req.ttft_pending = False
                    self.ttft_hist.record((now - req.t_enq) * 1e3)
                else:
                    self.itl_hist.record(share)
                if self._finished(req, tok):
                    done = True
                    break
            req.t_last = now
            if req.drafter is not None and not done:
                req.drafter.extend(emitted)
            if tracing and req.ctx is not None:
                extra = {"accepted": accepted} if self._spec else {}
                trace.record_span("decode.iter", req.ctx, t_it0, now,
                                  slot=s, token_index=len(req.out), **extra)
            if done:
                self._active[s] = False
                self._slot_req[s] = None
                self._release_seq(req)
                self._resolve(req)
        self._occ_sum += n_active / S
        self._occ_n += 1
        self.occ_gauge.set(int(self._active.sum()) / S)
        t_first = self.t_first
        if t_first is not None and now > t_first:
            self.tps_gauge.set(self.tokens / (now - t_first))

    def _finished(self, req: _Request, tok: int) -> bool:
        eos = self.config.eos_id
        return (eos is not None and tok == eos) or len(req.out) >= req.max_new

    def _finalize_usage(self, req: _Request, outcome: str,
                        now: Optional[float] = None) -> None:
        """Fold a finished request's vector into its tenant's row, once
        (the vector detaches here), and record the ``acct.request``
        span."""
        usage = req.usage
        if usage is None:
            return
        req.usage = None
        if now is None:
            now = time.monotonic()
        usage.preemptions = req.preempts
        lat_ms = ((now - req.t_enq) * 1e3 if outcome == "completed"
                  else None)
        cost = self.ledger.finalize(usage, outcome, lat_ms)
        if trace.enabled() and req.ctx is not None:
            trace.record_span(
                "acct.request", req.ctx, req.t_enq, now,
                tenant=usage.tenant, cost=round(cost, 6), outcome=outcome,
                prefill_tokens=usage.prefill_tokens,
                prefill_tokens_saved=usage.prefill_tokens_saved,
                decode_tokens=usage.decode_tokens,
                kv_block_s=round(usage.kv_block_s, 6),
                device_step_ms=round(usage.device_step_ms, 3),
                queue_wait_ms=round(usage.queue_wait_ms, 3),
                xfer_bytes=usage.xfer_bytes,
                recompute_tokens=usage.recompute_tokens,
                preemptions=usage.preemptions)

    def _resolve(self, req: _Request) -> None:
        self._finalize_usage(req, "completed")
        self.completed += 1
        self._it_completed.append(req.rid)
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
            pending = self._q.drain()
            # release splice waiters: the loop applies no more
            while self._splice_q:
                _, done, info = self._splice_q.popleft()
                info["skipped"] = "engine failed"
                done.set()
        live = [r for r in self._slot_req if r is not None]
        if self._pf is not None:
            live.append(self._pf)
            self._pf = None
        if self._paged:
            # the dying requests' reservations go back (decref: a shared
            # block carries one holder per request)
            for req in live + (in_flight or []):
                if req.blocks:
                    self._pool.decref(req.blocks)
                    req.blocks = []
            self.unsqueeze_pool()
            self._block_tables[:] = SCRATCH_BLOCK
            self._bt_dirty = True
        self._active[:] = False
        self._slot_req = [None] * self.config.slots
        self._free_q = collections.deque(range(self.config.slots))
        seen = set()
        for req in pending + live + (in_flight or []):
            if id(req) in seen or req.future.done():
                continue
            seen.add(id(req))
            # what it consumed before the failure is still billed
            self._finalize_usage(req, "failed")
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(exc)

    # -- chaos hooks ----------------------------------------------------------
    def squeeze_pool(self, frac: float) -> int:
        """Chaos hook (``-chaos pool_squeeze=``): hold up to ``frac`` of
        the paged pool's capacity hostage, so live traffic sees a smaller
        pool and growth must preempt. Returns the blocks held (capped to
        what is reclaimable now); :meth:`unsqueeze_pool`, ``stop()`` and
        the failure path release them."""
        if not self._paged:
            return 0
        want = int(self._pool.capacity * float(frac))
        take = min(want, self._pool.n_free + self._pool.n_cached)
        if take <= 0:
            return 0
        try:
            self._squeezed.extend(self._pool.alloc(take))
        except RuntimeError:             # raced a concurrent admission
            return 0
        return take

    def unsqueeze_pool(self) -> int:
        """Release a staged :meth:`squeeze_pool`; returns blocks freed."""
        n = len(self._squeezed)
        if n:
            self._pool.decref(self._squeezed)
            self._squeezed = []
        return n

    # -- introspection --------------------------------------------------------
    def step_cache_size(self) -> int:
        """Distinct signatures the fused step was called with: 1 at any
        engine config (fixed slots, active-lane masking, block tables as
        data)."""
        return _signatures(self._step_fn)

    def prefill_cache_size(self) -> int:
        """Distinct signatures of the admission program: the one
        fixed-size chunk program when chunked, else one per prompt bucket
        used."""
        if self._budget > 0:
            return _signatures(self._chunk_fn)
        return _signatures(self._admit_fn)

    def verify_cache_size(self) -> int:
        """Distinct signatures of the verify step: 1 on a spec engine once
        it ran (the ``[S, spec_k + 1]`` window is its only shape), 0 when
        ``spec_k=0`` (no such program)."""
        if self._verify_fn is None:
            return 0
        return _signatures(self._verify_fn)

    @torch.no_grad()
    def warmup(self) -> None:
        """Run every serving program once at its serving signature against
        scratch caches, pinning the snapshot through the serving path, so
        no request pays a program's first call (allocator growth, library
        handles). Call it before taking traffic."""
        self._maybe_refresh()
        params = self._pinned
        S, dev = self.config.slots, self.device
        i64 = dict(dtype=torch.int64, device=dev)
        zero = torch.zeros((), **i64)

        def scratch():
            return tuple(torch.zeros_like(t) for t in self._pools())

        bt = (torch.full((S, self._blocks_per_seq), SCRATCH_BLOCK, **i64)
              if self._paged else None)
        if self._budget > 0:
            toks = torch.ones(self._budget, **i64)
            one = torch.ones((), **i64)
            if self._paged:
                self._chunk_fn(params, *scratch(), bt, zero, toks, zero, one)
            else:
                self._chunk_fn(params, *scratch(), zero, toks, zero, one)
        else:
            lens = torch.ones(1, **i64)
            for pb in self._prompt_buckets:
                toks = torch.ones((1, pb), **i64)
                where = bt[:1] if self._paged else torch.zeros(1, **i64)
                self._admit_fn(params, *scratch(), where, toks, lens)
        if self._cow_fn is not None:
            self._cow_fn(*scratch(), zero, zero)
        tok = torch.zeros(S, **i64)
        active = torch.zeros(S, dtype=torch.bool, device=dev)
        if self._verify_fn is not None:
            # the serving call's layout: columns of one [S, K + 4] upload
            ctl = torch.zeros((S, self._spec + 4), **i64)
            self._verify_fn(params, *scratch(), bt, ctl[:, 3:], ctl[:, 0],
                            ctl[:, 1] != 0, ctl[:, 2] + 1)
        if self._paged:
            self._step_fn(params, *scratch(), bt, tok, tok, active)
        else:
            self._step_fn(params, *scratch(), tok, tok, active)
        self._sync()

    def stats(self) -> dict:
        t_first = self.t_first
        elapsed = (time.monotonic() - t_first) if t_first else 0.0
        ttft = self.ttft_hist.percentiles((50, 99))
        itl = self.itl_hist.percentiles((50, 99))
        issued = self.completed + self.shed
        busy = self.prefill_s + self.decode_s
        pool: Dict[str, Any] = {"kv_block_size": 0}
        if self._paged:
            cfg = self._model_cfg
            lookups = self.prefix_hits + self.prefix_misses
            pool = {
                "kv_block_size": self._block_size,
                "kv_pool_blocks": self._pool.capacity,
                "kv_bytes_per_device": (self._pool.capacity + 1)
                * kv_bytes_per_block(cfg.n_layers, cfg.d_model,
                                     self._block_size, cfg.dtype,
                                     quant=self._kv_quant_mode),
                "kv_blocks_free": self._pool.n_free,
                "kv_blocks_live": self._pool.n_live,
                "kv_blocks_cached": self._pool.n_cached,
                "blocks_shared": self._pool.n_shared,
                "block_allocs": self._pool.allocs,
                "block_frees": self._pool.frees,
                "block_table_uploads": self.table_uploads,
                "prefix_cache": int(self._prefix),
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefix_hit_rate": (self.prefix_hits / lookups
                                    if lookups else 0.0),
                "prefill_tokens_saved": self.prefill_tokens_saved,
                "prefix_evictions": self._pool.evictions
                - self._evictions_base,
                "cow_copies": self.cow_copies,
            }
        # the int8 and speculation keys exist on such engines only, so
        # a plain engine's stats are the plain surface
        if self._kv_quant:
            # the device count of written blocks (one read; stats are
            # not the hot loop)
            nz = int((torch.maximum(self._k_scales, self._v_scales)
                      .amax(dim=0) > 0).sum())
            pool.update({
                "kv_quant": self._kv_quant_mode,
                "quant_scale_blocks": nz,
                "argmax_match_rate": self._argmax_match,
            })
        if self._param_quant == "int8":
            pool["decode_param_quant"] = self._param_quant
        if self.ledger is not None:
            # the accounting surface exists on ledger engines only;
            # accounting_drift is |sum over tenants - engine mirror| over
            # the integer fields, 0 at quiescence
            pool.update({
                **self.ledger.stats(),
                "accounting_drift": self.ledger.drift(
                    self.prefill_tokens, self.tokens, self.xfer_bytes),
            })
        if self._prefix:
            # the transfer plane (prefix-cache engines): raw K/V bytes
            # fetched out or spliced in, and the dedup hit rate
            moved = self.xfer_blocks + self.xfer_dedup
            pool.update({
                "kv_bytes_moved": self.xfer_bytes,
                "xfer_blocks": self.xfer_blocks,
                "xfer_dedup_blocks": self.xfer_dedup,
                "xfer_dedup_hit_rate": (self.xfer_dedup / moved
                                        if moved else 0.0),
            })
        if self._spec:
            pool.update({
                "spec_k": self._spec,
                "spec_steps": self.spec_steps,
                "spec_proposed": self.spec_proposed,
                "spec_accepted": self.spec_accepted,
                "acceptance_rate": (self.spec_accepted / self.spec_proposed
                                    if self.spec_proposed else 0.0),
                # extra tokens a verify dispatch bought, on average
                "accepted_per_step": (self.spec_accepted / self.spec_steps
                                      if self.spec_steps else 0.0),
                "verify_traces": self.verify_cache_size(),
            })
        health = self.health()
        return {
            **pool,
            "decode_step_retraces": max(0, self.step_cache_size() - 1),
            "pin_copies": self.pin_copies,
            "iters_total": health["iters_total"],
            "last_iter_age_s": health["last_iter_age_s"],
            "live_seqs": health["live_seqs"],
            "watchdog_trips": (self.watchdog.trip_count
                               if self.watchdog is not None else 0),
            "flight_records": (self.recorder.total
                               if self.recorder is not None else 0),
            "peak_live_seqs": self.peak_live,
            "preempt": int(self._preempt_on),
            "preemptions": self.preemptions,
            "preempted": self.preempted,
            "deadline_drops": self.deadline_drops,
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
            "step_traces": self.step_cache_size(),
            "prefill_traces": self.prefill_cache_size(),
            "prefill_token_budget": self._budget,
            "prefill_tokens": self.prefill_tokens,
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "prefill_share": self.prefill_s / busy if busy > 0 else 0.0,
        }

    def record_argmax_match(self, rate: float) -> None:
        """Attach an argmax-match rate measured outside (this engine's
        outputs against an fp engine's on the same prompts) to
        ``stats()["argmax_match_rate"]``."""
        self._argmax_match = float(rate)

    def reset_stats(self) -> None:
        """Zero the counters, histograms and mirrors (measure past a
        warmup)."""
        self.ttft_hist.reset()
        self.itl_hist.reset()
        self.completed = self.shed = self.tokens = 0
        self.peak_live = 0
        self.prefill_tokens = 0
        self.prefix_hits = self.prefix_misses = 0
        self.prefill_tokens_saved = self.cow_copies = 0
        self.spec_proposed = self.spec_accepted = self.spec_steps = 0
        self.preemptions = self.preempted = self.deadline_drops = 0
        self.xfer_blocks = self.xfer_bytes = self.xfer_dedup = 0
        self.prefill_s = self.decode_s = 0.0
        self._argmax_match = -1.0
        if self._paged:
            self._evictions_base = self._pool.evictions
        if self.ledger is not None:
            self.ledger.reset()
        self.t_first = None
        self._occ_sum = 0.0
        self._occ_n = 0

    # -- lifecycle ------------------------------------------------------------
    def stop(self) -> None:
        """Drain queued + in-flight generations, then retire the loop and
        its watchdog."""
        with self._cv:
            self._stop.set()
            self._cv.notify_all()
        self._thread.join(timeout=600)
        if self._paged:
            # a staged squeeze must not outlive the engine
            self.unsqueeze_pool()
        if self.watchdog is not None:
            self.watchdog.stop()
