"""Fenced parameter publish stream: one trainer, N serving subscribers.

Counterpart of ``multiverso_tpu/serving/param_plane.py`` (the codec
:86-146, ``ParamPublisher`` :149, ``ParamSubscriber`` :290), copied rather
than imported, with plain ``threading`` locks where the JAX module takes
``lockwatch`` ones. The ``mvparam`` wire is the JAX package's in both
directions.

The trainer (rank 0 on the ``mvparam`` labels) is the only publisher;
serving subscribers (ranks 1..N-1) each hold a local table replica and
apply the records in stream order. Records are the async-PS framing
(:func:`~multiverso_tpu_torch.parallel.async_ps._serialize`) and carry
**(epoch, version)**: epoch is the trainer's incarnation
(:func:`~multiverso_tpu_torch.parallel.async_ps.claim_epoch`), version
the publisher's post-apply table version, so a replica tracks the
trainer's version exactly.

Restart contract: each trainer incarnation claims the next epoch in the
coordination KV and publishes on a fresh label (``mvparam.e<E>``), its
first record a ``STATE`` rebase. Subscribers watch the epoch key and
switch streams when it moves; every record also passes an
:class:`~multiverso_tpu_torch.parallel.async_ps.EpochFence`, so a zombie
record (a stale epoch on any stream, the ``zombie_epoch`` chaos
directive) is rejected and counted. Subscribers expose ``params_age_s``
and the STALE verdict past ``-params_stale_after_s``.

bf16 tables ship their own 16-bit words (``io/stream``'s ``bfloat16``
records, torch bf16 tensors on the host side), so no ``ml_dtypes`` is
needed and a JAX subscriber receives the bytes it would from a JAX
trainer. ``KV`` records carry a ``kv`` table's adds (int64 keys,
float64 values) and its STATE rebase the sorted keys and values.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import config, trace
from ..dashboard import Dashboard
from ..log import Log
from ..parallel.async_ps import (DENSE, KEYED, KV, STATE, EpochFence,
                                 _deserialize, _kv_get_int, _serialize,
                                 claim_epoch)
from ..quantization import (SparseFilter, cast_host as _cast,
                            dequantize_int8, nbytes, quantize_int8,
                            wire_dtype)
from .faultinject import FaultPlan

LABEL = "mvparam"
TRAINER_RANK = 0

# -- wire codec ---------------------------------------------------------------
#
# Two encodings ride behind the array framing, told apart by array count
# and trailing dtype, so a subscriber needs no flag agreement:
#
# * DENSE   raw=[delta]            filtered=[blob, size int64]
#           quant=[q int8, scale fp32]
# * KEYED   raw=[ids, vals]        filtered=[ids, blob, size int64]
#           quant=[ids, q int8, scale fp32]
#
# Filtering (-param_wire_compress, default on) is lossless;
# -param_wire_quant int8 is lossy (per-tensor int8) and off by default.
# STATE rebases always ship raw.

_SIZE_INFO_DTYPE = np.dtype(np.int64)
_WIRE_FILTERS: Dict[Any, SparseFilter] = {}


def _is_size_info(a: Any) -> bool:
    return isinstance(a, np.ndarray) and a.dtype == _SIZE_INFO_DTYPE


def _filter_for(dtype) -> SparseFilter:
    """Memoized per-dtype :class:`SparseFilter`."""
    dt = wire_dtype(dtype)
    filt = _WIRE_FILTERS.get(dt)
    if filt is None:
        filt = _WIRE_FILTERS[dt] = SparseFilter(dtype=dt)
    return filt


def _dtype_of(a: Any) -> Any:
    return a.dtype if isinstance(a, (np.ndarray, torch.Tensor)) \
        else np.asarray(a).dtype


def encode_dense(host: Any, compress: bool, quant: str) -> list:
    """DENSE delta (numpy, or a bf16 tensor) -> wire arrays (JAX :86)."""
    if quant == "int8":
        q, s = quantize_int8(host)
        return [q, s]
    if compress:
        return _filter_for(_dtype_of(host)).filter_in([host])
    return [host]


def decode_dense(arrays, dtype, shape) -> Any:
    """Invert :func:`encode_dense` -> the dense delta, table-shaped (a
    torch CPU tensor for bf16, else numpy)."""
    if len(arrays) == 1:
        dense = _cast(arrays[0], dtype)
    elif _is_size_info(arrays[-1]):
        dense = _cast(_filter_for(dtype).filter_out(list(arrays))[0], dtype)
    else:
        dense = dequantize_int8(arrays[0], arrays[1], wire_dtype(dtype))
    return dense.reshape(shape)


def encode_keyed(ids: np.ndarray, vals: Any, compress: bool,
                 quant: str) -> list:
    """KEYED delta -> wire arrays; only ``vals`` is encoded."""
    if quant == "int8":
        q, s = quantize_int8(vals)
        return [ids, q, s]
    if compress:
        return [ids] + _filter_for(_dtype_of(vals)).filter_in([vals])
    return [ids, vals]


def decode_keyed(arrays, dtype):
    """Invert :func:`encode_keyed` -> ``(ids, vals)`` with ``vals``
    row-aligned to ``ids`` (the filtered form ships flat)."""
    ids = np.asarray(arrays[0], np.int32)
    if len(arrays) == 2:
        vals = arrays[1]
        return ids, (vals if isinstance(vals, torch.Tensor)
                     else np.asarray(vals))
    if _is_size_info(arrays[-1]):
        vals = _cast(_filter_for(dtype).filter_out(list(arrays[1:]))[0],
                     dtype)
        n_vals = vals.numel() if isinstance(vals, torch.Tensor) \
            else vals.size
        if ids.size and n_vals != ids.size:
            vals = vals.reshape(ids.size, -1)
        return ids, vals
    return ids, dequantize_int8(arrays[1], arrays[2], wire_dtype(dtype))


class ParamPublisher:
    """Trainer-side publish half (rank 0 of one ``label`` plane).

    Claims the next incarnation epoch (unless given one), advertises it
    in the KV, and publishes on the per-epoch stream label. The chaos
    plan hooks the publish point (``kill_trainer_at_publish``,
    ``zombie_epoch``) — see :mod:`.faultinject`.
    """

    def __init__(self, client: Any, size: int, label: str = LABEL,
                 epoch: Optional[int] = None,
                 chaos: Optional[FaultPlan] = None,
                 kill_fn: Optional[Callable[[], None]] = None,
                 wire_compress: Optional[bool] = None,
                 wire_quant: Optional[str] = None) -> None:
        from ..parallel.p2p import P2PTransport

        self._client = client
        self._label = label
        self.wire_compress = (
            bool(config.get_flag("param_wire_compress"))
            if wire_compress is None else bool(wire_compress))
        self.wire_quant = (
            str(config.get_flag("param_wire_quant"))
            if wire_quant is None else str(wire_quant))
        if self.wire_quant not in ("none", "int8"):
            Log.fatal(f"param plane: unknown param_wire_quant "
                      f"{self.wire_quant!r} (none|int8)")
        # wire-codec ledger: payload bytes actually sent vs what the
        # raw (uncoded) delta arrays would have cost — the
        # wire_compressed_ratio denominator. Delta records only; STATE
        # rebases ship raw by contract and count into both sides
        # equally via publish_record's payload tally.
        self.publish_bytes = 0
        self._delta_raw_bytes = 0
        self._delta_wire_bytes = 0
        self.epoch = (claim_epoch(client, f"{label}/epoch")
                      if epoch is None else int(epoch))
        if epoch is not None:
            # explicit epoch (tests): still advertise it so subscribers
            # attach this stream generation
            client.key_value_set(f"{label}/epoch", str(self.epoch),
                                 allow_overwrite=True)
        self.chaos = chaos if chaos is not None else FaultPlan(
            "", kill_fn=kill_fn)
        if kill_fn is not None and chaos is not None:
            self.chaos._kill_fn = kill_fn
        self._transport = P2PTransport(
            TRAINER_RANK, int(size), client,
            label=f"{label}.e{self.epoch}", subscribe_to=[])
        self._seq = 0
        self.publishes = 0
        self._counter = Dashboard.get_or_create_counter("PARAM_PUBLISHES")
        self._bytes_counter = Dashboard.get_or_create_counter(
            "PARAM_PUBLISH_BYTES")
        Log.info("param plane: publisher up (epoch %d, %d subscriber "
                 "slot(s))", self.epoch, int(size) - 1)

    # -- publish API ---------------------------------------------------------
    def publish_state(self, table) -> None:
        """The rebase record: absolute table value at its exact version
        — a restarted incarnation's FIRST publish, re-converging every
        subscriber in one record. Works for any table implementing the
        STATE protocol (``_state_arrays``: array tables ship one host
        array, KVTable ships keys+vals)."""
        if not hasattr(table, "_state_arrays"):
            Log.fatal(f"param plane: {type(table).__name__} has no STATE "
                      f"protocol (_state_arrays)")
        arrays, version = table._state_arrays()
        self.publish_record(STATE, table.table_id, arrays,
                            version=version)

    def publish_delta(self, table, delta, option=None,
                      version: Optional[int] = None) -> None:
        """Publish a dense delta the trainer ALREADY applied locally
        (``version`` defaults to the table's current = post-apply
        version; single-writer trainer contract)."""
        host = _cast(delta, table.dtype).reshape(table.shape)
        arrays = encode_dense(host, self.wire_compress, self.wire_quant)
        self._note_delta_bytes([host], arrays)
        self.publish_record(
            DENSE, table.table_id, arrays, option=option,
            version=table.version if version is None else int(version))

    def publish_keyed(self, table, ids, vals, option=None,
                      version: Optional[int] = None) -> None:
        ids = np.asarray(ids, np.int32).ravel()
        vals = (vals.detach().cpu() if isinstance(vals, torch.Tensor)
                else np.asarray(vals))
        arrays = encode_keyed(ids, vals, self.wire_compress,
                              self.wire_quant)
        self._note_delta_bytes([ids, vals], arrays)
        self.publish_record(
            KEYED, table.table_id, arrays, option=option,
            version=table.version if version is None else int(version))

    def _note_delta_bytes(self, raw, encoded) -> None:
        self._delta_raw_bytes += sum(nbytes(a) for a in raw)
        self._delta_wire_bytes += sum(nbytes(a) for a in encoded)

    def publish_kv(self, table, keys, vals,
                   version: Optional[int] = None) -> None:
        """A ``kv`` table's adds, which the trainer ALREADY applied
        (``version`` defaults to the table's current one)."""
        self.publish_record(
            KV, table.table_id,
            [np.asarray(keys, np.int64), np.asarray(vals, np.float64)],
            version=table.version if version is None else int(version))

    def publish_record(self, kind: int, table_id: int, arrays,
                       option=None, version: int = 0,
                       epoch: Optional[int] = None) -> None:
        """Low-level publish (the zombie tests stamp an explicit stale
        ``epoch`` here). Consults the chaos plan BEFORE the send: a
        ``kill_trainer_at_publish`` trainer dies with the record
        unsent — the journaled-but-unpublished update recovery must
        replay."""
        k = self.publishes + 1
        self.chaos.on_trainer_publish(k)      # may os._exit (chaos)
        if epoch is None:
            epoch = self.chaos.publish_epoch(k, self.epoch)
        sp = trace.start_span("param.publish", table_id=table_id,
                              epoch=epoch, version=version)
        payload = _serialize(kind, table_id, option, arrays, sp.context,
                             epoch=epoch, version=version)
        self._transport.send(self._seq, payload)
        self._seq += 1
        self.publishes = k
        self.publish_bytes += len(payload)
        self._counter.inc()
        self._bytes_counter.inc(len(payload))
        sp.end(bytes=len(payload))

    def stats(self) -> Dict[str, Any]:
        return {"epoch": self.epoch, "publishes": self.publishes,
                "publish_bytes": self.publish_bytes,
                "wire_compressed_ratio": (
                    self._delta_wire_bytes
                    / max(self._delta_raw_bytes, 1)),
                "chaos": self.chaos.stats()}

    def stop(self) -> None:
        self._transport.stop()


class ParamSubscriber:
    """Serving-side apply half: one per replica process.

    Applies the trainer stream into local ``tables`` (a list or
    ``{table_id: table}``) in publish order, fencing every record's
    epoch, and exposes the params-staleness surface serving health
    checks read.
    """

    def __init__(self, client: Any, tables, rank: int, size: int,
                 label: str = LABEL, poll_s: float = 0.02,
                 stale_after_s: Optional[float] = None,
                 start: bool = True) -> None:
        if not 1 <= int(rank) < int(size):
            raise ValueError(f"subscriber rank {rank} outside "
                             f"[1, {size})")
        self._client = client
        self._label = label
        self.rank = int(rank)
        self._size = int(size)
        self._poll_s = float(poll_s)
        if isinstance(tables, dict):
            self._tables = dict(tables)
        else:
            self._tables = {t.table_id: t for t in tables}
        self.stale_after_s = (
            float(config.get_flag("params_stale_after_s"))
            if stale_after_s is None else float(stale_after_s))
        self._fence = EpochFence(f"param.r{self.rank}")
        self._transport = None
        self._expect = 0
        self._cur_epoch = 0
        # epoch-key probe cadence: a restart is a once-per-incident
        # event, so the KV is asked at ~4 Hz, not once per apply poll
        # (a client whose only read is a 200 ms blocking get would
        # otherwise cap the apply cadence at 5 Hz). Stream-less
        # subscribers probe every poll: attach latency is their job.
        self._epoch_check_s = max(0.25, self._poll_s)
        self._next_epoch_check = 0.0
        self.applied = 0
        self.states_applied = 0
        self.epoch_switches = 0
        self._lock = threading.Lock()
        self._last_apply = time.monotonic()
        self._counter = Dashboard.get_or_create_counter("PARAM_APPLIES")
        self._age_gauge = Dashboard.get_or_create_gauge(
            f"SERVE_PARAMS_AGE[param.r{self.rank}]")
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name=f"mvparam-sub-{self.rank}",
            daemon=True)
        if start:
            self._thread.start()

    # -- stream management ---------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self._poll_s):
            try:
                self.poll_once()
            except Exception as exc:   # pragma: no cover - wire races
                if not self._stop.is_set():
                    Log.error("param plane: subscriber %d poll failed: "
                              "%s", self.rank, exc)

    def poll_once(self) -> int:
        """Attach the current epoch's stream (switching off a dead
        incarnation's) and apply everything ready; returns the applied
        count. Tests drive it directly with ``start=False``."""
        now = time.monotonic()
        if self._transport is None or now >= self._next_epoch_check:
            self._next_epoch_check = now + self._epoch_check_s
            epoch = _kv_get_int(self._client, f"{self._label}/epoch", 0)
            # highest-epoch-wins, like the record fence: a key read that
            # comes back 0/stale (transient KV failure, an operator
            # rewinding the key) must never detach a LIVE stream onto a
            # dead lower-epoch label whose records the fence would then
            # reject — that would wedge the subscriber silently
            if epoch > self._cur_epoch:
                self._attach(epoch)
        if self._transport is None:
            return 0
        applied = 0
        while not self._stop.is_set():
            payload = self._transport.pop_ready(TRAINER_RANK,
                                                self._expect)
            if payload is None:
                break
            self._expect += 1
            self._apply(payload)
            applied += 1
        return applied

    def _attach(self, epoch: int) -> None:
        """Switch to the incarnation's stream: the epoch key moving IS
        the restart signal — the old stream is dead by contract (its
        publisher claimed no successor records), and the new one's
        first record is the STATE rebase, so dropping the old
        subscription loses nothing a rebase doesn't supersede."""
        from ..parallel.p2p import P2PTransport

        old, self._transport = self._transport, None
        if old is not None:
            # tear the dead incarnation's transport down OFF the apply
            # path: its subscriber thread is typically deep in a
            # reconnect backoff against the dead endpoint, and joining
            # it here would stall re-convergence by whole backoff
            # periods (measured ~5s -> ~1s recovery)
            threading.Thread(target=old.stop,
                             name=f"mvparam-reap-{self._cur_epoch}",
                             daemon=True).start()
        Log.info("param plane: subscriber %d attaching epoch-%d stream"
                 " (was %d)", self.rank, epoch, self._cur_epoch)
        self._transport = P2PTransport(
            self.rank, self._size, self._client,
            label=f"{self._label}.e{epoch}",
            subscribe_to=[TRAINER_RANK],
            initial_resume={TRAINER_RANK: 0})
        self._expect = 0
        self._cur_epoch = epoch
        self.epoch_switches += 1

    # -- apply ---------------------------------------------------------------
    def _apply(self, payload: bytes) -> None:
        (kind, table_id, option, arrays, _, ctx, epoch,
         version) = _deserialize(payload)
        sp = (trace.start_span("param.apply", parent=ctx,
                               table_id=table_id)
              if ctx is not None else trace.NULL_SPAN)
        if not self._fence.admit(epoch):
            Log.error("param plane: subscriber %d rejected epoch-%d "
                      "record (fence at %d)", self.rank, epoch,
                      self._fence.epoch)
            sp.end(error="epoch_fenced", epoch=epoch)
            return
        table = self._tables.get(table_id)
        if table is None:
            Log.error("param plane: record for unknown table %d",
                      table_id)
            sp.end(error="unknown_table")
            return
        if kind == STATE:
            table._install_state_arrays(arrays, version, epoch)
            self.states_applied += 1
        elif kind == DENSE:
            table._apply_remote_dense(
                decode_dense(arrays, table.dtype, table.shape), option)
            self._pin_version(table, version, epoch)
        elif kind == KEYED:
            ids, vals = decode_keyed(arrays, table.dtype)
            table._apply_remote_keyed(ids, vals, option)
            self._pin_version(table, version, epoch)
        elif kind == KV:
            table._apply_remote_kv(arrays[0], arrays[1])
            self._pin_version(table, version, epoch)
        else:
            Log.error("param plane: unknown record kind %d", kind)
            sp.end(error="unknown_kind")
            return
        with self._lock:
            self.applied += 1
            self._last_apply = time.monotonic()
        self._counter.inc()
        sp.end(version=version, epoch=epoch)

    @staticmethod
    def _pin_version(table, version: int, epoch: int) -> None:
        """Mirror the publisher's version identity: the replica's state
        after this apply IS the trainer's state at ``version`` (stream
        order + single writer), so serving health reports the fleet's
        true convergence point rather than a rank-local counter."""
        if not version:
            return
        with table._lock:
            table.version = int(version)
            if epoch:
                table.epoch = int(epoch)

    # -- staleness surface ---------------------------------------------------
    def params_age_s(self) -> float:
        """Seconds since the last applied record — the subscriber-side
        publish-stream-silent signal (also shipped as the
        SERVE_PARAMS_AGE gauge)."""
        with self._lock:
            age = time.monotonic() - self._last_apply
        self._age_gauge.set(age)
        return age

    def params_stale(self) -> bool:
        return (self.stale_after_s > 0
                and self.params_age_s() > self.stale_after_s)

    def stats(self) -> Dict[str, Any]:
        versions = {tid: int(t.version)
                    for tid, t in self._tables.items()}
        return {
            "rank": self.rank,
            "epoch": self._cur_epoch,
            "fence_epoch": self._fence.epoch,
            "fence_rejections": self._fence.rejections,
            "applied": self.applied,
            "states_applied": self.states_applied,
            "epoch_switches": self.epoch_switches,
            "params_age_s": self.params_age_s(),
            "params_stale": self.params_stale(),
            "table_versions": versions,
        }

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)
        if self._transport is not None:
            self._transport.stop()
