"""Always-on flight recorder: a bounded ring of per-iteration engine records.

Counterpart of ``multiverso_tpu/serving/flight_recorder.py``. Every decode
engine iteration appends one small record (what the engine did, how long
the fused step took, who was admitted or completed, how deep and how old
the queue was, what the block pool held) into a preallocated ring. The
watchdog dumps it on a trip, and ``tools/engine_timeline.py`` renders a
dump after the fact. One tuple and one short-lock append per iteration,
host state only; nothing is serialized until someone asks.

Records carry the JAX recorder's columns (:data:`FIELDS`, positional), so
one tool reads the dumps of both packages. This engine fills the first
20, from ``it`` to ``quant_scale_blocks``:

======================  =====================================================
``it``                  iteration index (1-based, monotonic per engine)
``ts``                  ``time.monotonic()`` at record time (iteration end)
``busy_ms``             wall of this loop pass's work (admit + chunk + step)
``step_ms``             the fused decode step's share of ``busy_ms``
``live``                live slots after the pass
``reserved``            mid-prefill admissions (reserved-not-live slots)
``queue``               admission-queue depth after the pass
``queue_age_ms``        age of the oldest queued request (0 if empty)
``prefill_toks``        prompt tokens prefilled this pass
``decode_toks``         tokens emitted this pass (first tokens included)
``pool_free``           paged pool free blocks (-1 when contiguous)
``pool_live``           paged pool live blocks (-1 when contiguous)
``pool_shared``         live blocks held by >= 2 sequences (-1 contiguous)
``version``             pinned snapshot version (-1 before the first pin)
``admitted``            request ids admitted this pass (tuple)
``completed``           request ids completed this pass (tuple)
``spec_proposed``       drafts verified this pass (-1 when ``spec_k=0``)
``spec_accepted``       drafts accepted this pass (-1 when ``spec_k=0``)
``kv_quant``            1 for int8 pools, 0 for fp (-1 when contiguous)
``quant_scale_blocks``  live + cached blocks of an int8 pool (-1 otherwise)
======================  =====================================================

The later columns (tenant accounting, sequence-parallel chunks) come
with their features; a record without them reads everywhere, as the JAX
recorder's pre-feature records do. Timestamps are
monotonic; a wall/monotonic anchor taken at construction rebases exports
to epoch microseconds, the span export's timebase.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

# new columns append at the END: readers index the stable prefix
# positionally and read the tail with .get() defaults
FIELDS = ("it", "ts", "busy_ms", "step_ms", "live", "reserved", "queue",
          "queue_age_ms", "prefill_toks", "decode_toks", "pool_free",
          "pool_live", "pool_shared", "version", "admitted", "completed",
          "spec_proposed", "spec_accepted", "kv_quant",
          "quant_scale_blocks", "kv_block_s", "tenants_live", "sp_chunks")


def window_digest(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Whole-window utilization digest over dict records (oldest first).

    The window opens when the first retained iteration's work began
    (``ts - busy_ms``) and closes at the last record. ``gaps`` lists
    every idle bubble (time between consecutive records net of the later
    iteration's own work), largest first."""
    if not records:
        return {"wall_s": 0.0, "busy_frac": 0.0, "idle_frac": 0.0,
                "prefill_tokens": 0, "decode_tokens": 0,
                "prefill_share": 0.0, "steps": 0, "mean_step_ms": 0.0,
                "max_idle_gap_ms": 0.0, "peak_live": 0, "gaps": []}
    t0 = records[0]["ts"] - records[0]["busy_ms"] / 1e3
    wall = max(records[-1]["ts"] - t0, 1e-9)
    busy_s = sum(r["busy_ms"] for r in records) / 1e3
    steps = [r["step_ms"] for r in records if r["step_ms"] > 0.0]
    prefill = sum(r["prefill_toks"] for r in records)
    decode = sum(r["decode_toks"] for r in records)
    gaps = []
    for i in range(1, len(records)):
        gap = ((records[i]["ts"] - records[i - 1]["ts"]) * 1e3
               - records[i]["busy_ms"])
        if gap > 0.0:
            gaps.append({"t_s": round(records[i]["ts"] - t0, 6),
                         "gap_ms": round(gap, 3),
                         "it": records[i]["it"]})
    gaps.sort(key=lambda g: g["gap_ms"], reverse=True)
    return {
        "wall_s": wall,
        "busy_frac": min(1.0, busy_s / wall),
        "idle_frac": max(0.0, 1.0 - busy_s / wall),
        "prefill_tokens": prefill,
        "decode_tokens": decode,
        "prefill_share": (prefill / (prefill + decode)
                          if prefill + decode else 0.0),
        "steps": len(steps),
        "mean_step_ms": sum(steps) / len(steps) if steps else 0.0,
        "max_idle_gap_ms": gaps[0]["gap_ms"] if gaps else 0.0,
        "peak_live": max(r["live"] + r["reserved"] for r in records),
        "gaps": gaps,
    }


class FlightRecorder:
    """Bounded ring of per-iteration records (oldest overwritten)."""

    def __init__(self, capacity: int = 4096, name: str = "") -> None:
        if capacity < 1:
            raise ValueError(f"FlightRecorder capacity must be >= 1, "
                             f"got {capacity}")
        self.name = name
        self.capacity = int(capacity)
        # static engine facts the owner attaches once; they ride every
        # summary() and the JSONL meta line
        self.meta: Dict[str, Any] = {}
        self._buf: List[Optional[tuple]] = [None] * self.capacity
        self._pos = 0
        self._n = 0
        self.total = 0                     # records ever written
        self._lock = threading.Lock()
        # monotonic -> epoch anchor (export timebase, merges with spans)
        self._anchor_wall = time.time()
        self._anchor_mono = time.monotonic()

    # -- write (the engine loop) --------------------------------------------
    def record(self, rec: tuple) -> None:
        """Append one record (a tuple in :data:`FIELDS` order, possibly
        without the tail columns)."""
        with self._lock:
            self._buf[self._pos] = rec
            self._pos = (self._pos + 1) % self.capacity
            self._n = min(self._n + 1, self.capacity)
            self.total += 1

    # -- read ---------------------------------------------------------------
    def _tuples(self) -> List[tuple]:
        with self._lock:
            if self._n < self.capacity:
                out = self._buf[: self._n]
            else:
                out = self._buf[self._pos:] + self._buf[: self._pos]
        return [r for r in out if r is not None]

    def records(self) -> List[Dict[str, Any]]:
        """Retained records as dicts, oldest first."""
        return [dict(zip(FIELDS, r)) for r in self._tuples()]

    def to_epoch_us(self, t_mono: float) -> float:
        return (self._anchor_wall + (t_mono - self._anchor_mono)) * 1e6

    def summary(self) -> Dict[str, Any]:
        """Whole-ring utilization digest: ``idle_frac`` is 1 - busy/wall
        over the retained window, with the biggest single idle gap."""
        recs = self.records()
        out: Dict[str, Any] = {
            "name": self.name, "iterations": self.total,
            "retained": len(recs), "capacity": self.capacity,
            "wrapped": self.total > self.capacity,
            **self.meta,
        }
        digest = window_digest(recs)
        digest.pop("gaps")
        digest.pop("peak_live")
        out.update(digest)
        return out

    # -- export -------------------------------------------------------------
    def export_jsonl(self, path: str) -> int:
        """One meta line, then one JSON line per retained record (oldest
        first): the dump format ``tools/engine_timeline.py`` reads.
        Returns the record count written."""
        recs = self.records()
        with open(path, "w") as f:
            f.write(json.dumps({"flight_recorder": {
                "name": self.name, "capacity": self.capacity,
                "total": self.total, "retained": len(recs),
                "anchor_epoch_s": self._anchor_wall,
                "anchor_mono_s": self._anchor_mono,
                "fields": list(FIELDS),
                **self.meta,
            }}) + "\n")
            for rec in recs:
                f.write(json.dumps(rec) + "\n")
        return len(recs)

    def chrome_counter_events(self) -> List[dict]:
        """Chrome ``ph: "C"`` counter samples on the span export's
        epoch-µs timebase, one track family per engine."""
        pid = os.getpid()
        events: List[dict] = []
        prefix = f"fr/{self.name or 'engine'}"
        for r in self._tuples():
            ts = self.to_epoch_us(r[1])
            events.append({"name": f"{prefix}/slots", "ph": "C", "ts": ts,
                           "pid": pid, "tid": 0,
                           "args": {"live": r[4], "reserved": r[5]}})
            events.append({"name": f"{prefix}/queue", "ph": "C", "ts": ts,
                           "pid": pid, "tid": 0,
                           "args": {"depth": r[6]}})
            events.append({"name": f"{prefix}/tokens", "ph": "C", "ts": ts,
                           "pid": pid, "tid": 0,
                           "args": {"prefill": r[8], "decode": r[9]}})
            if r[10] >= 0:
                events.append({"name": f"{prefix}/kv_blocks", "ph": "C",
                               "ts": ts, "pid": pid, "tid": 0,
                               "args": {"free": r[10], "live": r[11],
                                        "shared": max(0, r[12])}})
            # the tail columns' tracks (length-guarded: this engine's
            # records stop after ``completed``)
            if len(r) > 17 and r[16] >= 0:
                events.append({"name": f"{prefix}/spec", "ph": "C",
                               "ts": ts, "pid": pid, "tid": 0,
                               "args": {"proposed": r[16],
                                        "accepted": r[17]}})
            if len(r) > 21 and r[21] >= 0:
                events.append({"name": f"{prefix}/tenants", "ph": "C",
                               "ts": ts, "pid": pid, "tid": 0,
                               "args": {"kv_block_s": r[20],
                                        "live": r[21]}})
        return events

    def merge_chrome(self, doc: dict) -> dict:
        """Merge the counter tracks into a span-export document
        (``trace.export_chrome()``), keeping the events time-sorted (a
        stable sort keeps B/E order at equal timestamps)."""
        events = list(doc.get("traceEvents", []))
        events.extend(self.chrome_counter_events())
        events.sort(key=lambda e: e["ts"])
        doc["traceEvents"] = events
        return doc

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"capacity": self.capacity, "retained": self._n,
                    "total": self.total}
