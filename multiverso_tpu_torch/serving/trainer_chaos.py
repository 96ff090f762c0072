"""The trainer-kill recovery leg: durable online learning under a crash.

Counterpart of ``tools/serving_bench.py::_trainer_chaos_ab`` (:1776-1970,
the serving bench's ``lm_trainer_chaos`` A/B) of the JAX package. One
deterministic add-and-publish stream runs twice over the real ``mvparam``
wire (``ParamPublisher`` -> ``ParamSubscriber``) into a replica table:
fault-free, then with a seeded ``kill_trainer_at_publish=K`` (optionally
with ``wal_torn_tail`` or ``wal_bad_crc`` staged on the journal through
``FaultPlan.attach_wal``) killing the trainer mid-stream. The recovery is
the JAX leg's choreography:

1. the kill: the journal closes with nothing more appended; the
   subscriber flags STALE after ``stale_after_s``;
2. the restart: the trainer's table is clobbered, ``restore_latest``
   restores the newest checkpoint and replays the journal past its
   watermark, a new ``DeltaWAL`` truncates any torn tail, a new publisher
   claims the next epoch and rebases the replica with a STATE record;
3. training goes on to the end of the stream. The JAX leg resumes at the
   acknowledged count; here it resumes at the recovered version, which is
   the same unless a staged torn/bad record cost the last acknowledged
   add (``updates_lost_at_recovery`` reports it, and the trainer redoes
   it from its input stream);
4. one staged zombie (an epoch-1 publish) must be fenced.

Outcome: ``updates_lost``, ``output_mismatches`` (trainer and replica of
the chaos leg bit-identical to each other and to the fault-free leg),
``epoch_fence_rejections_unexpected`` and ``trainer_recovery_time_s``
(restart begin -> replica re-converged), with the JAX leg's names;
``chip_smoke.py`` (phase 16) and the CPU tests both call
:func:`trainer_kill_leg`.

The deltas default to the JAX leg's (dense ``[rows, cols]`` standard
normals from ``default_rng(4200 + i)``); ``delta_fn(i) -> (ids, vals)``
gives keyed adds instead (``ids`` None for a dense delta). Every add runs
through the table's local path, so with the journal attached it is
journaled before it is acknowledged.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..log import Log


class LocalKV:
    """The three coordination-client calls the wire uses (set, blocking
    get, try get) over an in-process dict: the real two-rank wire inside
    one process."""

    def __init__(self) -> None:
        self._d: Dict[str, Any] = {}
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


_STALE_AFTER_S = 0.2    # the JAX leg's -params_stale_after_s
_CONVERGE_S = 120.0     # the most a replica may take to re-converge


class _Killed(Exception):
    pass


def _die() -> None:
    raise _Killed()


def dense_deltas(rows: int, cols: int) -> Callable[[int], Tuple[None, Any]]:
    """The JAX leg's deltas: add ``i`` is ``default_rng(4200 + i)``'s
    ``[rows, cols]`` standard normals in f32."""
    def delta(i: int):
        rng = np.random.default_rng(4200 + i)
        return None, rng.standard_normal((rows, cols)).astype(np.float32)
    return delta


def _wait(pred, timeout_s: float = _CONVERGE_S) -> bool:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.005)
    return True


def trainer_kill_leg(rows: int = 32, cols: int = 16,
                     dtype: torch.dtype = torch.float32, n_adds: int = 32,
                     every_steps: int = 5, wal_fault: str = "",
                     delta_fn: Optional[Callable] = None,
                     root: Optional[str] = None) -> Dict[str, Any]:
    """Run the fault-free and the chaos leg in the started session and
    return the outcome (see the module docstring). As in the JAX leg, the
    kill comes at publish ``n_adds // 2 + 1`` (publish 1 is the rebase),
    the Autosaver keeps 2 checkpoints and the replica flags STALE after
    0.2 s; ``every_steps`` is the Autosaver's period. ``wal_fault`` is
    ``""``, ``"wal_torn_tail"`` or ``"wal_bad_crc"``. ``root`` keeps the
    journals and checkpoints there (default: a temporary directory,
    removed at the end). The outcome holds each leg's final trainer and
    replica state as host arrays (``legs``, read with ``get_rows``: f32
    for a bf16 table)."""
    from .. import Session, create_table
    from ..io import checkpoint
    from ..io.wal import DeltaWAL
    from . import FaultPlan, ParamPublisher, ParamSubscriber

    kill_at = n_adds // 2 + 1
    delta_fn = delta_fn or dense_deltas(rows, cols)
    kv = LocalKV()
    sess = Session.get()
    own_root = root is None
    root = tempfile.mkdtemp(prefix="mv_trainer_chaos_") if own_root else root
    legs: Dict[str, Dict[str, Any]] = {}

    def apply(table, i):
        """Add ``i`` on the trainer; returning acknowledges it."""
        ids, vals = delta_fn(i)
        if ids is None:
            table.add(vals)
        else:
            table.add_rows(ids, vals)
        return ids, vals

    def publish(pub, table, ids, vals):
        if ids is None:
            pub.publish_delta(table, vals)
        else:
            pub.publish_keyed(table, ids, vals)

    try:
        for leg in ("off", "on"):
            wal_dir = os.path.join(root, leg, "wal")
            ck_root = os.path.join(root, leg, "ckpt")
            src = create_table("matrix", rows, cols, dtype=dtype,
                               name=f"tchaos_src_{leg}")
            dst = create_table("matrix", rows, cols, dtype=dtype,
                               name=f"tchaos_dst_{leg}")
            plane = f"tchaos_{leg}"
            chaos = ""
            if leg == "on":
                chaos = ",".join(x for x in (
                    f"kill_trainer_at_publish={kill_at}", wal_fault) if x)
            plan = FaultPlan(chaos, kill_fn=_die)
            sess.wal = DeltaWAL(wal_dir)
            plan.attach_wal(sess.wal)
            pub = ParamPublisher(kv, 2, label=plane, chaos=plan)
            sub = ParamSubscriber(kv, {src.table_id: dst}, rank=1, size=2,
                                  label=plane, poll_s=0.005,
                                  stale_after_s=_STALE_AFTER_S)
            saver = checkpoint.Autosaver(ck_root, every_steps=every_steps,
                                         keep=2)
            out = {"killed": False, "acked_at_kill": n_adds,
                   "updates_lost_at_recovery": 0, "recovery_s": 0.0,
                   "stale_peak_s": 0.0, "replayed": 0, "restored_step": -1,
                   "wal_truncated_at": -1, "replay_s": 0.0}
            acked = 0
            try:
                try:
                    pub.publish_state(src)
                    for i in range(n_adds):
                        ids, vals = apply(src, i)
                        acked += 1
                        saver.step(i + 1)
                        publish(pub, src, ids, vals)   # killed at kill_at
                except _Killed:
                    out["killed"] = True
                if out["killed"]:
                    # the crash: nothing more appends from this incarnation
                    sess.wal.close()
                    sess.wal = None
                    _wait(sub.params_stale, 15.0)
                    out["stale_peak_s"] = sub.params_age_s()
                    out["acked_at_kill"] = acked
                    # the restart: checkpoint + journal to the acknowledged
                    # state, the next epoch, a rebase, the rest of the run
                    t_restart = time.monotonic()
                    src._install_state(
                        np.zeros((rows, cols), np.float32), 0)
                    t0 = time.perf_counter()
                    out["restored_step"] = checkpoint.restore_latest(
                        ck_root, wal_dir=wal_dir, wal_rank=0) or 0
                    src.flush()
                    out["replay_s"] = time.perf_counter() - t0
                    out["replayed"] = checkpoint.LAST_WAL_REPLAY["replayed"]
                    out["updates_lost_at_recovery"] = acked - int(
                        src.version)
                    sess.wal = DeltaWAL(wal_dir)       # truncates the tail
                    out["wal_truncated_at"] = \
                        sess.wal.recovery["truncated_at"]
                    pub.stop()
                    pub = ParamPublisher(kv, 2, label=plane)   # epoch 2
                    pub.publish_state(src)
                    for i in range(int(src.version), n_adds):
                        publish(pub, src, *apply(src, i))
                    if not _wait(lambda: dst.version == src.version):
                        Log.error("trainer chaos: the replica did not "
                                  "re-converge in %.0f s", _CONVERGE_S)
                    out["recovery_s"] = time.monotonic() - t_restart
                    # the staged zombie: one stale-epoch publish
                    pub.publish_record(
                        0, src.table_id,
                        [np.full((rows, cols), 99.0, np.float32)],
                        epoch=1, version=src.version + 1)
                want_rej = 1 if out["killed"] else 0
                _wait(lambda: (dst.version == src.version
                               and sub.stats()["fence_rejections"]
                               >= want_rej))
                every_row = np.arange(rows)
                out.update({
                    # read through the row API (the gather kernel on the
                    # card), as a replica's readers read it
                    "src": src.get_rows(every_row),
                    "dst": dst.get_rows(every_row),
                    "version": int(src.version),
                    "dst_version": int(dst.version),
                    "rejections": sub.stats()["fence_rejections"],
                    "staged_rejections": want_rej,
                    "pub_stats": pub.stats(),
                    "plan_counts": dict(plan.counts),
                })
                legs[leg] = out
            finally:
                sub.stop()
                pub.stop()
                if sess.wal is not None:
                    sess.wal.close()
                    sess.wal = None
    finally:
        if sess.wal is not None:
            sess.wal.close()
            sess.wal = None
        if own_root:
            shutil.rmtree(root, ignore_errors=True)
    on, off = legs["on"], legs["off"]
    mismatches = int(not np.array_equal(on["src"], off["src"])) \
        + int(not np.array_equal(on["dst"], off["dst"])) \
        + int(not np.array_equal(on["dst"], on["src"]))
    unexpected = sum(leg["rejections"] - leg["staged_rejections"]
                     for leg in legs.values())
    return {
        "adds": n_adds,
        "kill_at_publish": kill_at,
        "trainer_killed": int(on["killed"]),
        "acked_at_kill": on["acked_at_kill"],
        "updates_lost": max(0, n_adds - on["version"])
        + max(0, on["updates_lost_at_recovery"]),
        "updates_lost_at_recovery": on["updates_lost_at_recovery"],
        "output_mismatches": mismatches,
        "epoch_fence_rejections_unexpected": unexpected,
        "trainer_recovery_time_s": on["recovery_s"],
        "staleness_peak_s": on["stale_peak_s"],
        "wal_replay_records": on["replayed"],
        "wal_replay_s": on["replay_s"],
        "wal_truncated_at": on["wal_truncated_at"],
        "checkpoint_step": on["restored_step"],
        "publish_bytes": off["pub_stats"]["publish_bytes"],
        "legs": legs,
    }
