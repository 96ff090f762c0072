"""Session-level checkpoint/resume.

Counterpart of ``multiverso_tpu/io/checkpoint.py``. The reference leaves
checkpointing to each table's ``Serializable`` Store/Load
(``include/multiverso/table_interface.h:59-66`` in the Multiverso
reference) with no automatic driver. Here the driver exists:
``save``/``restore`` walk the session's table registry and write one
``MVTA`` record per table plus a JSON manifest (per-table type, name,
file and version watermark), the JAX package's files, so a checkpoint
written by either package restores in the other: the manifest compares
``type(table).__name__``, and the port's table classes carry the JAX
names (``ArrayTable``, ``MatrixTable``, ``SparseTable``, ``FTRLTable``,
``KVTable``). ``restore_latest`` skips torn step directories and replays
the write-ahead journal (``io/wal.py``) past the watermarks;
``Autosaver`` writes ``root/step_N`` every N steps with retention and
reaps the journal segments a completed checkpoint covers.

Roots may be local paths, ``file://`` URIs or ``memory://`` URIs
(``io/remote.py``). ``save_orbax``/``restore_orbax`` (per-shard parallel
IO of sharded arrays through orbax) raise :class:`~..log.FatalError`:
their counterpart, torch.distributed checkpointing of sharded tables, is
ROADMAP.md Queue 1 item 8. The Autosaver's lock is a plain
``threading.Lock`` (the lock-order witness is item 9).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import List, Optional, Tuple

from ..log import Log
from ..runtime import Session
from .stream import is_remote, open_stream


def _join(directory: str, name: str) -> str:
    """Path join that preserves URI schemes (``gs://...`` stays a URI)."""
    return directory.rstrip("/") + "/" + name if is_remote(directory) \
        else os.path.join(directory, name)

_MANIFEST = "manifest.json"
_STEP_DIR = re.compile(r"^step_(\d+)$")


def save(directory: str, session: Optional[Session] = None
         ) -> Optional[dict]:
    """Store every registered table under ``directory``.

    The manifest records each table's version WATERMARK — the version
    of the exact bytes stored, captured atomically with the copy
    (``table.store`` returns it) — which is what bounds WAL replay:
    ``restore`` re-installs the watermark and ``restore_latest``
    replays only journal records past it. Returns the manifest on
    rank 0 (None elsewhere)."""
    sess = session or Session.get()
    if not sess.started:
        Log.fatal("save() requires an initialised session")
    sess.barrier()
    manifest = None
    if sess.rank == 0:
        if not is_remote(directory):
            os.makedirs(directory, exist_ok=True)
        manifest = {"version": 1, "tables": []}
        for table in sess.tables:
            name = f"table_{table.table_id}.bin"
            with open_stream(_join(directory, name), "wb") as stream:
                watermark = table.store(stream)
            manifest["tables"].append({
                "id": table.table_id,
                "type": type(table).__name__,
                "name": getattr(table, "name", ""),
                "file": name,
                "version": (int(watermark) if watermark is not None
                            else None),
            })
        with open_stream(_join(directory, _MANIFEST), "wb") as f:
            f.write(json.dumps(manifest, indent=2).encode("utf-8"))
        Log.info("checkpoint saved: %d table(s) -> %s", len(sess.tables),
                 directory)
    sess.barrier()
    return manifest


def restore(directory: str, session: Optional[Session] = None) -> None:
    """Load every registered table from ``directory`` (ids must match the
    creation order, as in the reference's table-id registry)."""
    sess = session or Session.get()
    if not sess.started:
        Log.fatal("restore() requires an initialised session")
    manifest_path = _join(directory, _MANIFEST)
    try:
        with open_stream(manifest_path, "rb") as f:
            manifest = json.loads(f.read().decode("utf-8"))
    except FileNotFoundError:
        Log.fatal(f"no checkpoint manifest at {manifest_path}")
    by_id = {entry["id"]: entry for entry in manifest["tables"]}
    for table in sess.tables:
        entry = by_id.get(table.table_id)
        if entry is None:
            Log.fatal(f"checkpoint missing table id {table.table_id}")
        if entry["type"] != type(table).__name__:
            Log.fatal(
                f"checkpoint table {table.table_id} is {entry['type']}, "
                f"session has {type(table).__name__}")
        with open_stream(_join(directory, entry["file"]), "rb") as stream:
            table.load(stream)
        if entry.get("version") is not None:
            # install the manifest's version WATERMARK: load() bumped
            # the local counter, but these bytes ARE the watermarked
            # state — WAL replay targets version > watermark and must
            # land on the exact pre-crash version
            with table._lock:
                table.version = int(entry["version"])
    Log.info("checkpoint restored: %d table(s) <- %s", len(sess.tables),
             directory)


def save_orbax(directory: str, session: Optional[Session] = None) -> None:
    """Orbax-backed per-shard checkpoint: not in this port (it writes
    sharded ``jax.Array``s); raises :class:`~..log.FatalError`."""
    Log.fatal("save_orbax is not ported to multiverso_tpu_torch: sharded "
              "tables' checkpoints wait for torch.distributed checkpointing "
              "(ROADMAP.md Queue 1 item 8); use save()")


def restore_orbax(directory: str, session: Optional[Session] = None) -> None:
    """Restore of a :func:`save_orbax` checkpoint: raises
    :class:`~..log.FatalError`, as :func:`save_orbax` does."""
    Log.fatal("restore_orbax is not ported to multiverso_tpu_torch: sharded "
              "tables' checkpoints wait for torch.distributed checkpointing "
              "(ROADMAP.md Queue 1 item 8); use restore()")


def _step_dirs(root: str) -> List[Tuple[int, str]]:
    """(step, directory-name) of complete checkpoints, ascending by step.

    Directory names are preserved verbatim — zero-padded names like
    ``step_000010`` must restore from their actual path, not a
    reconstructed ``step_10``.
    """
    if is_remote(root):
        from . import remote

        names = remote.list_subdirs_with(root, _MANIFEST)
    elif os.path.isdir(root):
        names = [name for name in os.listdir(root)
                 if os.path.exists(os.path.join(root, name, _MANIFEST))]
    else:
        return []
    found = []
    for name in names:
        m = _STEP_DIR.match(name)
        if m:
            found.append((int(m.group(1)), name))
    return sorted(found)


def list_steps(root: str) -> List[int]:
    """Completed checkpoint steps under ``root``, ascending."""
    return [step for step, _ in _step_dirs(root)]


def verify_step(directory: str) -> Optional[str]:
    """None when ``directory`` holds a complete restorable checkpoint;
    else a short reason (missing/unreadable manifest, missing or
    truncated table file). Local-path checkpoints only — object-store
    checkpoints commit by manifest-last write order and are trusted."""
    if is_remote(directory):
        return None
    manifest_path = _join(directory, _MANIFEST)
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError, ValueError) as exc:
        return f"manifest unreadable ({exc})"
    from .stream import validate_record_stream

    for entry in manifest.get("tables", []):
        name = entry.get("file")
        if name is None:
            continue              # orbax-storage entries verify on load
        path = os.path.join(directory, name)
        if not os.path.exists(path):
            return f"missing table file {name}"
        problem = validate_record_stream(path)
        if problem:
            return f"{name}: {problem}"
    return None


#: stats of the most recent restore_latest WAL replay (None = no replay
#: ran) — benches/tests read it next to the returned step
LAST_WAL_REPLAY: Optional[dict] = None


def restore_latest(root: str, session: Optional[Session] = None,
                   wal_dir: Optional[str] = None,
                   wal_rank: Optional[int] = None) -> Optional[int]:
    """Restore the newest COMPLETE checkpoint under ``root``, then
    replay the write-ahead journal past its version watermarks.

    A torn/incomplete step dir (missing manifest, truncated or missing
    table file — a crash mid-save on a filesystem without atomic
    rename, or a partially-copied archive) is detected BEFORE any table
    is touched and skipped loudly, falling back to the newest complete
    step instead of failing or half-loading.

    WAL replay: with ``wal_dir`` given (or the ``-wal``/``-wal_dir``
    flags set), journal records with version > the restored watermark
    are replayed in version order, reaching the exact pre-crash table
    state; the replay stats land in :data:`LAST_WAL_REPLAY`. Reaped
    segments (``Autosaver`` reaps those a completed checkpoint covers)
    are gone from disk, so replay work is bounded by one checkpoint
    interval.

    Returns the restored step, or None if no restorable checkpoint
    exists (fresh start — the journal, if any, still replays from
    version 0, so a pre-first-checkpoint crash loses nothing).
    """
    global LAST_WAL_REPLAY
    from .. import config

    LAST_WAL_REPLAY = None
    sess = session or Session.get()
    dirs = _step_dirs(root)
    restored = None
    for step, name in reversed(dirs):
        path = _join(root, name)
        problem = verify_step(path)
        if problem is not None:
            Log.error("checkpoint %s is torn/incomplete (%s); falling "
                      "back to the previous complete step", path,
                      problem)
            continue
        restore(path, sess)
        restored = step
        break
    if restored is None and dirs:
        Log.error("no restorable checkpoint under %s (%d torn step "
                  "dir(s) skipped)", root, len(dirs))
    if wal_dir is None and config.get_flag("wal"):
        wal_dir = config.get_flag("wal_dir")
    if wal_dir:
        from . import wal as _wal

        rank = (wal_rank if wal_rank is not None
                else (sess.rank if sess.started else 0))
        LAST_WAL_REPLAY = _wal.replay(wal_dir, rank, session=sess)
    return restored


class Autosaver:
    """Periodic checkpointing with retention — the automatic trigger the
    reference reserved but never implemented (``Test/main.cpp:293-331``
    comments; SURVEY §5.4 "not wired to any automatic trigger").

    Call :meth:`step` from the training loop; every ``every_steps`` steps
    (and/or ``every_seconds`` wall-clock) it writes ``root/step_N`` and
    prunes to the ``keep`` newest. Writes are atomic at the directory level
    (written to ``.tmp`` then renamed) so a crash mid-save never corrupts
    the latest restorable checkpoint.
    """

    def __init__(self, root: str, every_steps: int = 0,
                 every_seconds: float = 0.0, keep: int = 3,
                 session: Optional[Session] = None) -> None:
        if every_steps <= 0 and every_seconds <= 0:
            Log.fatal("Autosaver needs every_steps and/or every_seconds > 0")
        sess = session or Session.get()
        if every_seconds > 0 and sess.started and sess.size > 1:
            # save() is collective (barriers); a rank-local wall clock lets
            # processes disagree on whether a save is due and deadlock.
            Log.fatal("Autosaver: every_seconds is rank-local and unsafe in "
                      "multi-process runs — use every_steps (deterministic "
                      "across ranks)")
        self._root = root
        self._every_steps = every_steps
        self._every_seconds = every_seconds
        self._keep = max(keep, 1)
        self._session = session
        self._last_time = time.monotonic()
        self._lock = threading.Lock()

    def step(self, step: int) -> bool:
        """Maybe checkpoint at ``step``; returns True if a save happened."""
        due = (self._every_steps > 0 and step > 0
               and step % self._every_steps == 0)
        if not due and self._every_seconds > 0:
            sess = self._session or Session.get()
            if sess.started and sess.size > 1:
                # checked here (not just __init__) because the session may
                # start after construction; fails on the FIRST step, before
                # rank-local clocks can disagree and deadlock the collective
                # save. every_steps-triggered saves are deterministic and
                # stay allowed.
                Log.fatal("Autosaver: every_seconds is rank-local and "
                          "unsafe in multi-process runs — use every_steps")
            due = time.monotonic() - self._last_time >= self._every_seconds
        if not due:
            return False
        self.save_now(step)
        return True

    def save_now(self, step: int) -> None:
        with self._lock:
            sess = self._session or Session.get()
            final = _join(self._root, f"step_{step}")
            if is_remote(self._root):
                # object stores have no atomic rename; the manifest is
                # written LAST by save() and _step_dirs only counts
                # manifest-bearing dirs, so manifest-commit is the atomic
                # point
                manifest = save(final, sess)
                if sess.rank == 0:
                    self._prune()
            else:
                tmp = final + ".tmp"
                if os.path.isdir(tmp):
                    shutil.rmtree(tmp)
                manifest = save(tmp, sess)
                if sess.rank == 0:
                    if os.path.isdir(final):
                        shutil.rmtree(final)
                    os.replace(tmp, final)
                    self._prune()
            sess.barrier()
            self._reap_wal(sess, manifest)
            self._last_time = time.monotonic()

    @staticmethod
    def _reap_wal(sess, manifest: Optional[dict]) -> None:
        """Bounded replay: once a checkpoint is COMPLETE (renamed into
        place, barrier passed), journal segments every record of which
        the checkpoint's version watermarks cover are dead weight —
        replay starts past the watermark — so reap them. Rank 0 reaps
        by the manifest it wrote; other ranks (``save`` returns None
        there) reap their per-rank journal by their OWN table versions
        as of the post-save barrier — their local records up to that
        point are superseded by the checkpoint a restart restores, and
        an unreaped journal would otherwise grow without bound on every
        rank but 0."""
        wal = getattr(sess, "wal", None)
        if wal is None:
            return
        if manifest is not None:
            watermarks = {entry["id"]: int(entry["version"])
                          for entry in manifest.get("tables", [])
                          if entry.get("version") is not None}
        else:
            watermarks = {t.table_id: int(t.version)
                          for t in sess.tables
                          if getattr(t, "version", None) is not None}
        if watermarks:
            wal.reap(watermarks)

    def _prune(self) -> None:
        old = _step_dirs(self._root)[:-self._keep]
        if is_remote(self._root):
            from . import remote

            for _, name in old:
                remote.delete_prefix(_join(self._root, name))
        else:
            for _, name in old:
                shutil.rmtree(os.path.join(self._root, name),
                              ignore_errors=True)
