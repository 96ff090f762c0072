"""Write-ahead delta journal: a per-rank durable log of acknowledged applies.

Counterpart of ``multiverso_tpu/io/wal.py``; the on-disk bytes are the
JAX package's, so a journal written by either package replays into the
other's tables. Li et al.'s Parameter Server (OSDI '14) makes *logged,
replayable updates* the core of PS recovery, and Check-N-Run (NSDI '22)
treats checkpoint + incremental-delta durability as a first-class serving
dependency. Every acknowledged LOCAL apply (``table.add`` returning is the
acknowledgment) appends one record here *before* the caller gets its
handle back, so a trainer crash loses nothing it acknowledged:
``io/checkpoint.py`` restores the newest complete checkpoint and replays
the journal records past its per-table version watermark to reach the
**exact** pre-crash version.

On-disk format (little-endian throughout):

* segment files ``wal-r<rank>-<index>.seg``: a 12-byte header
  (``MVWAL1\\n\\0`` magic + u32 rank) followed by records;
* record: ``<u32 crc><u32 length><i32 table_id><u64 version>`` +
  ``length`` payload bytes. The crc32 covers the header-sans-crc AND the
  payload, so a torn header, a torn payload or a bit flip all read as one
  thing: a bad record. The payload is the async-PS record
  (:func:`..parallel.async_ps._serialize`: kind, table_id, AddOption
  scalars, ``MVTA`` arrays, epoch, version), so a journal record and a
  parameter-plane record are the same bytes. A bf16 table's values are
  its raw 16-bit words (``io/stream``'s ``bfloat16`` tag).

Recovery: :func:`recover` scans segments in order and truncates **at the
first torn/bad-CRC record** (the file is truncated there and every later
segment deleted), so a later replay never re-reads ambiguous bytes. A new
:class:`DeltaWAL` runs recovery before opening a NEW segment.

Bounded replay: after a checkpoint completes, ``Autosaver`` calls
:meth:`DeltaWAL.reap` with its per-table version watermarks; closed
segments whose every record the watermark covers are deleted.

Locking: appends serialize the journal's in-memory books under its own
lock; the journal is never touched under a table lock (the write and
fsync are blocking IO), so an apply orders as apply -> release the table
lock -> journal. Replay therefore orders records by their post-apply
version per table; a version GAP (possible only when a crash lands
between two racing adders' appends) stops that table's replay loudly.
The locks are plain ``threading.Lock``s (the JAX package's lock-order
witness is ROADMAP.md Queue 1 item 9).

On the card, journaling a keyed add costs a host copy of its ids and
values in the table's dtype (the values usually arrive from the host, and
that staging copy is the one journaled).
"""

from __future__ import annotations

import os
import re
import struct
import threading
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..log import Log

_MAGIC = b"MVWAL1\n\x00"
_SEG_HEADER = struct.Struct("<I")           # rank
_REC = struct.Struct("<IIiQ")               # crc, length, table_id, version
_REC_TAIL = struct.Struct("<IiQ")           # length, table_id, version (crc'd)
_SEG_RE = re.compile(r"^wal-r(\d+)-(\d+)\.seg$")


def _record_crc(length: int, table_id: int, version: int,
                payload: bytes) -> int:
    crc = zlib.crc32(_REC_TAIL.pack(length, table_id, version))
    return zlib.crc32(payload, crc)


def _segment_name(rank: int, index: int) -> str:
    return f"wal-r{rank:03d}-{index:06d}.seg"


def segments(directory: str, rank: int) -> List[Tuple[int, str]]:
    """(index, path) of this rank's journal segments, ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _SEG_RE.match(name)
        if m and int(m.group(1)) == rank:
            out.append((int(m.group(2)), os.path.join(directory, name)))
    return sorted(out)


def _walk_segment(path: str, read_payloads: bool = True
                  ) -> Tuple[List[Tuple[int, int, int, Optional[bytes]]],
                             Optional[int]]:
    """THE one segment walker: ``([(offset, table_id, version,
    payload-or-None), ...], bad_offset)`` with ``bad_offset`` the first
    torn/bad record (None = clean to EOF). ``read_payloads=False``
    seeks past payloads without reading or CRC-checking them — the
    reaping path's O(records) mode; recovery/replay read + verify."""
    records: List[Tuple[int, int, int, Optional[bytes]]] = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(len(_MAGIC) + _SEG_HEADER.size)
        if (len(head) < len(_MAGIC) + _SEG_HEADER.size
                or head[:len(_MAGIC)] != _MAGIC):
            return records, 0
        while True:
            offset = f.tell()
            hdr = f.read(_REC.size)
            if not hdr:
                return records, None          # clean EOF at a boundary
            if len(hdr) < _REC.size:
                return records, offset        # torn header
            crc, length, table_id, version = _REC.unpack(hdr)
            if read_payloads:
                payload = f.read(length)
                if len(payload) < length:
                    return records, offset    # torn payload
                if _record_crc(length, table_id, version,
                               payload) != crc:
                    return records, offset    # bit rot / seeded bad crc
            else:
                payload = None
                if size - f.tell() < length:
                    return records, offset    # torn payload
                f.seek(length, 1)
            records.append((offset, table_id, version, payload))


def _scan_segment(path: str) -> Tuple[List[Tuple[int, int, bytes]],
                                      Optional[int]]:
    """Read+CRC walk: ``([(table_id, version, payload), ...],
    bad_offset)`` — recovery/replay's view."""
    records, bad = _walk_segment(path, read_payloads=True)
    return [(t, v, p) for _, t, v, p in records], bad


def _scan_segment_headers(path: str) -> Tuple[List[Tuple[int, int]],
                                              Optional[int]]:
    """Header-only walk: ``([(table_id, version), ...], bad_offset)``
    with payloads seeked past, never read or CRC'd — the reaping
    path's scan (corruption detection is recovery's job, and a
    checkpoint-covered segment is reapable regardless of payload
    rot)."""
    records, bad = _walk_segment(path, read_payloads=False)
    return [(t, v) for _, t, v, _ in records], bad


def recover(directory: str, rank: int = 0) -> Dict[str, int]:
    """Deterministic torn-tail recovery: truncate the journal at the
    FIRST torn/bad-CRC record and drop every later segment. Returns
    ``{"segments", "records", "truncated_segments", "truncated_at"}``
    (``truncated_at`` = -1 when the journal was clean)."""
    segs = segments(directory, rank)
    stats = {"segments": len(segs), "records": 0,
             "truncated_segments": 0, "truncated_at": -1}
    for i, (index, path) in enumerate(segs):
        records, bad = _scan_segment(path)
        stats["records"] += len(records)
        if bad is None:
            continue
        Log.error("wal: torn/bad record in %s at byte %d; truncating "
                  "there and dropping %d later segment(s)",
                  path, bad, len(segs) - i - 1)
        # a truncation that leaves no records (bad header, or the bad
        # record was the segment's first) removes the file outright
        empty = bad <= len(_MAGIC) + _SEG_HEADER.size
        if empty:
            os.remove(path)
        else:
            with open(path, "r+b") as f:
                f.truncate(bad)
        for _, later in segs[i + 1:]:
            os.remove(later)
        stats["truncated_at"] = bad
        # segments REMOVED: all later ones, plus this one when nothing
        # of it was left to keep
        stats["truncated_segments"] = (len(segs) - i if empty
                                       else len(segs) - i - 1)
        break
    return stats


def iter_records(directory: str, rank: int = 0
                 ) -> Iterator[Tuple[int, int, bytes, int]]:
    """Yield ``(table_id, version, payload, segment_index)`` across all
    segments in order, stopping (loudly) at the first bad record — run
    :func:`recover` first to make the stop a physical truncation."""
    for index, path in segments(directory, rank):
        records, bad = _scan_segment(path)
        for table_id, version, payload in records:
            yield table_id, version, payload, index
        if bad is not None:
            Log.error("wal: stopping read at torn record (%s byte %d); "
                      "records after it are discarded", path, bad)
            return


class DeltaWAL:
    """Append side of the journal (one per process rank).

    Construction RUNS RECOVERY (torn-tail truncation) and then opens a
    fresh segment — a restarted incarnation never appends into a file a
    crash may have torn.

    Concurrency/locking: appends go through an ``O_APPEND`` fd with one
    ``os.write`` per record — the kernel serializes the append offset,
    so racing appenders (and a racing rotation's old-fd stragglers)
    produce whole, non-interleaved records in SOME order; replay
    re-orders by version. The journal's lock guards only in-memory
    bookkeeping (fd swap, counters) — **no file IO ever runs under it**,
    and none of this ever runs under a table lock (the table layer
    orders apply -> unlock -> journal).
    """

    def __init__(self, directory: str, rank: int = 0,
                 segment_bytes: int = 64 << 20,
                 fsync: bool = False) -> None:
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.rank = int(rank)
        self.segment_bytes = max(int(segment_bytes), 1024)
        self.fsync = bool(fsync)
        self._lock = threading.Lock()
        self.appended = 0
        self.rotations = 0
        self.reaped_segments = 0
        self.recovery = recover(directory, self.rank)
        segs = segments(directory, self.rank)
        self._index = (segs[-1][0] + 1) if segs else 0
        self._fd: Optional[int] = None
        self._path = ""
        self._size = 0
        self._rotating = False
        # per-fd in-flight writer refcounts: a racing append captures
        # the current fd under the lock, and closing that fd under its
        # os.write would land the record in whatever file reuses the
        # descriptor next — so a rotated-out fd is only closed once its
        # last in-flight writer has left (O_APPEND keeps the straggler
        # record valid in the old segment; replay orders by version)
        self._fd_refs: Dict[int, int] = {}
        self._retired_fds: set = set()
        self._fd, self._path, self._size = self._open_segment(self._index)

    # -- write path --------------------------------------------------------
    def _open_segment(self, index: int):
        path = os.path.join(self.directory,
                            _segment_name(self.rank, index))
        fd = os.open(path, os.O_CREAT | os.O_WRONLY | os.O_APPEND,
                     0o644)
        size = os.path.getsize(path)
        if size == 0:
            header = _MAGIC + _SEG_HEADER.pack(self.rank)
            os.write(fd, header)
            size = len(header)
        return fd, path, size

    def append(self, table_id: int, version: int, payload: bytes) -> None:
        """Durably journal one applied record (post-apply ``version``)."""
        crc = _record_crc(len(payload), int(table_id), int(version),
                          payload)
        rec = _REC.pack(crc, len(payload), int(table_id),
                        int(version)) + payload
        with self._lock:
            fd = self._fd
            if fd is not None:
                self._fd_refs[fd] = self._fd_refs.get(fd, 0) + 1
                self._size += len(rec)
                self.appended += 1
                rotate = self._size >= self.segment_bytes
        if fd is None:
            Log.fatal("wal: append after close()")
        try:
            # one O_APPEND write per record: atomic end-of-file
            # positioning, no byte interleave with racing appenders
            os.write(fd, rec)
            if self.fsync:
                os.fsync(fd)
        finally:
            self._release_fd(fd)
        if rotate:
            self._rotate(fd)

    def _release_fd(self, fd: int) -> None:
        """Drop one in-flight writer; close the fd if it was rotated
        out and this writer was the last one on it."""
        to_close = None
        with self._lock:
            self._fd_refs[fd] -= 1
            if self._fd_refs[fd] == 0 and fd in self._retired_fds:
                self._retired_fds.discard(fd)
                del self._fd_refs[fd]
                to_close = fd
        if to_close is not None:
            os.close(to_close)

    def _rotate(self, old_fd: int) -> None:
        with self._lock:
            if (self._fd != old_fd or self._size < self.segment_bytes
                    or self._rotating):
                return      # a racing appender is already rotating / did
            # claim the rotation UNDER the lock: two appenders passing
            # the size check concurrently must not both open (and
            # double-header) the same next segment
            self._rotating = True
            next_index = self._index + 1
        fd, path, size = self._open_segment(next_index)
        to_close = None
        with self._lock:
            self._fd, self._path, self._size = fd, path, size
            self._index = next_index
            self.rotations += 1
            self._rotating = False
            if self._fd_refs.get(old_fd, 0) == 0:
                self._fd_refs.pop(old_fd, None)
                to_close = old_fd       # no writer in flight: close now
            else:
                self._retired_fds.add(old_fd)   # last writer closes it
        if to_close is not None:
            os.close(to_close)

    def close(self) -> None:
        to_close = []
        with self._lock:
            fd, self._fd = self._fd, None
            if fd is not None:
                if self._fd_refs.get(fd, 0) == 0:
                    self._fd_refs.pop(fd, None)
                    to_close.append(fd)
                else:
                    # a straggling append still writes; its release
                    # closes the fd (teardown order makes this rare)
                    self._retired_fds.add(fd)
            for r in list(self._retired_fds):
                if self._fd_refs.get(r, 0) == 0:
                    self._retired_fds.discard(r)
                    self._fd_refs.pop(r, None)
                    to_close.append(r)
        for f in to_close:
            if self.fsync:
                os.fsync(f)
            os.close(f)

    # -- bounded replay ----------------------------------------------------
    def reap(self, watermarks: Dict[int, int]) -> List[str]:
        """Delete CLOSED segments fully covered by a completed
        checkpoint's per-table version watermarks (``{table_id:
        version}``). The active segment is never reaped; a segment
        holding any record above its table's watermark (or for a table
        the checkpoint does not cover) is kept whole — replay re-reads
        whole segments, so reaping is all-or-nothing per segment."""
        reaped: List[str] = []
        active = _segment_name(self.rank, self._index)
        for index, path in segments(self.directory, self.rank):
            if os.path.basename(path) == active:
                continue
            # header-only walk: reaping must not re-read (and crc) every
            # retained payload byte on the training thread per checkpoint
            records, bad = _scan_segment_headers(path)
            if bad is not None:
                continue            # recovery's business, not reaping's
            covered = all(
                version <= watermarks.get(table_id, -1)
                for table_id, version in records)
            if covered:
                os.remove(path)
                reaped.append(path)
        if reaped:
            with self._lock:
                self.reaped_segments += len(reaped)
            Log.info("wal: reaped %d segment(s) covered by the "
                     "checkpoint watermark", len(reaped))
        return reaped

    # -- chaos hooks (serving/faultinject.py wal_torn_tail/wal_bad_crc) ----
    def corrupt_tail(self, kind: str) -> None:
        """Stage the crash-corruption the recovery path must survive:
        ``torn_tail`` halves the last record's bytes (a write the crash
        interrupted), ``bad_crc`` flips a payload bit (rot/partial
        overwrite). Test/chaos-only by construction; races with live
        appends are the caller's problem (the next act is a kill)."""
        path = self._path
        records, bad = _walk_segment(path, read_payloads=False)
        if not records or bad is not None:
            return
        last_off = records[-1][0]            # the final record's offset
        if kind == "torn_tail":
            end = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(last_off + max((end - last_off) // 2, 1))
        elif kind == "bad_crc":
            with open(path, "r+b") as f:
                f.seek(last_off + _REC.size)
                b = f.read(1)
                f.seek(last_off + _REC.size)
                f.write(bytes([b[0] ^ 0xFF]))
        else:
            Log.fatal(f"wal: unknown corruption kind {kind!r}")

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"directory": self.directory, "rank": self.rank,
                    "appended": self.appended,
                    "rotations": self.rotations,
                    "reaped_segments": self.reaped_segments,
                    "active_segment": self._index,
                    "recovery": dict(self.recovery)}


# -- journal hook (tables layer) ---------------------------------------------

def journal_local(sess, table_id: int, kind: int, option,
                  arrays, version: int) -> None:
    """Append one acknowledged local apply to the session's journal
    (no-op without ``-wal``). Runs AFTER the apply released the table
    lock; no lock is held across the write and fsync."""
    wal = getattr(sess, "wal", None)
    if wal is None:
        return
    from ..parallel.async_ps import _serialize

    payload = _serialize(kind, table_id, option, arrays,
                         version=int(version))
    wal.append(table_id, int(version), payload)


# -- replay ------------------------------------------------------------------

def replay(directory: str, rank: int = 0, session=None,
           tables: Optional[Dict[int, Any]] = None) -> Dict[str, int]:
    """Replay journal records with ``version > table.version`` into the
    session's tables, per table in version order, reaching the exact
    pre-crash version. Records at or below the table's current version
    (the checkpoint watermark installed by ``restore``) are skipped;
    a version gap stops that table's replay loudly (``gaps``/
    ``dropped`` count it). Returns
    ``{"replayed", "skipped", "gaps", "dropped", "unknown_tables"}``.
    """
    from ..parallel.async_ps import _deserialize
    from ..runtime import Session

    if tables is None:
        sess = session or Session.get()
        tables = {t.table_id: t for t in sess.tables}
    per_table: Dict[int, Dict[int, bytes]] = {}
    stats = {"replayed": 0, "skipped": 0, "gaps": 0, "dropped": 0,
             "unknown_tables": 0}
    for table_id, version, payload, _ in iter_records(directory, rank):
        if table_id not in tables:
            stats["unknown_tables"] += 1
            continue
        bucket = per_table.setdefault(table_id, {})
        if version in bucket:
            Log.error("wal: duplicate version %d for table %d; the "
                      "newer segment's record supersedes", version,
                      table_id)
        bucket[version] = payload
    for table_id in sorted(per_table):
        table = tables[table_id]
        for version in sorted(per_table[table_id]):
            if version <= table.version:
                stats["skipped"] += 1
                continue
            if version != table.version + 1:
                remaining = sum(1 for v in per_table[table_id]
                                if v >= version)
                Log.error("wal: version gap on table %d (have %d, next "
                          "record %d); stopping its replay and dropping "
                          "%d record(s)", table_id, table.version,
                          version, remaining)
                stats["gaps"] += 1
                stats["dropped"] += remaining
                break
            (kind, _, option, arrays, _, _, epoch,
             rec_version) = _deserialize(per_table[table_id][version])
            _apply_record(table, kind, option, arrays, rec_version)
            if table.version != version:
                Log.fatal(f"wal: replay of table {table_id} reached "
                          f"version {table.version}, record said "
                          f"{version} — journal/apply drift")
            stats["replayed"] += 1
    if stats["replayed"] or stats["dropped"]:
        Log.info("wal: replayed %d record(s) past the checkpoint "
                 "watermark (%d skipped, %d dropped)",
                 stats["replayed"], stats["skipped"], stats["dropped"])
    return stats


def _apply_record(table, kind: int, option, arrays,
                  version: int) -> None:
    from ..parallel import async_ps

    if kind == async_ps.DENSE:
        table._apply_dense(table._stage_dense(arrays[0]), option)
    elif kind == async_ps.KEYED:
        table._dispatch_keyed(arrays[0], arrays[1], option)
    elif kind == async_ps.KV:
        table._apply_remote_kv(arrays[0], arrays[1])
    elif kind == async_ps.STATE:
        table._install_state_arrays(arrays, version)
    else:
        Log.fatal(f"wal: unknown record kind {kind}")
