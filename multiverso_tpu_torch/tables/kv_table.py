"""Key-value table: a host dict with server-side ``+=``.

Counterpart of ``multiverso_tpu/tables/kv_table.py`` (the reference
KVTable, ``include/multiverso/table/kv_table.h``): Add accumulates per
key, Get pulls values into a worker-local cache (``raw()``). A map of
scalar counters is control-plane state, so it stays on the host. It
carries the tables' ``version``/``epoch`` pair, the parameter plane's
apply entry point (``_apply_remote_kv``, which WAL replay also takes) and
STATE protocol (the sorted keys and their values), ``store``/``load``
through ``io/stream``, and with ``-wal`` a ``KV`` journal record of every
local add (keys int64, values float64).

Each process holds its own authoritative dict (JAX :50-135). In async
mode (the session's delta bus up) every add is also published as a
``KV`` record that the peers' drain threads fold in. Otherwise adds
collect as pending, and ``sync()``, a collective, merges every
process's pending adds into every replica (gathered as int64 keys and
float64 values with a per-rank count, so any key is legal); alone it
has nothing to merge. The lock is a plain ``threading.RLock`` (the JAX
table's lock-order witness, ``analysis.lockwatch``, is item 9).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from ..log import Log
from ..runtime import Session


class KVTable:
    """Host-side accumulating KV map (``KVWorkerTable``/``KVServerTable``)."""

    def __init__(self, key_dtype=np.int64, value_dtype=np.float64,
                 name: Optional[str] = None) -> None:
        sess = Session.get()
        if not sess.started:
            Log.fatal("create tables after multiverso_tpu_torch.init()")
        self._sess = sess
        self.table_id = sess.register_table(self)
        self.name = name or f"KVTable:{self.table_id}"
        self.key_dtype = np.dtype(key_dtype)
        self.value_dtype = np.dtype(value_dtype)
        self._store: Dict[Any, Any] = {}
        self._cache: Dict[Any, Any] = {}
        self._pending: Dict[Any, Any] = {}  # adds not yet merged by sync()
        self._lock = threading.RLock()
        # mutation counter and trainer incarnation, as on the array tables
        self.version = 0
        self.epoch = 0

    def _key(self, k) -> Any:
        return self.key_dtype.type(k).item()

    def _fold(self, keys: Iterable, values: Iterable) -> None:
        """``+=`` each (key, value); the caller holds the lock."""
        for k, v in zip(keys, values):
            k = self._key(k)
            self._store[k] = self._store.get(k, 0) + \
                self.value_dtype.type(v).item()

    # -- worker API (kv_table.h:24-70) ------------------------------------
    def add(self, keys: Iterable, values: Iterable) -> None:
        """Server-side ``+=`` per key (``KVServerTable::ProcessAdd``),
        published on the bus in async mode; with ``-wal`` the add is
        journaled once the lock is released."""
        keys, values = list(keys), list(values)
        bus = self._sess.async_bus
        if bus is not None:   # async PS: the peers fold it via their drain
            bus.publish_kv(self.table_id, np.asarray(keys, np.int64),
                           np.asarray(values, np.float64))
        with self._lock:
            self._fold(keys, values)
            if bus is None:
                for k, v in zip(keys, values):
                    k = self._key(k)
                    self._pending[k] = self._pending.get(k, 0) + \
                        self.value_dtype.type(v).item()
            self.version += 1
            version = self.version
        if getattr(self._sess, "wal", None) is not None:
            from ..io.wal import journal_local
            from ..parallel.async_ps import KV

            journal_local(self._sess, self.table_id, KV, None,
                          [np.asarray(keys, np.int64),
                           np.asarray(values, np.float64)], version)

    def _apply_remote_kv(self, keys: np.ndarray, values: np.ndarray) -> None:
        """A peer's adds (the parameter plane's ``KV`` record)."""
        with self._lock:
            self._fold(keys, values)
            self.version += 1

    def get(self, keys: Iterable) -> List:
        """Pull values into the local cache and return them in key order."""
        keys = list(keys)
        with self._lock:
            out = [self._store.get(self._key(k), 0) for k in keys]
            for k, v in zip(keys, out):
                self._cache[self._key(k)] = v
            return out

    def raw(self) -> Dict[Any, Any]:
        """Worker-local cache of previously-got entries (``kv_table.h:30``)."""
        with self._lock:
            return dict(self._cache)

    def sync(self) -> None:
        """Merge every process's pending adds into every replica (a
        collective: every process calls it)."""
        with self._lock:
            pending = dict(self._pending)
            self._pending.clear()
        if self._sess.size == 1:
            return
        group = self._sess.group
        order = sorted(pending)
        keys = np.array(order, dtype=np.int64)
        vals = np.array([pending[k] for k in order], dtype=np.float64)
        # fixed-size exchange: each rank's count bounds its valid prefix
        counts = group.allgather(np.array([keys.size], np.int64))[:, 0]
        width = max(int(counts.max()), 1)
        pad_k = np.zeros((width,), np.int64)
        pad_v = np.zeros((width,), np.float64)
        pad_k[: keys.size] = keys
        pad_v[: keys.size] = vals
        all_k, all_v = group.allgather(pad_k), group.allgather(pad_v)
        with self._lock:
            for rank, count in enumerate(counts):
                if rank != self._sess.rank:
                    self._fold(all_k[rank, :count], all_v[rank, :count])
            self.version += 1

    # -- STATE-record wire protocol (fenced-restart rebase) ----------------
    def _state_arrays(self):
        """``([sorted keys int64, vals float64], version)`` taken under
        the lock."""
        with self._lock:
            keys = sorted(self._store)
            return [np.array(keys, dtype=np.int64),
                    np.array([self._store[k] for k in keys],
                             dtype=np.float64)], self.version

    def _install(self, keys, vals) -> None:
        self._store = {int(k): self.value_dtype.type(v).item()
                       for k, v in zip(keys, vals)}

    def _install_state_arrays(self, arrays, version: int,
                              epoch: int = 0) -> None:
        keys, vals = arrays
        with self._lock:
            self._install(keys, vals)
            self.version = int(version)
            if epoch:
                self.epoch = int(epoch)

    # -- checkpoint --------------------------------------------------------
    def store(self, stream) -> int:
        from ..io.stream import write_array

        (keys, vals), version = self._state_arrays()
        write_array(stream, keys)
        write_array(stream, vals)
        return version

    def load(self, stream) -> None:
        from ..io.stream import read_array

        keys = read_array(stream)
        vals = read_array(stream)
        with self._lock:
            self._install(keys, vals)

    def flush(self) -> None:
        pass

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)
