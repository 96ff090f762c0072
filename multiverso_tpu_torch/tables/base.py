"""Parameter-table base: one device tensor + updater dispatch.

Counterpart of ``multiverso_tpu/tables/base.py`` (the reference table
layer, ``include/multiverso/table_interface.h:24-85``). The reference
splits a table into a WorkerTable and a ServerTable; both collapse into
one object holding:

* storage — one tensor on the session's device (the JAX table's sharded
  ``jax.Array``; there is no mesh here, so no padding: ``pad_rows`` is 0
  and the physical shape is the logical one);
* ``add`` — the updater applied on the device (the reference's
  worker->server Add round-trip);
* ``get`` — a device->host copy, or the zero-copy :attr:`array` view for
  device-side consumers;
* async — CUDA streams are asynchronous: ``add_async`` returns once the
  update is enqueued, and an :class:`AsyncHandle` plays the reference's
  ``Waiter``.

Every mutation happens under the table's ``threading.RLock`` and bumps
``version``. The remote entry points of ``multiverso_tpu/tables/base.py``
:267-344 are here for the parameter plane: ``_apply_remote_dense`` /
``_apply_remote_keyed`` (a peer's delta, feeding the optional
``_remote_accum``), and the STATE protocol (``_state_arrays``,
``_install_state_arrays``, ``_install_state``: an absolute value at an
exact (version, epoch)). The keyed gather and apply shared by the
matrix, sparse and FTRL tables (JAX ``_build_keyed_gather`` /
``_build_keyed_apply``) are ``_gather_keys`` and ``_dispatch_keyed``: the
row gather and the row scatter-add kernels (``ops.embedding``). A bf16
table's state ships as a torch bf16 tensor, its own 16-bit words.
``store``/``load`` (JAX :470-500) write and read one ``io/stream``
``MVTA`` record of the logical array, the JAX package's bytes.

With ``-wal`` every LOCAL apply (``add``/``add_async``, and the keyed adds
of the matrix, sparse, FTRL and kv tables) is journaled
(``_journal_local``, JAX :345-372) after the apply has released the table
lock and before the caller's handle exists, in the record the JAX package
writes: a dense add's host delta, a keyed add's int32 ids and its values
in the table's dtype, exactly what was applied. A table with a stateful
updater (momentum, AdaGrad) refuses to journal: replay re-applies deltas
to the restored data only, and the updater's state is neither
checkpointed nor journaled.

Across processes (JAX :23-27, :243-264, :386-393): in sync mode (BSP,
``-sync=true``) a dense add folds the sum of every process's delta
(``Session.aggregate``: numpy in rank order; a bf16 table's words summed
in rank order with a rounding after each add, as ``ml_dtypes`` sums), and
a keyed add folds the union of every process's (ids, values) in rank
order (``_aggregate_keyed``); in async mode the add applies locally and
is published on the session's delta bus (``publish_delta`` picks the
touched rows or the dense form; keyed adds publish their rows), whose
drain thread folds it into every peer's replica through the remote entry
points. With ``-wal`` the journal takes exactly what this replica
applied, after aggregation.
"""

from __future__ import annotations

import threading
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config, trace
from ..dashboard import Dashboard
from ..log import Log
from ..ops.embedding import embedding_lookup, scatter_add_rows
from ..parallel.async_ps import DENSE, KEYED
from ..runtime import Session
from ..updaters import AddOption, GetOption, Updater, get_updater


def torch_dtype(dtype: Any) -> torch.dtype:
    """``torch.float32`` / ``"bfloat16"`` / ``np.float32`` -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        Log.fatal(f"unsupported table dtype {dtype!r}")
    return out


def host_to_tensor(values: Any, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """Host values as a tensor of ``dtype`` on ``device``. A bfloat16 table
    receives float64 values rounded through float32, as the JAX package's
    ml_dtypes cast rounds them, so both packages hold the same bits."""
    if isinstance(values, torch.Tensor):
        return values.to(device=device, dtype=dtype)
    np_dtype = (np.float32 if dtype == torch.bfloat16
                else torch.empty((), dtype=dtype).numpy().dtype)
    # a private writable copy: the caller's array may be read-only
    host = torch.from_numpy(np.array(values, dtype=np_dtype))
    return host.to(device=device, dtype=dtype)


def tensor_to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host ndarray; bfloat16 comes back as float32 (exact:
    numpy has no bfloat16)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def record_array(host: torch.Tensor) -> Any:
    """A CPU tensor as a record array: numpy, or the bf16 tensor itself
    (``io/stream`` writes its raw 16-bit words)."""
    return host if host.dtype == torch.bfloat16 else host.numpy()


def _host_values(values: Any, dtype) -> np.ndarray:
    """Host ndarray of ``values`` (numpy or a tensor) in ``dtype``."""
    if isinstance(values, torch.Tensor):
        values = tensor_to_host(values)
    return np.asarray(values, dtype)


class AsyncHandle:
    """Future for an async table op (the reference's per-request ``Waiter``)."""

    def __init__(self, values: Any = None, callback=None) -> None:
        self._values = values
        self._callback = callback
        self._done = False

    def wait(self) -> Any:
        if not self._done:
            result = (self._callback() if self._callback is not None
                      else self._values)
            self._values = result
            self._done = True
        return self._values


class TableBase:
    """Shared machinery for the array, matrix, sparse and FTRL tables."""

    def __init__(
        self,
        shape: Sequence[int],
        dtype: Any = torch.float32,
        updater: Optional[str] = None,
        name: Optional[str] = None,
        init_value: Any = None,
        num_sim_workers: Optional[int] = None,
        device: Any = None,
    ) -> None:
        sess = Session.get()
        if not sess.started:
            Log.fatal("create tables after multiverso_tpu_torch.init()")
        self._sess = sess
        # the session's device unless the caller names one (a CPU copy of
        # a card table, for a comparison)
        self.device = sess.device if device is None else torch.device(device)
        self.shape = tuple(int(s) for s in shape)
        self.dtype = torch_dtype(dtype)
        self.table_id = sess.register_table(self)
        self.name = name or f"{type(self).__name__}:{self.table_id}"
        self.updater: Updater = get_updater(updater, dtype=self.dtype)
        # per-worker updater state (AdaGrad) is sized by this; an
        # AddOption.worker_id must stay below it
        self.num_worker_slots = int(num_sim_workers or sess.num_workers)
        self._lock = threading.RLock()
        # monotonic mutation counter: every state install bumps it under
        # the lock; a snapshot whose version equals the table's is the live
        # state
        self.version = 0
        # trainer incarnation of this state (epoch fencing); 0 = unfenced
        self.epoch = 0
        self.pad_rows = 0
        if init_value is not None:
            self._data = host_to_tensor(
                np.asarray(init_value).reshape(self.shape)
                if not isinstance(init_value, torch.Tensor)
                else init_value.reshape(self.shape), self.dtype, self.device)
        else:
            self._data = torch.zeros(self.shape, dtype=self.dtype,
                                     device=self.device)
        ustate = self.updater.init_state(self.shape, self.dtype,
                                         self.num_worker_slots)
        self._ustate = (ustate.to(self.device)
                        if isinstance(ustate, torch.Tensor) else ustate)

    def logical(self, data: torch.Tensor) -> torch.Tensor:
        """The logical view of a physical array: the array itself (no
        padding in this port)."""
        return data

    def _default_option(self, option: Optional[AddOption]) -> AddOption:
        option = option or AddOption(worker_id=max(self._sess.worker_id, 0))
        if not (0 <= option.worker_id < self.num_worker_slots):
            Log.fatal(
                f"AddOption.worker_id {option.worker_id} out of range for "
                f"{self.num_worker_slots} worker slot(s) on table "
                f"{self.name!r}; pass num_sim_workers= at table creation to "
                f"widen")
        return option

    def _stage_dense(self, values: Any, device: Any = None) -> torch.Tensor:
        """Logical-shape values (numpy or a tensor) as a tensor of the
        table's dtype on ``device`` (default: the table's)."""
        return host_to_tensor(
            values.reshape(self.shape) if isinstance(values, torch.Tensor)
            else np.asarray(values).reshape(self.shape), self.dtype,
            self.device if device is None else torch.device(device))

    # -- delta application -------------------------------------------------
    def _apply_dense(self, delta: torch.Tensor, option: AddOption) -> int:
        """Fold a logical-shape delta (already on the device, table dtype)
        into the table; returns the post-apply version."""
        with self._lock:
            mon = Dashboard.get_or_create(f"TABLE_ADD[{self.name}]")
            mon.begin()
            sp = trace.start_span("table.add", table=self.name,
                                  worker=option.worker_id)
            self._data, self._ustate = self.updater.apply(
                self._data, self._ustate, delta, option)
            self.version += 1
            version = self.version
            sp.end(version=version)
            mon.end()
        return version

    # -- keyed gather and apply (shared by Matrix/Sparse/FTRL) -------------
    def _gather_keys(self, keys: Any) -> np.ndarray:
        """Rows at ``keys`` -> host array (float32 for a bfloat16 table).
        ``data[ids]``'s rule on int32 keys: a negative key wraps once,
        then the key is clamped into the table (the gather kernel gives NaN
        out of range)."""
        rows = self.shape[0]
        ids = np.asarray(keys, dtype=np.int32).ravel().astype(np.int64)
        ids = np.clip(np.where(ids < 0, ids + rows, ids), 0, rows - 1)
        ids_t = torch.from_numpy(ids.astype(np.int32)).to(self.device)
        with self._lock:
            out = embedding_lookup(self._data, ids_t)
        return tensor_to_host(out)

    def _dispatch_keyed(self, ids: Any, vals: Any,
                        option: Optional[AddOption] = None) -> int:
        """Apply per-key deltas ``vals`` ([n] + row shape) through the
        updater (``.at[ids].add``'s rule: duplicates accumulate, a key out
        of range after one wrap is dropped); returns the post-apply
        version. A stateless updater adds ``sign * vals`` in place, the
        sign as the kernel's ``alpha``; a stateful one scatters into a
        zero delta of the whole table and runs its ``apply``."""
        ids = np.asarray(ids, dtype=np.int32).ravel()
        shape = (ids.shape[0],) + self.shape[1:]
        vals_t = host_to_tensor(
            vals.reshape(shape) if isinstance(vals, torch.Tensor)
            else np.asarray(vals).reshape(shape), self.dtype, self.device)
        ids_t = torch.from_numpy(ids).to(self.device)
        updater = self.updater
        with self._lock:
            if updater.stateless:
                scatter_add_rows(self._data, ids_t, vals_t,
                                 alpha=None if updater.sign == 1.0
                                 else updater.sign)
            else:
                dense = scatter_add_rows(torch.zeros_like(self._data), ids_t,
                                         vals_t)
                self._data, self._ustate = updater.apply(
                    self._data, self._ustate, dense, option)
            self.version += 1
            return self.version

    # -- remote entry points (the parameter plane's apply side) ------------
    def _apply_remote_dense(self, host: Any, option: AddOption) -> None:
        """A peer's dense delta. Besides applying it, feed the optional
        remote-delta accumulator (``_remote_accum``, a host array) that
        separates a trainer's own movement from its peers'."""
        staged = self._stage_dense(host)
        with self._lock:
            accum = getattr(self, "_remote_accum", None)
            if accum is not None:
                accum += _host_values(host, accum.dtype).reshape(
                    accum.shape)
            self._apply_dense(staged, option)

    def _apply_remote_keyed(self, ids: Any, vals: Any,
                            option: AddOption) -> None:
        """A peer's keyed (touched-row) delta, feeding ``_remote_accum``
        atomically with the apply."""
        with self._lock:
            accum = getattr(self, "_remote_accum", None)
            if accum is not None:
                np.add.at(accum, np.asarray(ids, np.int64).ravel(),
                          _host_values(vals, accum.dtype))
            self._dispatch_keyed(ids, vals, option)

    def _install_state(self, host: Any, version: int,
                       epoch: int = 0) -> None:
        """Install an absolute state at an exact (version, epoch): the
        fenced restart's STATE rebase. Unlike :meth:`set_array` the
        version is assigned, not bumped."""
        staged = self._stage_dense(host)
        with self._lock:
            self._data = staged
            self.version = int(version)
            if epoch:
                self.epoch = int(epoch)

    def _state_arrays(self) -> Tuple[list, int]:
        """The STATE record's arrays and version: one host copy in the
        table's own dtype (a torch bf16 tensor for a bf16 table)."""
        with self._lock:
            snap, version = self._data.clone(), self.version
        return [record_array(snap.cpu())], version

    def _install_state_arrays(self, arrays, version: int,
                              epoch: int = 0) -> None:
        self._install_state(arrays[0], version, epoch)

    # -- across processes ----------------------------------------------------
    def _bsp(self) -> bool:
        """Sync mode in a group: every add folds every process's delta."""
        return config.get_flag("sync") and self._sess.size > 1

    def _aggregate_dense(self, host: torch.Tensor) -> torch.Tensor:
        """The sum over processes of a CPU delta in the table's dtype."""
        if host.dtype != torch.bfloat16:
            arr = host.numpy().copy()
            return torch.from_numpy(self._sess.aggregate(arr))
        words = self._sess.group.allgather(host.view(torch.int16).numpy())
        parts = [torch.from_numpy(w).view(torch.bfloat16) for w in words]
        total = parts[0]
        for part in parts[1:]:
            total = (total.float() + part.float()).to(torch.bfloat16)
        return total

    def _aggregate_keyed(self, ids: np.ndarray, vals: torch.Tensor
                         ) -> Tuple[np.ndarray, torch.Tensor]:
        """Every process's (ids, values) in rank order (the SyncServer
        contract for keyed adds); the scatter-add sums duplicates."""
        group = self._sess.group
        counts = group.allgather(np.array([ids.shape[0]], np.int64))[:, 0]
        width = int(counts.max())
        bf16 = vals.dtype == torch.bfloat16
        host = vals.view(torch.int16).numpy() if bf16 else vals.numpy()
        pad_i = np.zeros((width,), np.int32)
        pad_v = np.zeros((width,) + host.shape[1:], host.dtype)
        pad_i[: ids.shape[0]] = ids
        pad_v[: ids.shape[0]] = host
        all_i, all_v = group.allgather(pad_i), group.allgather(pad_v)
        out_i = np.concatenate([all_i[r, :n] for r, n in enumerate(counts)])
        out_v = torch.from_numpy(np.concatenate(
            [all_v[r, :n] for r, n in enumerate(counts)]))
        return out_i, out_v.view(torch.bfloat16) if bf16 else out_v

    # -- the write-ahead journal hook ---------------------------------------
    def _journal_local(self, kind: int, option, arrays,
                       version: int) -> None:
        """Journal one acknowledged LOCAL apply to the session's WAL
        (no-op without ``-wal``). Called after the apply released the
        table lock: the write and fsync never run under it.

        Replay re-applies the journaled deltas to the restored data only:
        updater state (momentum, AdaGrad's accumulators) is neither
        checkpointed nor journaled, so a stateful updater's replay would
        silently diverge from the acknowledged bytes. Refuse loudly
        instead. The port's updaters keep their state as one tensor
        (``_ustate``); a stateless one keeps the empty tuple."""
        stateless = (not isinstance(self._ustate, torch.Tensor)
                     and len(self._ustate) == 0)
        if not stateless:
            Log.fatal(
                f"-wal journaling on table {self.name!r} with the "
                f"STATEFUL updater {self.updater.name!r}: replay cannot "
                f"reproduce updater state, so recovery would silently "
                f"diverge from the acknowledged pre-crash bytes; use a "
                f"stateless updater (default/sgd) with -wal, or disable "
                f"the journal")
        from ..io.wal import journal_local

        journal_local(self._sess, self.table_id, kind, option, arrays,
                      version)

    def _add_keyed_local(self, ids: Any, vals: Any,
                         option: Optional[AddOption]) -> int:
        """A local caller's keyed add: published on the bus (async mode)
        or joined with every process's (sync mode), applied, and with
        ``-wal`` journaled as applied (the int32 ids and the values
        rounded to the table's dtype on the host; that host copy is what
        the journal and the group cost on the card)."""
        bus = self._sess.async_bus
        if (getattr(self._sess, "wal", None) is None and bus is None
                and not self._bsp()):
            return self._dispatch_keyed(ids, vals, option)
        ids = np.asarray(ids, dtype=np.int32).ravel()
        shape = (ids.shape[0],) + self.shape[1:]
        host = host_to_tensor(
            vals.reshape(shape) if isinstance(vals, torch.Tensor)
            else np.asarray(vals).reshape(shape), self.dtype,
            torch.device("cpu"))
        if bus is not None:
            bus.publish_keyed(self.table_id, ids, record_array(host), option)
        elif self._bsp():
            ids, host = self._aggregate_keyed(ids, host)
        version = self._dispatch_keyed(ids, host, option)
        if getattr(self._sess, "wal", None) is not None:
            self._journal_local(KEYED, option, [ids, record_array(host)],
                                version)
        return version

    # -- public ops --------------------------------------------------------
    def _add_handle(self) -> AsyncHandle:
        """Waiter for an enqueued add: it blocks until the device stream
        has run everything enqueued so far (the per-request Waiter)."""
        return AsyncHandle(callback=self.flush)

    def add_async(self, delta: Any,
                  option: Optional[AddOption] = None) -> AsyncHandle:
        """Fold a delta into the table; returns once it is enqueued
        (``AddAsync``). In sync mode the delta folded is the sum over
        processes; in async mode it is also published on the bus."""
        option = self._default_option(option)
        bus = self._sess.async_bus
        if (getattr(self._sess, "wal", None) is None and bus is None
                and not self._bsp()):
            self._apply_dense(self._stage_dense(delta), option)
            return self._add_handle()
        host = self._stage_dense(delta, device="cpu")
        if self._bsp():
            host = self._aggregate_dense(host)
        elif bus is not None:
            # peers fold it through their drain threads; the bus picks
            # the touched-row or the dense form
            bus.publish_delta(self, record_array(host), option)
        version = self._apply_dense(host.to(self.device), option)
        if getattr(self._sess, "wal", None) is not None:
            # journal BEFORE the caller gets its handle: once add()
            # returns (the acknowledgment), the update is replayable
            self._journal_local(DENSE, option, [record_array(host)],
                                version)
        return self._add_handle()

    def add(self, delta: Any, option: Optional[AddOption] = None) -> None:
        """Blocking Add (``WorkerTable::Add``)."""
        self.add_async(delta, option).wait()

    def get_async(self, option: Optional[GetOption] = None) -> AsyncHandle:
        with self._lock:
            # the copy is enqueued under the lock, so it reads the state as
            # of now even if a later add replaces or updates _data
            snap = self._data.clone()
        return AsyncHandle(snap, callback=lambda: tensor_to_host(snap))

    def get(self, option: Optional[GetOption] = None) -> np.ndarray:
        """Blocking whole-table Get -> host ndarray (``WorkerTable::Get``);
        a bfloat16 table comes back as float32."""
        return self.get_async(option).wait()

    def snapshot_array(self) -> Tuple[torch.Tensor, int]:
        """``(device copy, version)`` for the serving read path; the copy is
        enqueued under the lock, so later adds cannot tear it."""
        with self._lock:
            return self._data.clone(), self.version

    @property
    def array(self) -> torch.Tensor:
        """The table's device tensor, zero-copy. Device-side trainers
        (``models.word2vec``) update it in place under the table lock."""
        with self._lock:
            return self._data

    def set_array(self, value: Any) -> None:
        """Install new state (logical shape) and bump the version."""
        if tuple(value.shape) != self.shape:
            Log.fatal(f"set_array shape {tuple(value.shape)} != table shape "
                      f"{self.shape}")
        staged = host_to_tensor(value, self.dtype, self.device)
        with self._lock:
            self._data = staged
            self.version += 1

    def flush(self) -> None:
        """Block until every update enqueued on the device has landed."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # -- checkpoint (``Serializable``, ``table_interface.h:59-66``) --------
    def store(self, stream) -> int:
        """Write the table record (the logical array in the table's dtype);
        returns the stored state's version."""
        from ..io.stream import write_array

        arrays, version = self._state_arrays()
        write_array(stream, arrays[0])
        return version

    def load(self, stream) -> None:
        """Read a table record of this table's shape onto its device and
        bump the version."""
        from ..io.stream import read_array

        host = read_array(stream)
        if tuple(host.shape) != self.shape:
            Log.fatal(f"checkpoint shape {tuple(host.shape)} != table shape "
                      f"{self.shape}")
        staged = host_to_tensor(host, self.dtype, self.device)
        with self._lock:
            self._data = staged
            self.version += 1

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 0
