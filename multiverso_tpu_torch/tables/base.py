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
exact (version, epoch)). A bf16 table's state ships as a torch bf16
tensor, its own 16-bit words. Not here yet, and refused by the session's
flags: the WAL journal (``_journal_local``), the async delta bus, BSP
aggregation over processes, and ``store``/``load`` (the I/O slice).
"""

from __future__ import annotations

import threading
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import trace
from ..dashboard import Dashboard
from ..log import Log
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
    """Shared machinery for the Array and Matrix tables."""

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

    # -- remote entry points (the parameter plane's apply side) ------------
    def _apply_remote_dense(self, host: Any, option: AddOption) -> None:
        """A peer's dense delta. Besides applying it, feed the optional
        remote-delta accumulator (``_remote_accum``, a host array) that
        separates a trainer's own movement from its peers'."""
        staged = host_to_tensor(
            host.reshape(self.shape) if isinstance(host, torch.Tensor)
            else np.asarray(host).reshape(self.shape), self.dtype,
            self.device)
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
        staged = host_to_tensor(
            host.reshape(self.shape) if isinstance(host, torch.Tensor)
            else np.asarray(host).reshape(self.shape), self.dtype,
            self.device)
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
        host = snap.cpu()
        return [host if host.dtype == torch.bfloat16
                else host.numpy()], version

    def _install_state_arrays(self, arrays, version: int,
                              epoch: int = 0) -> None:
        self._install_state(arrays[0], version, epoch)

    # -- public ops --------------------------------------------------------
    def _add_handle(self) -> AsyncHandle:
        """Waiter for an enqueued add: it blocks until the device stream
        has run everything enqueued so far (the per-request Waiter)."""
        return AsyncHandle(callback=self.flush)

    def add_async(self, delta: Any,
                  option: Optional[AddOption] = None) -> AsyncHandle:
        """Fold a delta into the table; returns once it is enqueued
        (``AddAsync``)."""
        option = self._default_option(option)
        staged = host_to_tensor(
            delta.reshape(self.shape) if isinstance(delta, torch.Tensor)
            else np.asarray(delta).reshape(self.shape), self.dtype,
            self.device)
        self._apply_dense(staged, option)
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

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 0
