"""The process group and its coordination KV: the port's control plane.

Counterpart of the process-group half of ``multiverso_tpu/topology.py``
(``net_bind``/``net_connect`` :128-160, ``_maybe_init_distributed``
:191-238, ``barrier`` :276-302). The reference registers every process
with rank 0 over MPI/ZMQ; the JAX package joins ``jax.distributed``'s
coordination service. Here rank 0 hosts a ``torch.distributed.TCPStore``
on the coordinator address and every process joins a gloo process group
on that store. The JAX package stages its process-level paths on the
host (``multihost_utils.process_allgather``, the coordination KV), so
the port does too: gloo over host tensors, whatever device the tables
live on (NCCL would refuse two ranks on one card).

Bootstrap, in the JAX package's order: the explicit
:func:`net_bind`/:func:`net_connect` table, then ``MV_COORDINATOR_ADDRESS``
(or ``JAX_COORDINATOR_ADDRESS``) with ``MV_NUM_PROCESSES`` and
``MV_PROCESS_ID``. Neither given: one process, no group. Asked for a group
that cannot form (an address that does not parse, a rank out of range, a
store that cannot be hosted or reached, a gloo rendezvous that fails), the
session fails with :class:`~.log.FatalError`; it never carries on as
one process of one.

:class:`StoreKV` wraps the store in the JAX coordination client's method
names (``key_value_set``, ``key_value_set_bytes``,
``blocking_key_value_get``, ``blocking_key_value_get_bytes``,
``key_value_try_get``, ``key_value_increment``, ``key_value_delete``,
``wait_at_barrier``), so the wire modules (``parallel.p2p``,
``parallel.async_ps``, ``parallel.ssp``, ``parallel.health``,
``serving.obs_plane``) take it as they take the JAX client. Two
differences from that client: ``key_value_delete`` removes the one key
(the coordination service deletes a whole directory), and
``key_value_set`` overwrites whatever ``allow_overwrite`` says. Blocking
calls poll ``check`` rather than wait on the server: a TCPStore client
serializes its calls, so a server-side wait would stall every other
thread of the process (the heartbeat among them) behind it.

The store lives as long as the process (the JAX coordination service
outlives the session too); each group formed on it, one per session,
keeps its keys under its own prefix (``mvg<n>/``), so a new session
starts from an empty KV. The device mesh (``make_mesh``, ``-mesh_shape``)
belongs to the mesh slice and is not here.
"""

from __future__ import annotations

import os
import time
from datetime import timedelta
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .log import Log

# how long a process waits for its group to form (the JAX package's
# jax.distributed.initialize waits 300 s by default)
CONNECT_TIMEOUT_S = 300.0
# how long rank 0 keeps its store up for peers that passed the exit
# rendezvous but have not yet marked their exit
_EXIT_GRACE_S = 30.0
_POLL_MIN_S, _POLL_MAX_S = 0.0005, 0.01

# the explicit bootstrap table (net_bind/net_connect), consulted before
# the environment
_explicit_net: Dict[str, object] = {}
# this process's store connection (rank 0: the store itself) by (address,
# size, rank) and the groups formed on it so far. The store outlives the
# session, as the JAX package's coordination service does: a new session
# in the same processes forms a new group under a fresh key prefix, with
# no race against a store being torn down and hosted again.
_stores: Dict[Tuple[str, int, int, int], list] = {}


def net_bind(rank: int, endpoint: str) -> None:
    """Declare this process's rank and endpoint (``MV_NetBind``). Call
    before :func:`multiverso_tpu_torch.init`, with :func:`net_connect`."""
    _explicit_net["rank"] = int(rank)
    _explicit_net["endpoint"] = str(endpoint)


def net_connect(ranks: Sequence[int], endpoints: Sequence[str]) -> None:
    """Declare the whole group (``MV_NetConnect``): ``endpoints[i]`` is
    rank ``ranks[i]``'s endpoint, and rank 0's hosts the store."""
    ranks = [int(r) for r in ranks]
    if len(ranks) != len(endpoints):
        Log.fatal(f"net_connect: {len(ranks)} ranks vs "
                  f"{len(endpoints)} endpoints")
    if len(set(ranks)) != len(ranks):
        Log.fatal(f"net_connect: duplicate ranks in {ranks}")
    table = dict(zip(ranks, endpoints))
    if 0 not in table:
        Log.fatal("net_connect needs rank 0's endpoint (the coordinator)")
    _explicit_net["num"] = len(table)
    _explicit_net["coordinator"] = str(table[0])


def _poll(ready, timeout_s: float) -> bool:
    """Call ``ready()`` with a backoff from 0.5 to 10 ms until it is true
    or ``timeout_s`` passes; returns its last answer."""
    deadline = time.monotonic() + timeout_s
    pause = _POLL_MIN_S
    while not ready():
        if time.monotonic() >= deadline:
            return False
        time.sleep(pause)
        pause = min(pause * 2, _POLL_MAX_S)
    return True


class StoreKV:
    """The JAX coordination client's KV calls over a TCPStore. Values are
    ``str`` (``*_bytes``: ``bytes``); an absent key reads as a
    ``KeyError`` naming ``NOT_FOUND``, and a blocking call that runs out
    of time raises ``TimeoutError`` naming ``DEADLINE_EXCEEDED``."""

    def __init__(self, store, rank: int, size: int) -> None:
        self.store = store
        self.rank = int(rank)
        self.size = int(size)

    def key_value_set(self, key: str, value, allow_overwrite: bool = False
                      ) -> None:
        self.store.set(key, value)

    def key_value_set_bytes(self, key: str, value: bytes,
                            allow_overwrite: bool = False) -> None:
        self.store.set(key, value)

    def key_value_try_get(self, key: str) -> str:
        if not self.store.check([key]):
            raise KeyError(f"NOT_FOUND: {key}")
        return self.store.get(key).decode()

    def blocking_key_value_get_bytes(self, key: str, timeout_ms: int
                                     ) -> bytes:
        if not _poll(lambda: self.store.check([key]), timeout_ms / 1000.0):
            raise TimeoutError(f"DEADLINE_EXCEEDED: {key} not set within "
                               f"{timeout_ms} ms")
        return self.store.get(key)

    def blocking_key_value_get(self, key: str, timeout_ms: int) -> str:
        return self.blocking_key_value_get_bytes(key, timeout_ms).decode()

    def key_value_increment(self, key: str, amount: int) -> int:
        return int(self.store.add(key, int(amount)))

    def key_value_delete(self, key: str) -> None:
        """Delete the one key (no directory semantics)."""
        self.store.delete_key(key)

    def wait_at_barrier(self, name: str, timeout_ms: int,
                        participants: Optional[Iterable[int]] = None
                        ) -> None:
        """Rendezvous of ``participants`` (default: every rank) under a
        single-use ``name``: each marks its arrival, then waits for the
        others'. An arrival stays registered when its own wait runs out."""
        ranks = sorted(range(self.size) if participants is None
                       else {int(r) for r in participants})
        self.store.set(f"{name}/in/{self.rank}", "1")
        keys = [f"{name}/in/{r}" for r in ranks]
        if not _poll(lambda: self.store.check(keys), timeout_ms / 1000.0):
            missing = [r for r, k in zip(ranks, keys)
                       if not self.store.check([k])]
            raise TimeoutError(f"DEADLINE_EXCEEDED: barrier {name} missing "
                               f"rank(s) {missing} after {timeout_ms} ms")


def _parse_address(text: str) -> Tuple[str, int]:
    host, sep, port = text.rpartition(":")
    if not sep or not host or not port.isdigit():
        Log.fatal(f"coordinator address {text!r} is not host:port")
    return host.strip("[]"), int(port)


class ProcessGroup:
    """One process's membership of the group: its rank, the size, the
    store's KV client, and the gloo group the default ``torch.distributed``
    calls run on."""

    def __init__(self, coordinator: str, size: int, rank: int) -> None:
        import torch.distributed as dist

        if size < 2 or not 0 <= rank < size:
            Log.fatal(f"process group: rank {rank} of {size} processes is "
                      f"not a group")
        host, port = _parse_address(coordinator)
        self.rank, self.size = int(rank), int(size)
        self._dist = dist
        slot = (host, port, self.size, self.rank)
        try:
            if slot not in _stores:
                # rank 0 hosts the store on the coordinator address; the
                # others connect to it, retrying until the timeout
                _stores[slot] = [dist.TCPStore(
                    host, port, world_size=size, is_master=rank == 0,
                    timeout=timedelta(seconds=CONNECT_TIMEOUT_S),
                    wait_for_workers=False), 0]
            _stores[slot][1] += 1
            # every process forms its groups on one store in the same
            # order, so the n-th group's prefix agrees across the group
            self.generation = _stores[slot][1]
            store = dist.PrefixStore(f"mvg{self.generation}",
                                     _stores[slot][0])
            dist.init_process_group("gloo", store=store, rank=rank,
                                    world_size=size,
                                    timeout=timedelta(
                                        seconds=CONNECT_TIMEOUT_S))
        except Exception as exc:   # any failure to form the group is fatal
            _stores.pop(slot, None)
            Log.fatal(f"process group: rank {rank} of {size} could not join "
                      f"via {coordinator}: {type(exc).__name__}: {exc}")
        self.store = store
        self.client = StoreKV(store, rank, size)
        Log.info("process group %d: rank %d/%d via %s (gloo)",
                 self.generation, rank, size, coordinator)

    def barrier(self, name: str = "mv_barrier",
                participants: Optional[Iterable[int]] = None) -> None:
        """Every rank (a gloo barrier), or only ``participants`` through
        the store (survivor mode: a collective would wait on a dead peer).
        A participant barrier's name is single-use."""
        if participants is None:
            self._dist.barrier()
        else:
            self.client.wait_at_barrier(f"mvb/{name}", 600_000,
                                        participants)

    def allgather(self, arr: np.ndarray) -> np.ndarray:
        """``[size, *arr.shape]``: every rank's ``arr`` (same shape and
        dtype everywhere), in rank order, bytes moved as they are."""
        import torch

        arr = np.ascontiguousarray(arr)
        if arr.nbytes == 0:
            return np.zeros((self.size,) + arr.shape, arr.dtype)
        flat = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy())
        out = [torch.empty_like(flat) for _ in range(self.size)]
        self._dist.all_gather(out, flat)
        return np.stack([o.numpy().view(arr.dtype).reshape(arr.shape)
                         for o in out])

    def close(self, live: Optional[List[int]] = None) -> None:
        """The exit rendezvous of ``live`` (default: every rank) through
        the store, then the gloo group's end. Rank 0 hosts the store, so
        it waits (at most 30 s) until every live peer has passed the
        rendezvous: past that the process may exit and its store with
        it."""
        live = list(range(self.size)) if live is None else sorted(live)
        try:
            self.client.wait_at_barrier("mvb/mv_exit", 600_000, live)
            self.client.key_value_set(f"mvb/mv_exit/left/{self.rank}", "1")
            if self.rank == 0:
                keys = [f"mvb/mv_exit/left/{r}" for r in live]
                _poll(lambda: self.store.check(keys), _EXIT_GRACE_S)
        except Exception as exc:
            Log.info("exit rendezvous incomplete (%s); ending the group "
                     "anyway", exc)
        self._dist.destroy_process_group()


def init_group() -> Optional[ProcessGroup]:
    """The group this process was asked to join (explicit net table
    first, then the environment), or None for one process."""
    if _explicit_net:
        if not ("coordinator" in _explicit_net and "rank" in _explicit_net):
            called = "net_bind" if "rank" in _explicit_net else "net_connect"
            Log.fatal(f"net_bind and net_connect name a group together; "
                      f"only {called} was called")
        return ProcessGroup(str(_explicit_net["coordinator"]),
                            int(_explicit_net["num"]),
                            int(_explicit_net["rank"]))
    coord = (os.environ.get("MV_COORDINATOR_ADDRESS")
             or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    nproc = os.environ.get("MV_NUM_PROCESSES")
    if not (coord and nproc):
        if nproc and int(nproc) > 1:
            Log.fatal(f"MV_NUM_PROCESSES={nproc} without "
                      f"MV_COORDINATOR_ADDRESS: no group to join")
        return None
    size = int(nproc)
    if size == 1:
        return None
    return ProcessGroup(coord, size,
                        int(os.environ.get("MV_PROCESS_ID", "0")))
