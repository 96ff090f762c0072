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
starts from an empty KV.

The mesh (JAX :42-125, :241-273, :305): the port runs one device per
process, so a :class:`Mesh` is a grid of the group's ranks where the JAX
mesh is a grid of devices; rank ``r`` sits where ``make_mesh`` puts
``devices[r]``. Along each axis a rank has a :class:`SubGroup`, the ranks
that share its coordinates on every other axis (on (worker, server): its
row is its tp group, its column its dp group), a gloo group that every
function of ``parallel.collectives`` takes as ``group=``. ``discover``
reads ``-mesh_shape``; its default is (process count, 1), JAX's (workers
= processes, server = the one local device). ``sharding_for`` gives a
partition spec (a tuple naming, per dim, the mesh axis the dim is split
over, or None), ``shard`` this rank's slice of a tensor under one and
``unshard`` the whole tensor back (an all-gather per split dim).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from . import config
from .log import Log

WORKER_AXIS = "worker"
SERVER_AXIS = "server"
SEQ_AXIS = "seq"

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
        # the collectives' view of a group: its ranks in group order and
        # the gloo handle (None: the default group)
        self.ranks = tuple(range(self.size))
        self.handle = None
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
        return _allgather(arr, self.size, None)

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


def _allgather(arr: np.ndarray, size: int, handle) -> np.ndarray:
    """``[size, *arr.shape]``: every member's ``arr`` (same shape and
    dtype everywhere) over the gloo group ``handle`` (None: the default
    group), in group order, bytes moved as they are."""
    import torch
    import torch.distributed as dist

    arr = np.ascontiguousarray(arr)
    if arr.nbytes == 0 or size == 1:
        return np.broadcast_to(arr, (size,) + arr.shape).copy()
    flat = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy())
    out = [torch.empty_like(flat) for _ in range(size)]
    dist.all_gather(out, flat, group=handle)
    return np.stack([o.numpy().view(arr.dtype).reshape(arr.shape)
                     for o in out])


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


def _world() -> Tuple[int, int]:
    """This process's rank in the group and the group's size (0 and 1
    without a group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class SubGroup:
    """The ranks along one mesh axis through this rank, in mesh order: the
    interface ``parallel.collectives`` reads from a group (``rank``,
    ``size``, ``ranks``, ``handle``, ``allgather``)."""

    def __init__(self, ranks: Sequence[int], me: int, handle) -> None:
        self.ranks = tuple(int(r) for r in ranks)
        self.rank = self.ranks.index(me)
        self.size = len(self.ranks)
        self.handle = handle

    def allgather(self, arr: np.ndarray) -> np.ndarray:
        """``[size, *arr.shape]``: every member's ``arr`` in group order."""
        return _allgather(arr, self.size, self.handle)

    def __repr__(self) -> str:
        return f"SubGroup(ranks={self.ranks}, rank={self.rank})"


def _axis_groups(grid: np.ndarray, axis_names: Sequence[str], me: int,
                 world: int) -> Dict[str, SubGroup]:
    """This rank's sub-group along each axis. Creating a gloo group is
    collective over the whole group: every rank creates every sub-group
    of more than one rank, in the same order, the ones it is not in as
    well. A line of one rank needs no group, and one that is the whole
    group in order is the default group."""
    import torch.distributed as dist

    groups: Dict[str, SubGroup] = {}
    for i, axis in enumerate(axis_names):
        for line in np.moveaxis(grid, i, -1).reshape(-1, grid.shape[i]):
            line = tuple(int(r) for r in line)
            handle = None
            if 1 < len(line) and line != tuple(range(world)):
                handle = dist.new_group(
                    list(line), backend="gloo",
                    timeout=timedelta(seconds=CONNECT_TIMEOUT_S))
            if me in line:
                groups[axis] = SubGroup(line, me, handle)
    return groups


class Mesh:
    """A grid of the group's ranks with named axes (the port's
    ``jax.sharding.Mesh``): ``shape`` maps each axis to its size, in
    ``axis_names`` order, ``ranks`` is the grid, ``coords(rank)`` a rank's
    index along each axis (None outside the mesh) and ``group(axis)`` this
    rank's sub-group along ``axis``."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str],
                 rank: int, groups: Dict[str, SubGroup]) -> None:
        self.ranks = ranks
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        self.rank = rank
        self._groups = groups

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def coords(self, rank: Optional[int] = None
               ) -> Optional[Dict[str, int]]:
        """``{axis: index}`` of ``rank`` (default: this rank), None when
        the rank is not in the mesh."""
        rank = self.rank if rank is None else int(rank)
        at = np.argwhere(self.ranks == rank)
        if at.size == 0:
            return None
        return dict(zip(self.axis_names, (int(i) for i in at[0])))

    def group(self, axis: str) -> SubGroup:
        if axis not in self.shape:
            raise ValueError(f"mesh {self.shape} has no axis {axis!r}")
        if axis not in self._groups:
            raise ValueError(f"rank {self.rank} is not in mesh {self.shape}")
        return self._groups[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.ranks.tolist()})"


@dataclass
class Topology:
    """The group and its mesh (JAX ``topology.Topology``)."""

    mesh: Mesh
    process_index: int
    process_count: int
    _local_mesh: Optional[Mesh] = None

    @property
    def num_workers(self) -> int:
        return int(self.mesh.shape[WORKER_AXIS])

    @property
    def num_servers(self) -> int:
        return int(self.mesh.shape[SERVER_AXIS])

    @property
    def local_mesh(self) -> Mesh:
        """A (1, 1) mesh of this rank alone: async-PS tables live here,
        each process updating its replica without collectives."""
        if self._local_mesh is None:
            self._local_mesh = make_mesh((1, 1), ranks=[self.process_index])
        return self._local_mesh

    @property
    def rank(self) -> int:
        return self.process_index

    @property
    def size(self) -> int:
        return self.process_count


def _parse_mesh_shape(text: str) -> Optional[Tuple[int, ...]]:
    text = text.strip()
    if not text:
        return None
    return tuple(int(p) for p in text.split(",") if p.strip())


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = (WORKER_AXIS, SERVER_AXIS),
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over ``ranks`` (default: every rank of the group; one
    process alone is rank 0 of 1), the first ``prod(shape)`` of them in
    C order. ``shape`` defaults to every rank on the last axis. Every
    rank of the group calls it with the same arguments: the sub-groups
    are created collectively. ``ranks`` must increase (gloo numbers a
    group's members in that order)."""
    me, world = _world()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if any(b <= a for a, b in zip(ranks, ranks[1:])):
        raise ValueError(f"mesh ranks {ranks} must increase")
    n = len(ranks)
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axes "
                         f"{tuple(axis_names)}")
    needed = int(np.prod(shape))
    if needed > n:
        raise ValueError(f"mesh shape {shape} needs {needed} ranks, have "
                         f"{n}")
    grid = np.asarray(ranks[:needed], dtype=np.int64).reshape(shape)
    return Mesh(grid, axis_names, me, _axis_groups(grid, axis_names, me,
                                                   world))


def discover(mesh_shape: Optional[Sequence[int]] = None) -> Topology:
    """The group's topology; ``mesh_shape`` (default: ``-mesh_shape``)
    overrides the layout, whose default is one worker per process."""
    if mesh_shape is None:
        mesh_shape = _parse_mesh_shape(config.get_flag("mesh_shape"))
    rank, count = _world()
    if mesh_shape is None:
        mesh_shape = (count, 1)
    topo = Topology(mesh=make_mesh(mesh_shape), process_index=rank,
                    process_count=count)
    Log.debug("topology: mesh %s, process %d/%d", topo.mesh.shape, rank,
              count)
    return topo


def sharding_for(mesh: Mesh, *axes: Optional[str]) -> Tuple:
    """The partition spec ``axes`` (per dim, the mesh axis it is split
    over, or None), each axis checked against ``mesh``:
    ``sharding_for(mesh, SERVER_AXIS)`` splits dim 0 over ``server``."""
    for axis in axes:
        if axis is not None and axis not in mesh.shape:
            raise ValueError(f"mesh {mesh.shape} has no axis {axis!r}")
    return tuple(axes)


def shard(tensor, spec: Sequence[Optional[str]], mesh: Mesh):
    """This rank's slice of ``tensor`` under ``spec``: each split dim cut
    into ``mesh.shape[axis]`` equal pieces, this rank's coordinate's
    piece kept."""
    coords = mesh.coords()
    if coords is None:
        raise ValueError(f"rank {mesh.rank} is not in mesh {mesh.shape}")
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.shape[axis]
        if tensor.shape[dim] % n != 0:
            raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does not "
                             f"divide over {axis}={n}")
        size = tensor.shape[dim] // n
        tensor = tensor.narrow(dim, coords[axis] * size, size)
    return tensor


def unshard(piece, spec: Sequence[Optional[str]], mesh: Mesh):
    """The whole tensor from every rank's ``piece`` under ``spec``: an
    all-gather over the axis's sub-group per split dim (collective over
    those sub-groups)."""
    from .parallel.collectives import all_gather

    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        piece = all_gather(piece.movedim(dim, 0),
                           group=mesh.group(axis)).movedim(0, dim)
    return piece
