"""Versioned copy-on-publish read views over live parameter state.

Counterpart of ``multiverso_tpu/serving/snapshot.py::SnapshotManager``: a
snapshot is one copy of the source's parameters taken under its lock, and
it is republished only when the source version moved AND the published
copy is older than the staleness bound, so a reply always knows its
version and how stale it may be. A source is a model (``snapshot_params``),
a table (``snapshot_array``) or a ``(read, version_fn)`` pair.

Also here: :class:`DerivedCache` (one artifact per snapshot version, for
the micro-batched workloads), :func:`quantize_decode_params` (the int8
decode parameter pin, host numpy, once per pinned version), and the pin's
placement: :func:`replicate_for_decode` (one process) and
:func:`shard_for_decode` (a decode engine's tp group of processes).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..log import Log


@dataclass(frozen=True)
class Snapshot:
    """Immutable published view: a params copy + its source version, and
    for fenced sources the trainer incarnation epoch the state derives
    from (a pin carries (epoch, version) together)."""

    value: Any
    version: int
    published_at: float
    epoch: int = 0


class DerivedCache:
    """Per-snapshot-version derived artifact: ``fn(snap.value)`` computed
    once per publish and reused until training moves the source. ``get``
    is serialized, so readers racing a publish compute it once."""

    def __init__(self, fn: Callable[[Any], Any]) -> None:
        self._fn = fn
        self._cached: Tuple[int, Any] = (-1, None)
        self._lock = threading.Lock()

    def get(self, snap: Snapshot) -> Any:
        with self._lock:
            ver, value = self._cached
            if ver != snap.version:
                value = self._fn(snap.value)
                self._cached = (snap.version, value)
            return value


def quantize_decode_params(value: Dict[str, Any]) -> Dict[str, Any]:
    """int8 symmetric snapshot of a parameter dict for decode pinning.

    Every tensor becomes ``{"q": int8, "s": fp32 scale}``, per column
    (the input axis reduced, kept) for matrices and per tensor for
    vectors, on the tensor's device. The arithmetic is host numpy, the
    JAX function's (:func:`~..quantization.quantize_int8`), so both
    packages give the same bytes; it runs once per pinned snapshot
    version. ``models.transformer.dequantize_decode_params`` inverts it
    at the top of every serving program."""
    from ..quantization import quantize_int8

    def quant(leaf: torch.Tensor) -> Dict[str, torch.Tensor]:
        host = leaf.detach().to("cpu", torch.float32).numpy()
        q, s = quantize_int8(host, axis=-2 if host.ndim >= 2 else None)
        return {"q": torch.from_numpy(q).to(leaf.device),
                "s": torch.from_numpy(np.asarray(s, np.float32)).to(
                    leaf.device)}

    return {k: ({n: quant(w) for n, w in v.items()} if isinstance(v, dict)
                else quant(v)) for k, v in value.items()}


def replicate_for_decode(value: Dict[str, Any]) -> Dict[str, Any]:
    """A one-process decode engine's pin (JAX :76): the snapshot itself.
    JAX copies it onto one device to keep its per-token programs off the
    partitioner; a port snapshot is already a private copy on the model's
    one device, so pinning it copies nothing."""
    return value


def _leaves(tree: Dict[str, Any], prefix: str = "") -> List[Tuple[str, Any]]:
    """``(dotted path, leaf)`` in the tree's order; a tuple (a partition
    spec) is a leaf."""
    out: List[Tuple[str, Any]] = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(_leaves(v, f"{prefix}{k}."))
        else:
            out.append((prefix + k, v))
    return out


def _tree(leaves: List[Tuple[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in leaves:
        *parents, name = path.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = v
    return out


def _slice(t: torch.Tensor, spec, coord: int, n: int) -> torch.Tensor:
    """Coordinate ``coord``'s piece of ``t`` under ``spec`` over an axis
    of ``n`` ranks."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            if t.shape[dim] % n != 0:
                Log.fatal(f"shard_for_decode: dim {dim} of "
                          f"{tuple(t.shape)} does not divide over {n} ranks")
            size = t.shape[dim] // n
            t = t.narrow(dim, coord * size, size)
    return t


def _send_pieces(pieces: List[Tuple[str, torch.Tensor]], dst: int,
                 group) -> None:
    """One rank's pieces to group rank ``dst``: a header (two int64: the
    meta's and the data's bytes), then one buffer of the meta (JSON paths,
    shapes and dtypes) and every piece's bytes at 16-byte offsets."""
    import torch.distributed as dist

    from ..parallel import collectives

    meta = json.dumps([[p, list(t.shape), str(t.dtype).split(".")[-1]]
                       for p, t in pieces]).encode()
    at = collectives._padded(len(meta))
    spans = []
    for _, t in pieces:
        n = t.numel() * t.element_size()
        spans.append((at, n))
        at += collectives._padded(n)
    buf = torch.zeros(at, dtype=torch.uint8)
    buf[:len(meta)] = torch.frombuffer(bytearray(meta), dtype=torch.uint8)
    for (start, n), (_, t) in zip(spans, pieces):
        raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
        if raw.device.type != "cpu":
            collectives.STATS["staged_bytes"] += n
        buf[start:start + n] = raw.cpu()
    t0 = time.perf_counter()
    peer = group.ranks[dst]
    dist.send(torch.tensor([len(meta), at], dtype=torch.int64), dst=peer,
              group=group.handle)
    dist.send(buf, dst=peer, group=group.handle)
    collectives.STATS["exchanges"] += 1
    collectives.STATS["exchange_s"] += time.perf_counter() - t0


def _recv_pieces(src: int, group, device) -> List[Tuple[str, torch.Tensor]]:
    """:func:`_send_pieces`' pieces from group rank ``src``, on
    ``device``."""
    import torch.distributed as dist

    from ..parallel import collectives

    t0 = time.perf_counter()
    peer = group.ranks[src]
    header = torch.zeros(2, dtype=torch.int64)
    dist.recv(header, src=peer, group=group.handle)
    n_meta, total = (int(x) for x in header)
    buf = torch.empty(total, dtype=torch.uint8)
    dist.recv(buf, src=peer, group=group.handle)
    collectives.STATS["exchanges"] += 1
    collectives.STATS["exchange_s"] += time.perf_counter() - t0
    meta = json.loads(bytes(buf[:n_meta].numpy()).decode())
    if torch.device(device).type != "cpu":
        collectives.STATS["staged_bytes"] += total - n_meta
    at = collectives._padded(n_meta)
    out = []
    for path, shape, dtype in meta:
        dtype = getattr(torch, dtype)
        n = int(np.prod(shape)) * dtype.itemsize
        piece = buf[at:at + n].view(dtype).reshape(shape)
        out.append((path, piece.to(device, copy=True)))
        at += collectives._padded(n)
    return out


def shard_for_decode(value: Optional[Dict[str, Any]], decode_mesh,
                     shardings: Optional[Dict[str, Any]] = None,
                     tp_axis: str = "tp", device: Any = None
                     ) -> Dict[str, Any]:
    """This rank's slices of a parameter snapshot over the decode mesh
    (JAX :93), once per pinned version; collective over the mesh's
    ``tp_axis`` group. The group's leader (its rank 0) passes the whole
    ``value`` and sends every other rank that rank's slices, one buffer
    each; the others pass None and receive theirs onto ``device``
    (default: the session's).
    ``shardings`` is the spec tree matching ``value`` (None: the
    transformer's serving layout, ``models.transformer.
    decode_param_shardings``, or its int8 form when ``value`` is an int8
    pin). Returns the rank's slices, each a tensor of its own."""
    group = decode_mesh.group(tp_axis)
    if group.rank != 0:
        from ..models.transformer import _session_device

        return _tree(_recv_pieces(0, group, _session_device(device)))
    if shardings is None:
        from ..models import transformer as tf

        quant = isinstance(value["embed"], dict)
        shardings = (tf.decode_param_quant_shardings if quant
                     else tf.decode_param_shardings)(decode_mesh, tp_axis)
    leaves = _leaves(value)
    specs = dict(_leaves(shardings))
    n = group.size
    for r in range(1, n):
        _send_pieces([(p, _slice(t, specs[p], r, n)) for p, t in leaves],
                     r, group)
    return _tree([(p, _slice(t, specs[p], 0, n).clone(
        memory_format=torch.contiguous_format)) for p, t in leaves])


class SnapshotManager:
    """Publishes/refreshes snapshots of one source (a model with the
    ``snapshot_params``/``version`` contract, or a ``(read, version_fn)``
    pair)."""

    def __init__(self, read: Callable[[], Tuple[Any, int]],
                 version_fn: Callable[[], int], name: str = "snapshot",
                 epoch_fn: Optional[Callable[[], int]] = None):
        self._read = read
        self._version_fn = version_fn
        self._epoch_fn = epoch_fn or (lambda: 0)
        self.name = name
        self._lock = threading.Lock()
        self._snap: Optional[Snapshot] = None
        self.publishes = 0  # copies actually taken (copy-on-publish)
        # when the source version last moved, as seen by any probe here
        self._seen_version = self._version_fn()
        self._last_move = time.monotonic()

    @classmethod
    def of(cls, source: Any, name: Optional[str] = None) -> "SnapshotManager":
        label = name or getattr(source, "name", type(source).__name__)
        epoch_fn = (lambda: int(getattr(source, "epoch", 0)))
        if hasattr(source, "snapshot_array"):
            return cls(source.snapshot_array, lambda: source.version, label,
                       epoch_fn=epoch_fn)
        if hasattr(source, "snapshot_params"):
            return cls(source.snapshot_params, lambda: source.version,
                       label, epoch_fn=epoch_fn)
        if isinstance(source, tuple) and len(source) == 2:
            return cls(source[0], source[1], label)
        Log.fatal(f"SnapshotManager: {type(source).__name__} exposes "
                  "neither snapshot_array nor snapshot_params")

    def publish(self) -> Snapshot:
        """Force a fresh copy (the copy-on-publish event)."""
        with self._lock:
            value, version = self._read()
            self._snap = Snapshot(value, version, time.monotonic(),
                                  epoch=self._epoch_fn())
            self._note_version_locked(version)
            self.publishes += 1
            return self._snap

    def current(self) -> Snapshot:
        with self._lock:
            snap = self._snap
        return snap if snap is not None else self.publish()

    def ensure_fresh(self, max_staleness_s: float) -> Snapshot:
        """Republish iff the source moved AND the copy is older than the
        bound."""
        snap = self.current()
        if snap.version != self._version_fn():
            if time.monotonic() - snap.published_at > max_staleness_s:
                return self.publish()
        return snap

    def staleness_s(self, snap: Snapshot) -> float:
        """0 while the snapshot IS the live state, else the copy's age."""
        if snap.version == self._version_fn():
            return 0.0
        return time.monotonic() - snap.published_at

    # -- params staleness -------------------------------------------------
    def _note_version_locked(self, version: int) -> None:
        if version != self._seen_version:
            self._seen_version = version
            self._last_move = time.monotonic()

    def params_age_s(self) -> float:
        """Seconds since the source version last moved (as observed): 0
        while training flows, growing while the trainer is silent. The
        version probe runs outside the manager lock."""
        version = self._version_fn()
        with self._lock:
            self._note_version_locked(version)
            return time.monotonic() - self._last_move

    def params_stale(self, stale_after_s: float,
                     age_s: Optional[float] = None) -> bool:
        """The source has been frozen past ``stale_after_s`` (<= 0
        disables the verdict). ``age_s`` reuses a probe already taken."""
        if age_s is None:
            age_s = self.params_age_s()
        return stale_after_s > 0 and age_s > stale_after_s
