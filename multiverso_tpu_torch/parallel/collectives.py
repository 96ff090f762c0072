"""Collectives over the process group, on each process's local shard.

Counterpart of ``multiverso_tpu/parallel/collectives.py:36-131``. The JAX
functions take a global array sharded over a mesh axis and compile to
ICI collectives (``psum``, ``all_gather``, ``psum_scatter``,
``ppermute``); here each process holds one shard and calls the function
with it, and the mesh axis becomes a process group: by default the
session's (``topology.ProcessGroup``), or a mesh axis's sub-group,
``group=mesh.group(axis)`` (``topology.SubGroup``). A process alone is a
group of one: every function then returns its input's value.

The group is gloo (``topology.py``: NCCL refuses two ranks on one card),
and gloo moves host tensors. So a CUDA tensor is staged through host
memory explicitly: its bytes are copied to the host, exchanged as
``uint8`` buffers, and copied back to the caller's device, where every
sum is taken. The results lie on the caller's device; only bytes go
through the host. :data:`STATS` counts what the exchanges cost:

* ``staged_bytes``: bytes copied between a CUDA device and the host
  (each way counted), 0 for CPU tensors;
* ``exchanges``: gloo exchanges made;
* ``exchange_s``: host seconds inside them, staging included, from the
  moment the device's queued work has finished.

* :func:`allreduce` / :func:`allreduce_replicated` — the sum (or mean)
  of every process's tensor, summed on the device in rank order;
* :func:`all_gather` — every process's shard concatenated along dim 0
  in rank order (JAX's ``tiled=True``);
* :func:`reduce_scatter` — this rank's ``k/n`` slice of the sum of every
  process's ``[k, ...]`` contribution;
* :func:`ring_shift` — rank ``r`` receives rank ``r - shift``'s tensor,
  every send paired with a receive (``batch_isend_irecv``), so a ring of
  any size cannot deadlock;
* :func:`all_to_all` — JAX's tiled ``lax.all_to_all`` (used by
  ``ops/ulysses.py``): split along ``split_dim``, piece ``j`` to rank
  ``j``, the pieces received concatenated along ``concat_dim`` in rank
  order, over gloo's ``all_to_all_single``.

:func:`ring_shift` and :func:`all_to_all` are differentiable (the
backward of a shift is the reverse shift, of an all-to-all the reverse
all-to-all), as JAX differentiates through ``ppermute`` and
``all_to_all``.

Megatron tensor parallelism over a tp group (what XLA inserts for the
JAX trainer's column/row-parallel shardings), differentiable:

* :func:`copy_to_tp` — the identity forward; backward, the sum of the
  gradient over the group;
* :func:`reduce_from_tp` — the sum over the group forward; the identity
  backward;
* :func:`gather_from_tp` — the row shards gathered forward; backward,
  this rank's rows of the gradient (everything after the gather is
  computed alike on every rank of the group, so each holds the whole
  gradient already).

Their sums, and :func:`allreduce_many`'s, add in rank order on the
device and, for 16-bit floats, in f32 with one rounding at the end (a
row-parallel product's partials summed in bf16 would round once per
rank).

For the serving engine over a tp group (``serving/decode_engine.py``):

* :func:`allreduce_max_many` — the elementwise max over the group of
  each of several tensors, in one exchange (exact in any order: an int8
  KV block's scale is the amax over the whole ``D`` that the group
  splits);
* :func:`broadcast` — a host tensor from one rank to every rank of the
  group, in place (the engine's commands).
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..runtime import Session

STATS: Dict[str, float] = {"staged_bytes": 0, "exchanges": 0,
                           "exchange_s": 0.0}


def reset_stats() -> None:
    STATS.update(staged_bytes=0, exchanges=0, exchange_s=0.0)


def _group(group=None):
    """``(group, rank, size)``: the given group, else the session's; a
    process alone is rank 0 of 1 with no group."""
    if group is None:
        group = Session.get().group
    if group is None:
        return None, 0, 1
    return group, group.rank, group.size


def group_rank_size(group=None) -> Tuple[int, int]:
    """This process's rank and the group's size (0 and 1 alone)."""
    _, rank, size = _group(group)
    return rank, size


def check_equal_shards(length: int, group=None, what: str = "shards"
                       ) -> None:
    """Raise ``ValueError`` on every rank unless every rank's shard has
    ``length`` rows: the sequence must divide over the group (one small
    exchange of the lengths on the host, counted in :data:`STATS`)."""
    g, _, size = _group(group)
    if size == 1:
        return
    t0 = time.perf_counter()
    lengths = g.allgather(np.array([length], np.int64))[:, 0]
    STATS["exchanges"] += 1
    STATS["exchange_s"] += time.perf_counter() - t0
    if (lengths != length).any():
        raise ValueError(f"seq shards of {lengths.tolist()} rows: the "
                         f"sequence must divide over {size} {what}")


def _padded(nbytes: int) -> int:
    """Each tensor starts on 16 bytes in a packed buffer, so the views
    unpacked from it meet the flash kernels' 16-byte loads."""
    return -(-nbytes // 16) * 16


class _Exchange:
    """One exchange's staging: tensors packed into one host ``uint8``
    buffer, and a received host buffer unpacked onto the device as
    views, one a tensor."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        if device.type == "cuda":
            # the copies below wait for the work queued on the stream;
            # the clock starts once it is done
            torch.cuda.current_stream(device).synchronize()
        self.t0 = time.perf_counter()

    def pack(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        flat = [t.detach().contiguous().reshape(-1).view(torch.uint8)
                for t in tensors]
        buf = torch.empty(sum(_padded(f.numel()) for f in flat),
                          dtype=torch.uint8, device=self.device)
        at = 0
        for f in flat:
            buf[at:at + f.numel()].copy_(f)
            at += _padded(f.numel())
        if self.device.type != "cpu":
            STATS["staged_bytes"] += buf.numel()
            buf = buf.cpu()
        return buf

    def unpack(self, buf: torch.Tensor, metas) -> List[torch.Tensor]:
        """``metas``: the ``(shape, dtype)`` of each tensor in ``buf``."""
        if self.device.type != "cpu":
            STATS["staged_bytes"] += buf.numel()
            buf = buf.to(self.device)
        out, at = [], 0
        for shape, dtype in metas:
            n = torch.Size(shape).numel() * dtype.itemsize
            out.append(buf[at:at + n].view(dtype).reshape(shape))
            at += _padded(n)
        return out

    def done(self) -> None:
        STATS["exchanges"] += 1
        STATS["exchange_s"] += time.perf_counter() - self.t0


def _metas(tensors):
    return [(t.shape, t.dtype) for t in tensors]


def _permute(tensors: Sequence[torch.Tensor], dst: int, src: int,
             group=None) -> List[torch.Tensor]:
    """Send ``tensors`` to rank ``dst`` and receive the same shapes from
    rank ``src`` (one paired ``isend``/``irecv`` of one packed buffer):
    JAX's ``ppermute`` seen from one rank. Not differentiable."""
    g, rank, size = _group(group)
    if size == 1 or (dst == rank and src == rank):
        return [t.detach().clone() for t in tensors]
    ex = _Exchange(tensors[0].device)
    send = ex.pack(tensors)
    recv = torch.empty_like(send)
    # peers are named by their rank in the whole group
    ops = [dist.P2POp(dist.isend, send, g.ranks[dst], g.handle),
           dist.P2POp(dist.irecv, recv, g.ranks[src], g.handle)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = ex.unpack(recv, _metas(tensors))
    ex.done()
    return out


def _gather_stacked(x: torch.Tensor, group=None) -> torch.Tensor:
    """``[size, *x.shape]``: every rank's ``x`` in rank order, on x's
    device."""
    return torch.stack(_gather_packed([x], group)[0])


def _gather_packed(tensors: Sequence[torch.Tensor], group=None
                   ) -> List[List[torch.Tensor]]:
    """``out[i][r]``: rank ``r``'s ``tensors[i]`` (same shapes and dtypes
    on every rank), all of them moved in one exchange."""
    g, _, size = _group(group)
    if size == 1:
        return [[t.detach().clone()] for t in tensors]
    ex = _Exchange(tensors[0].device)
    send = ex.pack(tensors)
    bufs = [torch.empty_like(send) for _ in range(size)]
    dist.all_gather(bufs, send, group=g.handle)
    views = ex.unpack(torch.cat(bufs), _metas(tensors) * size)
    ex.done()
    return [views[i::len(tensors)] for i in range(len(tensors))]


def _sum_in_order(stacked) -> torch.Tensor:
    """``stacked[0] + stacked[1] + ...``, added in that order."""
    total = stacked[0].clone()
    for part in stacked[1:]:
        total += part
    return total


def _sum_wide(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """:func:`_sum_in_order`, in f32 for 16-bit floats and rounded once
    to their dtype at the end."""
    dtype = parts[0].dtype
    if dtype.is_floating_point and dtype.itemsize < 4:
        return _sum_in_order([p.float() for p in parts]).to(dtype)
    return _sum_in_order(parts)


def allreduce(x: torch.Tensor, group=None, mean: bool = False
              ) -> torch.Tensor:
    """The sum (or mean) of every process's ``x``, added in rank order on
    x's device (``MV_Aggregate``'s form, JAX's ``psum``)."""
    _, _, size = _group(group)
    total = _sum_in_order(_gather_stacked(x, group))
    return total / size if mean else total


def allreduce_replicated(x: torch.Tensor, group=None, mean: bool = False
                         ) -> torch.Tensor:
    """Allreduce of a value each process holds whole. JAX tells it from
    :func:`allreduce` by layout (a replicated array against one sharded
    on axis 0); each process here passes its own value either way, so
    the two compute the same sum."""
    return allreduce(x, group=group, mean=mean)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every process's shard concatenated along dim 0 in rank order."""
    stacked = _gather_stacked(x, group)
    return stacked.reshape((-1,) + tuple(x.shape[1:]))


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's slice of the elementwise sum: ``x`` is this process's
    full-size contribution ``[k, ...]`` with ``k`` divisible by the group
    size ``n``; rank ``r`` gets rows ``[r k/n, (r+1) k/n)`` of the sum
    (one all-to-all of the chunks, then their sum on the device)."""
    _, _, size = _group(group)
    if x.dim() == 0 or x.shape[0] % size != 0:
        raise ValueError(f"reduce_scatter expects [k, ...] with k divisible "
                         f"by n={size}, got {tuple(x.shape)}")
    mine = all_to_all(x, 0, 0, group)        # every rank's chunk r
    return _sum_in_order(mine.reshape((size, -1) + tuple(x.shape[1:])))


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dst, src, group, *tensors):
        ctx.route = (src, dst, group)
        return tuple(_permute(tensors, dst, src, group))

    @staticmethod
    def backward(ctx, *grads):
        # each gradient goes back the way its tensor came
        return (None, None, None) + tuple(_permute(grads, *ctx.route))


def permute(tensors: Sequence[torch.Tensor], dst: int, src: int,
            group=None) -> List[torch.Tensor]:
    """:func:`_permute` that autograd follows: the backward sends each
    gradient to ``src`` and receives from ``dst``, one packed exchange
    either way."""
    return list(_Permute.apply(dst, src, group, *tensors))


def ring_shift(x: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """Rotate shards around the ring: rank ``r`` sends ``x`` to rank
    ``r + shift`` and returns rank ``r - shift``'s (mod the size), the
    building block of ring attention and the allreduce engine."""
    _, rank, size = _group(group)
    return permute([x], (rank + shift) % size, (rank - shift) % size,
                   group)[0]


def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
                group) -> torch.Tensor:
    _, _, size = _group(group)
    if x.shape[split_dim] % size != 0:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not divide over {size} ranks")
    if size == 1:
        return x.detach().clone()
    pieces = torch.stack(x.detach().chunk(size, dim=split_dim))
    ex = _Exchange(x.device)
    # one packed piece a rank: [size * padded piece bytes], split evenly
    send = ex.pack(pieces.unbind(0))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=_group(group)[0].handle)
    got = ex.unpack(recv, _metas(pieces.unbind(0)))
    ex.done()
    return torch.cat(got, dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(g, concat_dim, split_dim, ctx.group), None,
                None, None)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
               group=None) -> torch.Tensor:
    """JAX's tiled ``lax.all_to_all``: ``x`` splits into ``n`` equal pieces
    along ``split_dim``, piece ``j`` goes to rank ``j``, and the ``n``
    pieces received concatenate along ``concat_dim`` in rank order."""
    return _AllToAll.apply(x, split_dim, concat_dim, group)


def allreduce_many(tensors: Sequence[torch.Tensor], group=None,
                   mean: bool = False) -> List[torch.Tensor]:
    """:func:`allreduce` of each of ``tensors`` (any shapes and dtypes),
    all moved in one exchange; each sum is :func:`_sum_wide`'s."""
    _, _, size = _group(group)
    out = [_sum_wide(parts) for parts in _gather_packed(tensors, group)]
    return [t / size for t in out] if mean else out


def allreduce_max_many(tensors: Sequence[torch.Tensor], group=None
                       ) -> List[torch.Tensor]:
    """The elementwise max over every process of each of ``tensors``
    (same shapes and dtypes on every rank), all moved in one exchange."""
    return [torch.stack(parts).amax(dim=0)
            for parts in _gather_packed(tensors, group)]


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``x`` (a host tensor of the same shape and dtype on every rank)
    overwritten in place with rank ``src``'s, and returned."""
    g, _, size = _group(group)
    if size == 1:
        return x
    t0 = time.perf_counter()
    dist.broadcast(x, src=g.ranks[src], group=g.handle)
    STATS["exchanges"] += 1
    STATS["exchange_s"] += time.perf_counter() - t0
    return x


def _sum_over(x: torch.Tensor, group) -> torch.Tensor:
    return _sum_wide(_gather_packed([x], group)[0])


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_over(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rows, ctx.rank = x.shape[0], _group(group)[1]
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.rank * ctx.rows, ctx.rows), None


def copy_to_tp(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` as it is; its gradient is summed over ``group`` (the input
    of a column-parallel product, whose every rank's partial gradient
    adds up to the whole)."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x`` (a row-parallel product's partials);
    its gradient passes as it is."""
    return _ReduceFromTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's row shard ``x`` concatenated in rank order; the
    gradient of the whole goes back as this rank's rows of it, with no
    exchange (module docstring)."""
    return _GatherFromTP.apply(x, group)
