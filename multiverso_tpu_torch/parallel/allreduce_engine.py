"""Collective algorithms built from point-to-point exchanges.

Counterpart of ``multiverso_tpu/parallel/allreduce_engine.py:39-208``
(the reference's ``src/net/allreduce_engine.cpp``): Bruck allgather,
recursive-halving reduce-scatter at a power-of-two group size and a
ring reduce-scatter otherwise, and the allreduce that chooses between
allgather-then-sum (payloads under 4 KB, or fewer elements than ranks)
and reduce-scatter + allgather. JAX unrolls each schedule at trace time
into ``ppermute`` steps over a mesh axis; here each step is one paired
send/receive of the process group (``collectives._permute``, the
primitive under ``ring_shift``), staged through the host for CUDA
tensors, with every sum taken on the caller's device. Nothing here calls
``dist.all_reduce``. ``collectives.allreduce`` stays the plain path; the
engine is the alternative for custom schedules, as in the reference.

Layout: each process passes its own shard or buffer (the JAX functions
take the global ``[n, ...]`` array sharded over the axis).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .collectives import _permute, _sum_in_order, group_rank_size


# -- step schedules (the reference's BruckMap / RecursiveHalvingMap) ---------

def bruck_schedule(n: int) -> List[Tuple[int, int]]:
    """Bruck allgather steps for an ``n`` ring: list of (distance,
    blocks_to_send). ``ceil(log2 n)`` steps, doubling block counts, with a
    truncated final step when ``n`` is not a power of two
    (``allreduce_topo.cpp:20`` BruckMap::Construct)."""
    steps = []
    m = 1
    while m < n:
        steps.append((m, min(m, n - m)))
        m *= 2
    return steps


def recursive_halving_schedule(n: int) -> List[int]:
    """Pair distances for recursive-halving reduce-scatter; empty when ``n``
    is not a power of two (those sizes take the ring path instead of the
    reference's GroupLeader pairing, ``allreduce_topo.cpp:58-150``)."""
    if n & (n - 1):
        return []
    steps = []
    d = n // 2
    while d >= 1:
        steps.append(d)
        d //= 2
    return steps


class AllreduceEngine:
    """Allgather / ReduceScatter / Allreduce built from paired exchanges
    (``include/multiverso/net/allreduce_engine.h:80-147``) over ``group``
    (default: the session's)."""

    SMALL_PAYLOAD_BYTES = 4096  # reference's allgather-allreduce cutoff

    def __init__(self, group=None) -> None:
        self.group = group
        self.rank, self.n = group_rank_size(group)

    def _exchange(self, x: torch.Tensor, dst: int, src: int) -> torch.Tensor:
        return _permute([x], dst, src, self.group)[0]

    def _bruck_gather(self, block: torch.Tensor) -> torch.Tensor:
        """Every rank's ``block`` (leading dim ``c``) as ``[n*c, ...]`` in
        rank order."""
        n, idx = self.n, self.rank
        c = block.shape[0]
        buf = block
        for dist, send_blocks in bruck_schedule(n):
            recv = self._exchange(buf[: send_blocks * c], (idx - dist) % n,
                                  (idx + dist) % n)
            buf = torch.cat([buf, recv])
        # buf rows are blocks [i, i+1, ..., i+n-1]; rotate block b to row b
        return torch.roll(buf, idx * c, dims=0)

    def _halving_reduce_scatter(self, vec: torch.Tensor) -> torch.Tensor:
        """Recursive-halving reduce-scatter of the full-size ``vec``
        (leading dim divisible by n): this rank's reduced chunk."""
        idx = self.rank
        buf = vec
        for d in recursive_halving_schedule(self.n):
            half = buf.shape[0] // 2
            side = (idx // d) % 2   # my address bit at this distance
            keep = buf[side * half:(side + 1) * half]
            send = buf[(1 - side) * half:(2 - side) * half]
            buf = keep + self._exchange(send, idx ^ d, idx ^ d)
        return buf

    def _ring_reduce_scatter(self, vec: torch.Tensor) -> torch.Tensor:
        """Ring reduce-scatter for any ring size (n-1 neighbour steps):
        this rank's reduced chunk."""
        n, idx = self.n, self.rank
        buf = vec.reshape((n, vec.shape[0] // n) + tuple(vec.shape[1:])
                          ).clone()
        # the schedule starts one chunk behind the owner, so that after
        # n-1 steps rank i holds its fully reduced chunk i
        for s in range(n - 1):
            recv = self._exchange(buf[(idx - s - 1) % n], (idx + 1) % n,
                                  (idx - 1) % n)
            buf[(idx - s - 2) % n] += recv
        return buf[idx]

    def _reduce_scatter_shard(self, vec: torch.Tensor) -> torch.Tensor:
        if recursive_halving_schedule(self.n):
            return self._halving_reduce_scatter(vec)
        return self._ring_reduce_scatter(vec)

    # -- public ops --------------------------------------------------------
    def allgather(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's shard ``[c, ...]`` -> every rank's, ``[n*c, ...]``
        in rank order (``AllreduceEngine::Allgather``, Bruck)."""
        return self._bruck_gather(x)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's full-size contribution ``[k, ...]`` (k divisible by
        n) -> rows ``[r k/n, (r+1) k/n)`` of the sum
        (``AllreduceEngine::ReduceScatter``)."""
        if x.dim() == 0 or x.shape[0] % self.n != 0:
            raise ValueError(f"reduce_scatter expects [k, ...] with k "
                             f"divisible by n={self.n}, got "
                             f"{tuple(x.shape)}")
        return self._reduce_scatter_shard(x)

    def allreduce(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's buffer -> the elementwise sum of every rank's
        (``AllreduceEngine::Allreduce``).

        Payloads under ``SMALL_PAYLOAD_BYTES`` (or with fewer elements than
        ranks) take the allgather-then-sum path; larger ones
        reduce-scatter + allgather, both cutoffs as in the reference
        (``allreduce_engine.cpp:31-44``). The buffer is raveled, so its
        trailing dims need not divide n, and zero-padded to a multiple of
        n for the scatter.
        """
        n = self.n
        k = x.numel()
        if k * x.element_size() < self.SMALL_PAYLOAD_BYTES or k < n:
            return _sum_in_order(self._bruck_gather(x[None]))
        flat = x.reshape(-1)
        pad = -k % n
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        full = self._bruck_gather(self._reduce_scatter_shard(flat))
        return full[:k].reshape(x.shape)
