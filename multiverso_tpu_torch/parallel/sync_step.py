"""The BSP training step on one table (counterpart of
``multiverso_tpu/parallel/sync_step.py``).

The JAX step is one jitted SPMD program: the batch arrives sharded over
the ``worker`` mesh axis, the mean-loss gradient becomes a ``psum`` over
it, and the table's updater folds ``lr * grad`` into the one logical
array. Here each process holds the whole table (``tables.base``: storage
is not split over the mesh, so every process holds the values of that
one array): each rank takes its worker-axis rows of the batch, computes
its gradient with autograd on the table's logical view, the gradients
are averaged over the worker axis's sub-group of the table's mesh (equal
shards: the mean of their mean-loss gradients is the global batch's),
and every rank applies the same delta through the updater under the
table lock. Every rank of the mesh calls the step with the same global
batch.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..log import Log
from ..tables.base import TableBase
from ..topology import WORKER_AXIS
from ..updaters import AddOption
from . import collectives


def _worker_rows(leaf: torch.Tensor, n: int, i: int) -> torch.Tensor:
    if leaf.shape[0] % n != 0:
        Log.fatal(f"sync step: batch of {leaf.shape[0]} rows does not "
                  f"divide over {n} workers")
    rows = leaf.shape[0] // n
    return leaf[i * rows:(i + 1) * rows]


def make_sync_step(table: TableBase,
                   loss_fn: Callable[[torch.Tensor, Any], torch.Tensor],
                   batch_sharded: bool = True
                   ) -> Callable[[Any, Optional[AddOption]], torch.Tensor]:
    """``step(batch, option) -> loss`` folding gradients into ``table``.

    ``loss_fn(params, batch)`` returns a scalar mean loss; ``batch`` is a
    tensor or array, or a tuple, list or dict of them, whose leaves split
    along dim 0 over the worker axis when ``batch_sharded`` (each rank
    computes on the whole batch otherwise). The step applies ``delta = lr
    * grad`` with the table's updater (``sgd`` descends, ``default``
    accumulates ``+lr * grad``) and returns the global batch's loss.
    """
    mesh = table.mesh
    workers = mesh.shape[WORKER_AXIS]
    group = mesh.group(WORKER_AXIS) if workers > 1 else None
    index = mesh.coords()[WORKER_AXIS] if mesh.coords() else 0

    def local(leaf):
        leaf = torch.as_tensor(leaf, device=table.device)
        return _worker_rows(leaf, workers, index) if batch_sharded else leaf

    def rows(batch):
        if isinstance(batch, dict):
            return {k: rows(v) for k, v in batch.items()}
        if isinstance(batch, (tuple, list)):
            return type(batch)(rows(v) for v in batch)
        return local(batch)

    def step(batch, option: Optional[AddOption] = None) -> torch.Tensor:
        option = option or AddOption()
        batch = rows(batch)
        with table._lock:
            data = table._data.detach().requires_grad_()
            loss = loss_fn(table.logical(data), batch)
            (grad,) = torch.autograd.grad(loss, data)
            loss = loss.detach()
            if group is not None and batch_sharded:
                grad, loss = collectives.allreduce_many([grad, loss], group,
                                                        mean=True)
            lr = torch.tensor(option.learning_rate, dtype=table.dtype,
                              device=table.device)
            table._data, table._ustate = table.updater.apply(
                table._data, table._ustate, lr * grad, option)
            table.version += 1
        return loss

    return step
