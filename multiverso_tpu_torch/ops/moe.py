"""Mixture-of-experts layer with expert parallelism over an ``expert`` axis.

Counterpart of ``multiverso_tpu/ops/moe.py``. The JAX layer is a
``shard_map`` over the ``expert`` mesh axis; here each process of a
port :class:`~..topology.Mesh` is one shard of that axis, and the two
``lax.all_to_all`` of the Switch dispatch are ``collectives.all_to_all``
(JAX's tiled form, differentiable: the backward is the reverse
all-to-all), staged through the host for CUDA tensors:

  1. top-1 gating with capacity ``C`` (:func:`top1_gating`: tokens over
     capacity are dropped, their combine weight is zero);
  2. this rank's tokens are packed into per-expert buffers ``[E, C, d]``
     and exchanged so that each rank holds ``[E/S, S*C, d]`` for its
     local experts;
  3. the local experts run with the expert dim written out as a batch
     dim (JAX's ``vmap``);
  4. the reverse all-to-all returns the expert outputs, combined with the
     gate weights.

The JAX layer packs and combines with einsums over one-hot ``[T, E, C]``
tensors; :func:`moe_apply` moves the same rows by index (each ``[e, c]``
slot holds at most one token, so the einsum's sum has one nonzero term:
the copies and the one product per row are the einsums' results). The
expert products are plain matrix products (``torch.matmul``), as JAX
leaves them to XLA: no kernel is written for this layer.

Every rank passes the whole token batch ``[T, d]`` and the whole expert
stack ``[E, ...]``; each routes its own ``T/S`` rows and runs its own
``E/S`` experts, and gets its rows of the output. Gradients are shares,
as in ``parallel.pipeline``: each expert's gradient lands on the rank
that owns it, the router's is this rank's tokens' part (the sum over the
axis is JAX's), and the auxiliary loss, averaged over the axis and the
same on every rank, counts once: each rank's own term takes ``1/S`` of
its cotangent.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import collectives
from ..topology import Mesh

EXPERT_AXIS = "expert"


def _route(logits: torch.Tensor, capacity: int):
    """Switch-style top-1 routing of ``logits`` ``[T, E]``:
    ``(expert [T], position [T], keep [T], gate [T], aux)``, each token's
    expert, its 0-based slot in that expert's buffer (counted in int32
    whatever the logits' dtype: a bf16 count loses integer exactness past
    256 tokens and would pack tokens into one slot), whether it fits in
    ``capacity``, its gate probability and the load-balancing loss."""
    n_experts = logits.shape[-1]
    gates = torch.softmax(logits, dim=-1)                         # [T, E]
    expert = torch.argmax(gates, dim=-1)                          # [T]
    onehot_i = F.one_hot(expert, n_experts).to(torch.int32)       # [T, E]
    position = (torch.cumsum(onehot_i, 0, dtype=torch.int32)
                * onehot_i).sum(-1, dtype=torch.int32) - 1                         # [T]
    keep = position < capacity
    gate = gates.gather(-1, expert[:, None])[:, 0]                # [T]
    frac_routed = onehot_i.to(logits.dtype).mean(0)               # [E]
    mean_gate = gates.mean(0)                                     # [E]
    aux = (frac_routed * mean_gate).sum() * n_experts
    return expert, position, keep, gate, aux


def top1_gating(logits: torch.Tensor, capacity: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Switch-style top-1 gating (JAX :40-74).

    Args:
      logits: ``[T, E]`` router logits for T tokens over E experts.
      capacity: per-expert token budget C.

    Returns ``(dispatch, combine, aux_loss)``: ``dispatch`` a ``[T, E,
    C]`` 0/1 routing tensor, ``combine = dispatch * gate`` carrying the
    gate probabilities, and ``aux_loss`` the load-balancing loss (the sum
    over experts of fraction routed x mean gate, times E), all in the
    logits' dtype.
    """
    n_tokens, n_experts = logits.shape
    expert, position, keep, gate, aux = _route(logits, capacity)
    flat = torch.where(keep, expert * capacity + position.long(),
                       n_experts * capacity)
    dispatch = torch.zeros((n_tokens, n_experts * capacity + 1),
                           dtype=logits.dtype, device=logits.device)
    dispatch.scatter_(1, flat[:, None], 1)
    dispatch = dispatch[:, :-1].reshape(n_tokens, n_experts, capacity)
    return dispatch, dispatch * gate[:, None, None], aux


class _AxisMean(torch.autograd.Function):
    """JAX's ``pmean`` of a value each rank holds: the mean over the
    group forward; backward, this rank's ``1/S`` share of the cotangent
    (the mean is one replicated value, counted once)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.size = collectives.group_rank_size(group)[1]
        return collectives.allreduce(x, group, mean=True)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None


def moe_apply(expert_fn: Callable[[Any, torch.Tensor], torch.Tensor],
              expert_params: Any, router_w: torch.Tensor, x: torch.Tensor,
              mesh: Mesh, axis: str = EXPERT_AXIS,
              capacity_factor: float = 2.0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE layer (module docstring).

    Args:
      expert_fn: ``(local experts' params, tokens [E/S, n, d]) -> [E/S, n,
        d]``, the expert dim a batch dim (:func:`mlp_expert`).
      expert_params: dict of tensors with leading dim ``E`` on every leaf
        (the whole stack; this rank runs its ``E/S``).
      router_w: ``[d, E]`` router weights, the same on every rank.
      x: ``[T, d]`` tokens, the same on every rank; rank ``r`` of the axis
        routes rows ``[r T/S, (r + 1) T/S)``.
      mesh: mesh containing ``axis`` of size S; ``E % S == 0`` and ``T % S
        == 0``. Every rank of the axis calls together (and runs the
        backward together).
      capacity_factor: per-expert buffer ``C = ceil(cf * T/S / E)``.

    Returns ``(y, aux_loss)``: this rank's ``[T/S, d]`` rows of the
    output, and the load-balancing loss averaged over the axis.
    """
    group = mesh.group(axis)            # ValueError: no such axis, not in it
    n_shards = int(mesh.shape[axis])
    n_experts = int(router_w.shape[-1])
    if n_experts % n_shards != 0:
        raise ValueError(f"E={n_experts} not divisible by mesh axis "
                         f"{axis}={n_shards}")
    if int(x.shape[0]) % n_shards != 0:
        raise ValueError(f"token count T={int(x.shape[0])} not divisible by "
                         f"mesh axis {axis}={n_shards}")
    shard = mesh.coords()[axis]
    tokens_local = int(x.shape[0]) // n_shards
    local_experts = n_experts // n_shards
    capacity = int(np.ceil(capacity_factor * tokens_local / n_experts))

    x_local = x[shard * tokens_local:(shard + 1) * tokens_local]
    p_local = _map(lambda w: w[shard * local_experts:
                               (shard + 1) * local_experts], expert_params)
    expert, position, keep, gate, aux = _route(x_local @ router_w, capacity)
    rows = n_experts * capacity
    # each kept token's row of the [E, C, d] buffers; dropped ones go to
    # one spare row past them, which is cut off
    slot = torch.where(keep, expert * capacity + position.long(), rows)
    d = x_local.shape[-1]
    buf = x_local.new_zeros((rows + 1, d)).index_copy(0, slot, x_local)
    buf = buf[:rows].reshape(n_experts, capacity, d)
    buf = collectives.all_to_all(buf, 0, 1, group)        # [E/S, S*C, d]
    out = expert_fn(p_local, buf)                          # [E/S, S*C, d]
    out = collectives.all_to_all(out, 1, 0, group)        # [E, C, d]
    out = torch.cat([out.reshape(rows, d), out.new_zeros((1, d))])
    y = out.index_select(0, slot) * gate[:, None]          # [T/S, d]
    return y, _AxisMean.apply(aux, group)


def _map(fn: Callable, tree: Any) -> Any:
    return ({k: _map(fn, v) for k, v in tree.items()}
            if isinstance(tree, dict) else fn(tree))


def mlp_expert(params: Dict[str, torch.Tensor],
               tokens: torch.Tensor) -> torch.Tensor:
    """Default expert: 2-layer GELU MLP ``{w1: [d, h], w2: [h, d]}`` (the
    tanh GELU, ``jax.nn.gelu``'s default); with a leading expert dim on
    the weights and the tokens, each expert on its own tokens."""
    from ..models.transformer import _gelu

    return torch.matmul(_gelu(torch.matmul(tokens, params["w1"])),
                        params["w2"])


def moe_params_from_jax(router_w, expert_params: Dict[str, Any],
                        device: Any = None, dtype: Any = None):
    """The JAX router ``[d, E]`` and stacked expert params (numpy arrays)
    as tensors on ``device`` (default: the session's device) in
    ``dtype`` (default float32): ``(router_w, {"w1", "w2"})``."""
    from ..models.transformer import _session_device

    device = _session_device(device)
    dtype = torch.float32 if dtype is None else dtype

    def conv(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            device=device, dtype=dtype)

    return conv(router_w), _map(conv, dict(expert_params))


def init_moe_params(rng: np.random.Generator, n_experts: int, d_model: int,
                    d_hidden: int, dtype: Any = torch.float32,
                    device: Any = None):
    """Random router and stacked expert MLP params, drawn from the numpy
    ``rng`` in the JAX function's order (the same numbers in f32)."""
    scale_in = 1.0 / np.sqrt(d_model)
    scale_hid = 1.0 / np.sqrt(d_hidden)
    router_w = rng.standard_normal((d_model, n_experts)) * scale_in
    w1 = rng.standard_normal((n_experts, d_model, d_hidden)) * scale_in
    w2 = rng.standard_normal((n_experts, d_hidden, d_model)) * scale_hid
    return moe_params_from_jax(router_w, {"w1": w1, "w2": w2},
                               device=device, dtype=dtype)
