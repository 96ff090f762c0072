"""GPipe and 1F1B pipeline parallelism over a ``stage`` mesh axis.

Counterpart of ``multiverso_tpu/parallel/pipeline.py``. The JAX package
runs the schedule as a ``lax.scan`` inside ``shard_map``: stage ``s`` is
device ``s`` of the ``stage`` axis, and activations ``ppermute`` one
stage down the ring each tick. Here stage ``s`` is the process at
coordinate ``s`` of a port :class:`~..topology.Mesh`, the tick loop is a
Python loop, and each tick's ring move is one paired send and receive
(``collectives._permute``: gloo, staged through the host for CUDA
tensors), made by every rank of the axis at every tick, in the same
order, so the exchanges stay paired whatever a rank computes.

Parameters are stacked on a leading ``n_stages`` dim
(:func:`stack_stage_params`); every rank passes the whole stack and each
takes its own stage's slice. Gradients are per-rank shares: a rank's
gradient of the stack is nonzero only in its own stage's row, and the
sum over the axis is the JAX function's gradient.

* :func:`pipeline_apply` — the GPipe forward (tick ``t``: stage ``s``
  runs microbatch ``t - s``), its outputs replicated from the last stage
  (JAX's masked ``psum``). Differentiable, with an explicit backward
  schedule (``_GPipe``): JAX derives the backward as the reverse ring by
  transposing ``ppermute``, whereas autograd runs only the exchanges
  whose outputs reach a rank's loss, so a rank would wait on a peer that
  never sends. The backward instead walks the ticks in reverse on every
  rank, each stage's input cotangent going one stage up the ring per
  tick. The replicated output is one value: only the last stage seeds
  the backward with its cotangent (once, not once a rank), and stage 0
  alone receives the input's gradient.
* :func:`pipeline_value_and_grad` — 1F1B with remat: each tick one
  forward slot and one backward slot a stage, activations down the ring
  and cotangents up it, the stage's inputs stashed in ``2 * n_stages``
  slots and the stage forward recomputed in the backward slot; returns
  the mean loss (replicated) and this rank's stage gradient.

Both skip the compute of an empty slot (the ramp ticks, where JAX
computes on garbage and masks the result) and send zeros in its place:
a stage runs ``stage_fn`` once a microbatch in the forward (GPipe) or
twice, plus one backward (1F1B). :data:`STATS` counts the slots run
(``slots``) and those that held a microbatch (``filled``): the bubble
share is ``1 - filled / slots``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..topology import Mesh, _world, make_mesh
from . import collectives

STAGE_AXIS = "stage"

STATS: Dict[str, int] = {"slots": 0, "filled": 0}


def reset_stats() -> None:
    STATS.update(slots=0, filled=0)


def make_pipeline_mesh(n_stages: Optional[int] = None,
                       ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A 1-D mesh whose one axis is ``stage``, over the first
    ``n_stages`` of ``ranks`` (default: every rank of the group). Every
    rank of the group calls it: the sub-groups are created collectively."""
    if ranks is None:
        ranks = range(_world()[1])
    ranks = [int(r) for r in ranks]
    if n_stages is None:
        n_stages = len(ranks)
    return make_mesh((n_stages,), axis_names=(STAGE_AXIS,),
                     ranks=ranks[:n_stages])


def _stack(trees: Sequence[Any], stack: Callable) -> Any:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees], stack) for k in first}
    return stack(trees)


def stack_stage_params(per_stage_params: Sequence[Any]) -> Any:
    """Stack a list of per-stage parameter dicts on a leading stage dim."""
    return _stack(per_stage_params, torch.stack)


def stage_params_from_jax(per_stage_params: Sequence[Any], device: Any = None,
                          dtype: Any = None) -> Any:
    """The JAX per-stage parameter pytrees (dicts of numpy arrays, one a
    stage) as one stacked dict of tensors on ``device`` (default: the
    session's device) in ``dtype`` (default float32)."""
    from ..models.transformer import _session_device

    device = _session_device(device)
    dtype = torch.float32 if dtype is None else dtype
    return _stack(per_stage_params, lambda leaves: torch.from_numpy(
        np.stack([np.asarray(a, np.float32) for a in leaves])).to(
            device=device, dtype=dtype))


def microbatch(batch: torch.Tensor, n_micro: int) -> torch.Tensor:
    """Split ``[B, ...]`` into ``[n_micro, B // n_micro, ...]``."""
    if batch.shape[0] % n_micro != 0:
        raise ValueError(
            f"batch dim {batch.shape[0]} not divisible by n_micro={n_micro}")
    return batch.reshape((n_micro, batch.shape[0] // n_micro)
                         + tuple(batch.shape[1:]))


def _flat(tree: Any) -> Tuple[List[Any], Callable[[Sequence[Any]], Any]]:
    """The leaves of a dict of tensors in order, and the function that
    puts a list of leaves back in that layout."""
    leaves: List[Any] = []

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        leaves.append(t)
        return len(leaves) - 1

    skeleton = walk(tree)

    def rebuild(new: Sequence[Any]) -> Any:
        def fill(s):
            return ({k: fill(v) for k, v in s.items()}
                    if isinstance(s, dict) else new[s])
        return fill(skeleton)

    return leaves, rebuild


def _stage_of(params: Any, mesh: Mesh, axis: str):
    """``(n_stages, stage, group, leaves, rebuild)`` after JAX's check
    that every leaf stacks exactly one param set per stage."""
    group = mesh.group(axis)            # ValueError: no such axis, not in it
    n_stages = int(mesh.shape[axis])
    leaves, rebuild = _flat(params)
    for leaf in leaves:
        if leaf.dim() == 0 or leaf.shape[0] != n_stages:
            raise ValueError(
                f"params leaf has leading dim "
                f"{leaf.shape[0] if leaf.dim() else 'none (scalar)'} "
                f"!= mesh axis {axis}={n_stages}; stack exactly one param "
                f"set per stage")
    return n_stages, mesh.coords()[axis], group, leaves, rebuild


def _ring(x: torch.Tensor, stage: int, n_stages: int, group,
          shift: int) -> torch.Tensor:
    """Send ``x`` to stage ``stage + shift`` and return what stage
    ``stage - shift`` sent (mod ``n_stages``)."""
    return collectives._permute([x], (stage + shift) % n_stages,
                                (stage - shift) % n_stages, group)[0]


def _pass_cotangent(dx: torch.Tensor, stage: int, n_stages: int,
                    group) -> torch.Tensor:
    """1F1B's backward ring move: each stage's input cotangent to the
    stage before it, received from the stage after it."""
    return _ring(dx, stage, n_stages, group, -1)


def _loss_and_seed(loss_fn: Callable, y: torch.Tensor, aux: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The last stage's loss of its output ``y`` and the loss's gradient
    with respect to ``y``: the one seed of the microbatch's backward."""
    loss = loss_fn(y, aux)
    (seed,) = torch.autograd.grad(loss, y, retain_graph=True)
    return loss, seed.to(y.dtype)


class _GPipe(torch.autograd.Function):
    """The GPipe forward over the ticks, and its backward as the reverse
    ring (module docstring). ``local``: this stage's parameter leaves."""

    @staticmethod
    def forward(ctx, stage_fn, rebuild, stage, n_stages, group, track,
                xs: torch.Tensor, *local: torch.Tensor):
        # track: keep each tick's graph for the backward (grad mode on,
        # and an input that requires grad)
        S, s, n_micro = n_stages, stage, xs.shape[0]
        p = [w.detach().requires_grad_(track) for w in local]
        params = rebuild(p)
        state = torch.zeros_like(xs[0])
        outputs = torch.zeros_like(xs)
        graphs = {}
        for t in range(n_micro + S - 1):
            m = t - s
            out = torch.zeros_like(xs[0])
            if 0 <= m < n_micro:
                STATS["filled"] += 1
                inp = (xs[m] if s == 0 else state).detach()
                with torch.set_grad_enabled(track):
                    inp.requires_grad_(track)
                    out = stage_fn(params, inp).to(xs.dtype)
                if track:
                    graphs[m] = (inp, out)
                if s == S - 1:
                    outputs[m] = out.detach()
            STATS["slots"] += 1
            state = _ring(out.detach(), s, S, group, 1)
        ctx.route, ctx.p, ctx.graphs = (s, S, group), p, graphs
        ctx.n_micro, ctx.micro_like = n_micro, torch.zeros_like(xs[0])
        # the last stage's outputs, replicated: JAX's masked psum, exact
        # (the other stages' outputs are zeros)
        return collectives.allreduce(outputs, group)

    @staticmethod
    def backward(ctx, g_out):
        (s, S, group), p, graphs = ctx.route, ctx.p, ctx.graphs
        n_micro = ctx.n_micro
        want_xs = ctx.needs_input_grad[6]
        dp = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
              for w in p]
        dxs = torch.zeros_like(g_out) if want_xs and s == 0 else None
        cot_in = ctx.micro_like
        for t in reversed(range(n_micro + S - 1)):
            m = t - s
            dx = ctx.micro_like
            if 0 <= m < n_micro:
                STATS["filled"] += 1
                inp, out = graphs.pop(m)
                # the replicated output's cotangent seeds the last stage
                # alone; the others take what the next stage sent up
                cot = g_out[m] if s == S - 1 else cot_in
                need_x = s > 0 or dxs is not None
                grads = torch.autograd.grad(
                    out, p + ([inp] if need_x else []), cot.to(out.dtype),
                    allow_unused=True)
                for acc, g in zip(dp, grads[:len(p)]):
                    if g is not None:
                        acc += g.float()
                if need_x:
                    dx = grads[-1]
                    if dxs is not None:
                        dxs[m] = dx
            STATS["slots"] += 1
            cot_in = _ring(dx.detach().to(g_out.dtype), s, S, group, -1)
        ctx.graphs = None
        return (None,) * 6 + (dxs,) + tuple(
            g.to(w.dtype) if need else None
            for g, w, need in zip(dp, p, ctx.needs_input_grad[7:]))


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   params: Any, xs: torch.Tensor, mesh: Mesh,
                   axis: str = STAGE_AXIS) -> torch.Tensor:
    """Apply ``f_{S-1}(...f_1(f_0(x)))`` pipelined over mesh axis ``axis``
    (GPipe; module docstring).

    Args:
      stage_fn: ``(stage_params, activation) -> activation``; the
        activation's shape and dtype are the same at every stage.
      params: dict of tensors, each with leading dim ``n_stages`` (every
        rank passes the whole stack; this rank runs its stage's slice).
      xs: ``[n_micro, micro_batch, ...]`` microbatched input, the same on
        every rank.
      mesh: mesh containing ``axis``; every rank of the axis calls
        together, and runs the backward of the output together.

    Returns ``[n_micro, micro_batch, ...]`` outputs on every rank of the
    axis. Differentiable in ``params`` and ``xs``: this rank's gradient
    of the stack holds its stage's row, stage 0 alone gets ``xs``'s.
    """
    n_stages, stage, group, leaves, rebuild = _stage_of(params, mesh, axis)
    local = [leaf[stage] for leaf in leaves]
    track = torch.is_grad_enabled() and any(
        t.requires_grad for t in [xs] + local)
    return _GPipe.apply(stage_fn, rebuild, stage, n_stages, group, track,
                        xs, *local)


def pipeline_value_and_grad(
        stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
        loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
        params: Any, xs: torch.Tensor, aux: torch.Tensor, mesh: Mesh,
        axis: str = STAGE_AXIS) -> Tuple[torch.Tensor, Any]:
    """1F1B pipelined training step: ``(mean loss, stage grads)``.

    Schedule (stage ``s``, tick ``t``, ``n_micro + 2 * n_stages - 1``
    ticks): the forward slot runs microbatch ``t - s`` and stashes its
    input in slot ``m mod 2 * n_stages``; the backward slot runs
    microbatch ``t - (2 * n_stages - 1 - s)``: it recomputes the stage
    forward from the stashed input under autograd, and its seed is the
    loss's gradient on the last stage (:func:`_loss_and_seed`, on
    ``loss_fn(output, aux[m])``) and the cotangent sent up from the next
    stage elsewhere. Each tick ends with two ring moves on every rank:
    the forward output (cast to ``xs``'s dtype) one stage down, the input
    cotangent one stage up (:func:`_pass_cotangent`). Empty slots skip
    the compute and send zeros.

    Args as :func:`pipeline_apply`, with ``loss_fn: (last stage output,
    aux[m]) -> scalar`` and ``aux``: ``[n_micro, ...]``, the same on
    every rank.

    Returns ``(loss, grads)``: the mean of the microbatches' losses, an
    f32 scalar on every rank, and this rank's stage gradient averaged
    over the microbatches, f32, in ``params``' layout with a leading dim
    of 1 (the shard of JAX's stage-sharded gradient that this rank's
    device holds).
    """
    n_stages, stage, group, leaves, rebuild = _stage_of(params, mesh, axis)
    S, n_micro = n_stages, int(xs.shape[0])
    slots = 2 * S
    last = stage == S - 1
    p = [leaf[stage].detach().requires_grad_() for leaf in leaves]
    p_tree = rebuild(p)
    zeros = torch.zeros_like(xs[0])
    fwd_in, cot_in = zeros, zeros
    stash: List[Optional[torch.Tensor]] = [None] * slots
    dp = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
          for w in p]
    loss_acc = torch.zeros((), dtype=torch.float32, device=xs.device)
    for t in range(n_micro + 2 * S - 1):
        # forward slot: microbatch m_f = t - stage
        y = zeros
        m_f = t - stage
        if 0 <= m_f < n_micro:
            STATS["filled"] += 1
            x_in = xs[m_f] if stage == 0 else fwd_in
            with torch.no_grad():
                y = stage_fn(p_tree, x_in).to(xs.dtype)
            stash[m_f % slots] = x_in
        # backward slot: microbatch m_b = t - (2S - 1 - stage)
        dx = zeros
        m_b = t - (2 * S - 1 - stage)
        if 0 <= m_b < n_micro:
            STATS["filled"] += 1
            x_saved = stash[m_b % slots].detach().requires_grad_(stage > 0)
            stash[m_b % slots] = None
            with torch.enable_grad():
                y_b = stage_fn(p_tree, x_saved)
                if last:
                    loss_b, seed = _loss_and_seed(loss_fn, y_b, aux[m_b])
                    loss_acc += loss_b.detach().float()
                else:
                    seed = cot_in.to(y_b.dtype)
            grads = torch.autograd.grad(
                y_b, p + ([x_saved] if stage > 0 else []), seed,
                allow_unused=True)
            for acc, g in zip(dp, grads[:len(p)]):
                if g is not None:
                    acc += g.float()
            if stage > 0:
                dx = grads[-1].to(xs.dtype)
        STATS["slots"] += 2
        fwd_in = _ring(y, stage, S, group, 1)
        cot_in = _pass_cotangent(dx, stage, S, group)
    # the loss lives on the last stage; a masked sum replicates it
    loss = collectives.allreduce(loss_acc if last else
                                 torch.zeros_like(loss_acc), group) / n_micro
    return loss, rebuild([(g / n_micro)[None] for g in dp])
