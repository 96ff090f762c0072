"""Transformer language model: the flagship LM's training and serving math.

Counterpart of ``multiverso_tpu/models/transformer.py`` for the serving
and training slices: the config, the random parameters (drawn from the
same numpy stream, so one seed gives the same weights in both packages),
the training ``forward`` and ``loss_fn``, the causal prefill, the
one-token decode step over a slotted KV cache, the cache insert, the
chunked prefill and the paged KV programs (decode step, chunk, insert,
monolithic admission, copy-on-write), the greedy decode oracle, and
:class:`TransformerLM` (one-device momentum-SGD trainer and serving
surface). The JAX trainer's mesh (dp batches, tp
weights) belongs to the distributed paths.

Pre-LN, learned positions, tied input/output embeddings. Parameters are a
plain dict of tensors with per-layer weights stacked on dim 0, the JAX
pytree's layout. Where the JAX functions return updated caches, these
update the cache tensors in place and return them. The serving functions
run under ``torch.no_grad()``: parameters that require grad (a trainer's)
build no autograd graph there.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..log import Log

_NEG_INF = -1e30
_LAYER_KEYS = ("ln1_g", "ln2_g", "w_q", "w_k", "w_v", "w_o", "w_ff1",
               "w_ff2")


@dataclass
class TransformerConfig:
    """The JAX config's fields, in its order."""

    vocab_size: int
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    max_seq: int = 256
    dtype: Any = torch.float32
    learning_rate: float = 0.1
    momentum: float = 0.9
    seed: int = 0
    # a JAX compile knob (scan over the layer stack); PyTorch runs the
    # layers eagerly, so either value computes the same thing here
    scan_layers: bool = False
    # attention implementation: "reference" (plain PyTorch), "flash"
    # (crossover dispatch, ops.flash_attention.best_attention) or
    # "flash_force" (always the flash kernel on the card; its plain
    # version on the CPU)
    attention: str = "reference"


def _session_device(device: Any) -> Any:
    """``device``, or the started session's device when it is None (the
    card unless the session was started with ``-device=cpu``)."""
    if device is not None:
        return device
    from ..runtime import Session

    sess = Session.get()
    if not sess.started:
        Log.fatal("no device given and no multiverso_tpu_torch session "
                  "started: call init() first, or pass device= (\"cpu\" "
                  "to run on the CPU)")
    return sess.device


def init_params(cfg: TransformerConfig,
                rng: Optional[np.random.Generator] = None,
                device: Any = None) -> Dict[str, Any]:
    """Random parameters on ``device`` (default: the session's device);
    per-layer weights stacked on dim 0. Draws from
    ``np.random.default_rng(cfg.seed)`` in the JAX package's order."""
    device = _session_device(device)
    rng = rng or np.random.default_rng(cfg.seed)
    D, F_, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    s = 1.0 / np.sqrt(D)
    sf = 1.0 / np.sqrt(F_)

    def mk(shape, scale):
        return rng.standard_normal(shape) * scale

    host = {
        "embed": mk((cfg.vocab_size, D), s),
        "pos": mk((cfg.max_seq, D), 0.02),
        "layers": {
            "ln1_g": np.ones((L, D)),
            "ln2_g": np.ones((L, D)),
            "w_q": mk((L, D, D), s),
            "w_k": mk((L, D, D), s),
            "w_v": mk((L, D, D), s),
            "w_o": mk((L, D, D), s),
            "w_ff1": mk((L, D, F_), s),
            "w_ff2": mk((L, F_, D), sf),
        },
        "ln_f_g": np.ones((D,)),
    }
    return params_from_jax(host, device=device, dtype=cfg.dtype)


def params_from_jax(params: Dict[str, Any], device: Any = None,
                    dtype: Any = torch.float32) -> Dict[str, Any]:
    """The JAX parameter pytree (as numpy arrays: ``embed``, ``pos``,
    ``ln_f_g`` and ``layers`` with stacked ``ln1_g``, ``ln2_g``, ``w_q``,
    ``w_k``, ``w_v``, ``w_o``, ``w_ff1``, ``w_ff2``) as the port's
    parameters on ``device`` (default: the session's device) in
    ``dtype``."""
    device = _session_device(device)

    def conv(a):
        return torch.from_numpy(np.array(a, np.float32)).to(
            device=device, dtype=dtype)

    return {"embed": conv(params["embed"]), "pos": conv(params["pos"]),
            "layers": {k: conv(params["layers"][k]) for k in _LAYER_KEYS},
            "ln_f_g": conv(params["ln_f_g"])}


def _map(fn: Callable, tree: Dict[str, Any]) -> Dict[str, Any]:
    """``fn`` over every tensor of a parameter dict, keeping its layout."""
    return {k: ({n: fn(w) for n, w in v.items()} if isinstance(v, dict)
                else fn(v)) for k, v in tree.items()}


def _leaves(tree: Dict[str, Any]) -> List[torch.Tensor]:
    return [w for v in tree.values()
            for w in (v.values() if isinstance(v, dict) else (v,))]


def _layers(params: Dict[str, Any]) -> List[Dict[str, torch.Tensor]]:
    """Per-layer views of the stacked weights. ``unbind`` is one autograd
    node per weight, whose backward stacks the layers' gradients."""
    per = {k: w.unbind(0) for k, w in params["layers"].items()}
    n = len(next(iter(per.values())))
    return [{k: ws[i] for k, ws in per.items()} for i in range(n)]


def _rmsnorm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    # mean in f32, rsqrt cast back to x's dtype before the gain
    r = torch.rsqrt(torch.mean(torch.square(x.float()), -1, keepdim=True)
                    + 1e-6).to(x.dtype)
    return x * r * g


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _logits(h: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Tied-embedding logits in f32 from f32 copies of the operands (the
    JAX einsum's ``preferred_element_type=f32``)."""
    return torch.matmul(h.float(), embed.float().t())


def _attention(q, k, v, n_heads: int, impl: str = "reference"):
    """Causal multi-head attention, ``[B, T, D]`` in/out. The attention
    functions take the batch as a leading dim (JAX vmaps them)."""
    B, T, D = q.shape
    dh = D // n_heads
    split = lambda x: x.reshape(B, T, n_heads, dh)
    if impl == "flash":
        from ..ops.flash_attention import best_attention as fn

        if B * n_heads >= 64:
            # the JAX package's in-model crossover for many-program
            # calls (measured on a TPU; not yet measured on the card)
            from functools import partial

            fn = partial(fn, min_flash_seq=512)
    elif impl == "flash_force":
        from ..ops.flash_attention import flash_attention as fn
    elif impl == "reference":
        from ..ops.ring_attention import reference_attention as fn
    else:
        Log.fatal(f"unknown attention impl {impl!r} "
                  "(expected 'reference', 'flash' or 'flash_force')")
    out = fn(split(q), split(k), split(v), causal=True)
    return out.reshape(B, T, D)


def _block(cfg: TransformerConfig, layer: Dict[str, torch.Tensor],
           h: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pre-LN layer over ``h`` [B, T, D]; returns ``(h, k, v)``."""
    x = _rmsnorm(h, layer["ln1_g"])
    q, k, v = x @ layer["w_q"], x @ layer["w_k"], x @ layer["w_v"]
    h = h + _attention(q, k, v, cfg.n_heads, cfg.attention) @ layer["w_o"]
    x = _rmsnorm(h, layer["ln2_g"])
    h = h + _gelu(x @ layer["w_ff1"]) @ layer["w_ff2"]
    return h, k, v


def forward(cfg: TransformerConfig, params: Dict[str, Any],
            tokens: torch.Tensor) -> torch.Tensor:
    """Logits [B, T, V] f32 for token ids [B, T] (causal LM)."""
    h = params["embed"][tokens] + params["pos"][:tokens.shape[1]]
    for layer in _layers(params):
        h, _, _ = _block(cfg, layer, h)
    return _logits(_rmsnorm(h, params["ln_f_g"]), params["embed"])


def loss_fn(cfg: TransformerConfig, params: Dict[str, Any],
            tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over [B, T] token ids, with the JAX
    function's two branches: up to ``max_seq`` tokens the forward runs at
    full length and the logits are sliced; longer windows (the LM app's
    ``seq + 1``) run the forward on ``tokens[:, :-1]``."""
    if tokens.shape[1] <= cfg.max_seq:
        logits = forward(cfg, params, tokens)[:, :-1]
    else:
        logits = forward(cfg, params, tokens[:, :-1])
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None]).mean()


def _verify_attention(q, k_cache, v_cache, n_heads: int,
                      pos: torch.Tensor) -> torch.Tensor:
    """Window attention: ``q`` [S, K1, D] against each slot's cache [S, T,
    D]. Window position ``j`` sits at cache position ``pos[s] + j`` and
    attends positions ``<= pos[s] + j`` (causal within the window); f32
    scores and softmax. Every serving program's attention."""
    S, K1, D = q.shape
    T = k_cache.shape[1]
    dh = D // n_heads
    qh = q.reshape(S, K1, n_heads, dh)
    kh = k_cache.reshape(S, T, n_heads, dh)
    vh = v_cache.reshape(S, T, n_heads, dh)
    scores = torch.einsum("skhd,sthd->shkt", qh.float(),
                          kh.float()) / math.sqrt(dh)
    rows = pos[:, None] + torch.arange(K1, device=q.device)[None, :]
    mask = (torch.arange(T, device=q.device)[None, None, :]
            <= rows[:, :, None])[:, None, :, :]
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("shkt,sthd->skhd", probs.to(vh.dtype), vh)
    return out.reshape(S, K1, D).to(q.dtype)


def _serve_layers(cfg: TransformerConfig, params: Dict[str, Any],
                  h: torch.Tensor, pos: torch.Tensor,
                  kv: Callable) -> torch.Tensor:
    """The layer loop of every serving program over windows ``h`` [S, K1,
    D]: row ``j`` of lane ``s`` sits at cache position ``pos[s] + j``.
    ``kv(i, k, v)`` writes layer ``i``'s new K/V [S, K1, D] into the
    program's cache (contiguous, paged or int8) and returns the lanes'
    ``[S, T, D]`` views of it, which each row attends up to its own
    position."""
    for i, layer in enumerate(_layers(params)):
        x = _rmsnorm(h, layer["ln1_g"])
        q, k, v = x @ layer["w_q"], x @ layer["w_k"], x @ layer["w_v"]
        kc, vc = kv(i, k, v)
        h = h + _verify_attention(q, kc, vc, cfg.n_heads, pos) @ layer["w_o"]
        x = _rmsnorm(h, layer["ln2_g"])
        h = h + _gelu(x @ layer["w_ff1"]) @ layer["w_ff2"]
    return h


def _window_out(params: Dict[str, Any], h: torch.Tensor,
                valid: torch.Tensor, dtype) -> torch.Tensor:
    """Greedy token after every window position; 0 where not valid."""
    h = _rmsnorm(h, params["ln_f_g"])
    # torch.argmax returns the first maximal index, as jnp.argmax does
    nxt = torch.argmax(_logits(h, params["embed"]), dim=-1).to(dtype)
    return torch.where(valid, nxt, torch.zeros_like(nxt))


def _step_out(params: Dict[str, Any], h: torch.Tensor, tok: torch.Tensor,
              pos: torch.Tensor, active: torch.Tensor):
    """A token step's ``(next_tok, pos)`` from its windows of one ``h``
    [S, 1, D]: dead lanes emit 0 and keep their ``pos``."""
    nxt = _window_out(params, h, active[:, None], tok.dtype)[:, 0]
    return nxt, torch.where(active, pos + 1, pos)


@torch.no_grad()
def prefill(cfg: TransformerConfig, params: Dict[str, Any],
            tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal forward over right-padded prompts ``tokens`` [B, P],
    recording per-layer K/V. Returns ``(logits [B, P, V] f32,
    k [L, B, P, D], v [L, B, P, D])``; positions past a prompt's length
    hold garbage that decode overwrites before any mask reaches it."""
    h = params["embed"][tokens] + params["pos"][:tokens.shape[1]]
    ks, vs = [], []
    for layer in _layers(params):
        h, k, v = _block(cfg, layer, h)
        ks.append(k)
        vs.append(v)
    h = _rmsnorm(h, params["ln_f_g"])
    return _logits(h, params["embed"]), torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def decode_step(cfg: TransformerConfig, params: Dict[str, Any],
                k_cache: torch.Tensor, v_cache: torch.Tensor,
                tok: torch.Tensor, pos: torch.Tensor, active: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """One fused token step over S slots (caches ``[L, S, T, D]``,
    ``tok``/``pos`` [S], ``active`` [S] bool), updating the caches in
    place. Dead slots emit 0, keep their ``pos``, and park their K/V
    writes at ``T - 1``. Returns ``(k_cache, v_cache, next_tok, pos)``."""
    S = tok.shape[0]
    T = k_cache.shape[2]
    slot_ix = torch.arange(S, device=tok.device)
    write_pos = torch.where(active, pos, torch.full_like(pos, T - 1))

    def kv(i, k, v):
        k_cache[i, slot_ix, write_pos] = k[:, 0]
        v_cache[i, slot_ix, write_pos] = v[:, 0]
        return k_cache[i], v_cache[i]

    h = params["embed"][tok] + params["pos"][pos]
    h = _serve_layers(cfg, params, h[:, None], pos, kv)
    return (k_cache, v_cache) + _step_out(params, h, tok, pos, active)


def cache_insert(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 slots, ks: torch.Tensor, vs: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write b prefilled sequences' K/V ``[L, b, P, D]`` into ``slots``
    [b] (a sequence, or a tensor read on its device without a host
    sync), in place. Rows are written last-to-first so that row 0 wins
    when pad rows of a partial batch point at ``slots[0]``."""
    P = ks.shape[2]
    slots = torch.as_tensor(slots, device=k_cache.device)
    for i in reversed(range(ks.shape[1])):
        k_cache[:, :, :P].index_copy_(1, slots[i:i + 1], ks[:, i:i + 1])
        v_cache[:, :, :P].index_copy_(1, slots[i:i + 1], vs[:, i:i + 1])
    return k_cache, v_cache


def first_tokens(logits: torch.Tensor, lengths: torch.Tensor,
                 dtype=torch.int64) -> torch.Tensor:
    """Greedy token at each prompt's last real position."""
    rows = torch.arange(logits.shape[0], device=logits.device)
    return torch.argmax(logits[rows, lengths - 1], dim=-1).to(dtype)


# -- serving: chunked prefill and the paged KV cache ------------------------
#
# The chunked, paged and copy-on-write programs of the JAX engine. Every
# argument that places data (slot, offset, length, block tables, block ids,
# positions) is a tensor of fixed shape, never a Python int, so one engine
# config calls each program with one signature; 0-d tensors are indexed
# through ``view(1)``, never converted to a Python int (that would read
# the device). The JAX functions lean on two contracts PyTorch does not
# have: ``.at[].set`` drops writes past the end and ``jnp.take`` clamps
# reads. Here reads are clamped and writes are redirected explicitly:
#
# * a contiguous chunk's pad lanes past the cache end (JAX drops them)
#   write again, at ``T - 1``, the value of the lane at ``T - 1``: the
#   duplicate writes carry one value, so the cache ends as JAX leaves it;
# * paged pad lanes and dead decode lanes write into the scratch block 0,
#   and dead lanes of the contiguous decode step at ``T - 1``, as in JAX.
#   No live mask reaches the scratch block, and decode overwrites ``T -
#   1`` before its mask reaches it.
#
# Duplicate indices with different values land only in the scratch block
# and at dead lanes' ``T - 1``; which write wins there is undefined and
# never read.
#
# A gathered per-slot view has the contiguous cache's shape and layout
# ([T, D] per slot, T = the engine's logical cache length), built with one
# flat row index per position, so the paged attention operand is the
# contiguous one and paged decode equals contiguous decode bit for bit.


def _chunk_attention(q, k_cache, v_cache, n_heads: int,
                     offset: torch.Tensor) -> torch.Tensor:
    """Chunk attention: ``q`` [C, D] against one slot's cache [T, D].
    Chunk position ``i`` (cache position ``offset + i``, ``offset`` a 0-d
    tensor) attends cache positions ``<= offset + i``: one window of
    :func:`_verify_attention`."""
    return _verify_attention(q[None], k_cache[None], v_cache[None],
                             n_heads, offset.reshape(1))[0]


def _chunk_embed(params: Dict[str, Any], tokens: torch.Tensor,
                 pos_ix: torch.Tensor) -> torch.Tensor:
    # pad lanes may sit past max_seq: clamp the position read (their
    # hidden states are garbage that never reaches a real row)
    pos_ix = pos_ix.clamp(max=params["pos"].shape[0] - 1)
    return params["embed"][tokens] + params["pos"][pos_ix]


def _last_logits(params: Dict[str, Any], h: torch.Tensor,
                 length: torch.Tensor) -> torch.Tensor:
    """f32 logits [V] of chunk row ``length - 1`` after the final norm."""
    last = h.index_select(0, (length - 1).reshape(1))
    return _logits(_rmsnorm(last, params["ln_f_g"]), params["embed"])[0]


@torch.no_grad()
def prefill_chunk(cfg: TransformerConfig, params: Dict[str, Any],
                  k_cache: torch.Tensor, v_cache: torch.Tensor,
                  slot: torch.Tensor, tokens: torch.Tensor,
                  offset: torch.Tensor, length: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fixed-size chunk of one slot's prompt into the contiguous
    caches ``[L, S, T, D]``, in place. ``tokens`` [C] right-padded ids,
    ``slot``/``offset``/``length`` 0-d tensors (``1 <= length <= C``):
    chunk position ``i`` is cache position ``offset + i``. Each layer
    writes the chunk's K/V before its attention, so row ``i`` sees the
    prefix inserted by earlier chunks and the chunk's rows ``<= i``. Pad
    lanes past the cache end are dropped, as in JAX (see above). Returns
    ``(k_cache, v_cache, logits [V] f32 of position offset + length -
    1)``: on a prompt's final chunk, its first generated token."""
    C = tokens.shape[0]
    T = k_cache.shape[2]
    dev = tokens.device
    lane = torch.arange(C, device=dev)
    pos_ix = offset + lane
    # lanes past the end rewrite the value of the lane at T - 1
    src = torch.where(pos_ix < T, lane, T - 1 - offset)
    write_pos = pos_ix.clamp(max=T - 1)
    slot_ix = slot.reshape(1).expand(C)

    def kv(i, k, v):
        k_cache[i, slot_ix, write_pos] = k[0, src]
        v_cache[i, slot_ix, write_pos] = v[0, src]
        return (k_cache[i].index_select(0, slot.reshape(1)),
                v_cache[i].index_select(0, slot.reshape(1)))

    h = _serve_layers(cfg, params, _chunk_embed(params, tokens, pos_ix)[None],
                      offset.reshape(1), kv)
    return k_cache, v_cache, _last_logits(params, h[0], length)


def _flat_rows(table: torch.Tensor, block_size: int, t: int) -> torch.Tensor:
    """Flat pool-row index of logical positions ``0 .. t-1`` through
    block-table rows ``table`` [..., M] (a pool layer viewed as
    ``[N * Bs, D]``)."""
    p = torch.arange(t, device=table.device)
    return table[..., p // block_size] * block_size + p % block_size


def _paged_kv(k_pool: torch.Tensor, v_pool: torch.Tensor,
              blk: torch.Tensor, off: torch.Tensor,
              rows: torch.Tensor) -> Callable:
    """The fp pools' ``kv`` for :func:`_serve_layers`: new rows [S, K1, D]
    land at ``(blk, off)`` [S, K1], views gather flat pool rows ``rows``
    [S, T]."""
    D = k_pool.shape[3]

    def kv(i, k, v):
        k_pool[i, blk, off] = k
        v_pool[i, blk, off] = v
        return k_pool[i].view(-1, D)[rows], v_pool[i].view(-1, D)[rows]

    return kv


@torch.no_grad()
def decode_step_paged(cfg: TransformerConfig, params: Dict[str, Any],
                      k_pool: torch.Tensor, v_pool: torch.Tensor,
                      block_tables: torch.Tensor, tok: torch.Tensor,
                      pos: torch.Tensor, active: torch.Tensor,
                      t_logical: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """:func:`decode_step` against the paged pools ``[L, N, Bs, D]``
    (block 0 scratch) through ``block_tables`` [S, M] (int64), in place.
    Each live slot writes its token's K/V at ``(block_tables[s, pos //
    Bs], pos % Bs)`` and attends its gathered ``[T, D]`` view (``T =
    t_logical``, default ``M * Bs``); dead lanes park their writes in the
    scratch block. Returns ``(k_pool, v_pool, next_tok, pos)``."""
    Bs = k_pool.shape[2]
    M = block_tables.shape[1]
    T = M * Bs if t_logical is None else int(t_logical)
    write_blk, write_off = _step_slots(block_tables, pos, active, Bs)
    kv = _paged_kv(k_pool, v_pool, write_blk[:, None], write_off[:, None],
                   _flat_rows(block_tables, Bs, T))
    h = params["embed"][tok] + params["pos"][pos]
    h = _serve_layers(cfg, params, h[:, None], pos, kv)
    return (k_pool, v_pool) + _step_out(params, h, tok, pos, active)


def _step_slots(block_tables: torch.Tensor, pos: torch.Tensor,
                active: torch.Tensor, block_size: int):
    """Where each lane of a token step writes: ``(blk, off)`` [S], dead
    lanes at ``(scratch block, 0)``."""
    M = block_tables.shape[1]
    blk = block_tables.gather(
        1, (pos // block_size).clamp(max=M - 1)[:, None])[:, 0]
    return (torch.where(active, blk, torch.zeros_like(blk)),
            torch.where(active, pos % block_size, torch.zeros_like(pos)))


@torch.no_grad()
def prefill_chunk_paged(cfg: TransformerConfig, params: Dict[str, Any],
                        k_pool: torch.Tensor, v_pool: torch.Tensor,
                        block_tables: torch.Tensor, slot: torch.Tensor,
                        tokens: torch.Tensor, offset: torch.Tensor,
                        length: torch.Tensor,
                        t_logical: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`prefill_chunk` against the paged pools: K/V writes go to
    ``(block_tables[slot, p // Bs], p % Bs)`` and the chunk attends the
    slot's gathered ``[T, D]`` view. Pad lanes (``i >= length``) write
    into the scratch block. Returns ``(k_pool, v_pool, logits [V])``."""
    C = tokens.shape[0]
    Bs = k_pool.shape[2]
    M = block_tables.shape[1]
    T = M * Bs if t_logical is None else int(t_logical)
    bt_row = block_tables.index_select(0, slot.reshape(1))      # [1, M]
    lane = torch.arange(C, device=tokens.device)
    pos_ix = offset + lane
    valid = lane < length
    blk = torch.where(valid, bt_row[0, (pos_ix // Bs).clamp(0, M - 1)],
                      torch.zeros_like(pos_ix))
    off = torch.where(valid, pos_ix % Bs, torch.zeros_like(pos_ix))
    kv = _paged_kv(k_pool, v_pool, blk[None], off[None],
                   _flat_rows(bt_row, Bs, T))
    h = _serve_layers(cfg, params, _chunk_embed(params, tokens, pos_ix)[None],
                      offset.reshape(1), kv)
    return k_pool, v_pool, _last_logits(params, h[0], length)


def cache_insert_paged(k_pool: torch.Tensor, v_pool: torch.Tensor,
                       block_tables: torch.Tensor, ks: torch.Tensor,
                       vs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write b prefilled sequences' K/V ``[L, b, P, D]`` through per-row
    block tables ``[b, M]``, in place: row ``r``'s position ``p`` goes to
    ``(block_tables[r, p // Bs], p % Bs)``. Pad rows point their whole
    table at the scratch block; positions past a row's reservation reach
    scratch through the table's sentinel padding."""
    L, b, P, _ = ks.shape
    Bs = k_pool.shape[2]
    M = block_tables.shape[1]
    p = torch.arange(P, device=block_tables.device)
    blk = block_tables[:, (p // Bs).clamp(0, M - 1)]            # [b, P]
    off = (p % Bs).expand(b, P)
    for i in range(L):
        k_pool[i, blk, off] = ks[i]
        v_pool[i, blk, off] = vs[i]
    return k_pool, v_pool


@torch.no_grad()
def admit_insert_paged(cfg: TransformerConfig, params: Dict[str, Any],
                       k_pool: torch.Tensor, v_pool: torch.Tensor,
                       block_tables: torch.Tensor, tokens: torch.Tensor,
                       lengths: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Monolithic admission against the paged pools: whole-prompt
    :func:`prefill`, the first token at each last real position, and
    :func:`cache_insert_paged`. Returns ``(first [b], k_pool,
    v_pool)``."""
    logits, ks, vs = prefill(cfg, params, tokens)
    first = first_tokens(logits, lengths, tokens.dtype)
    cache_insert_paged(k_pool, v_pool, block_tables, ks, vs)
    return first, k_pool, v_pool


def cow_block_copy(k_pool: torch.Tensor, v_pool: torch.Tensor,
                   src: torch.Tensor, dst: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Copy-on-write: block ``src`` of both pools into block ``dst``
    (0-d tensors), in place."""
    for pool in (k_pool, v_pool):
        pool.index_copy_(1, dst.reshape(1),
                         pool.index_select(1, src.reshape(1)))
    return k_pool, v_pool


# -- serving: speculative decoding (the fixed-K verify step) ----------------
#
# One forward scores a window of K + 1 positions per slot: position 0 is the
# token the plain step would consume, positions 1..K the host drafter's
# guesses. The host accepts the longest drafted prefix that matches the
# window's own argmax chain, plus one correction token, so the emitted
# tokens are plain greedy decode's. K + 1 is the only new shape: drafts,
# per-slot valid counts, positions and block tables are tensors of fixed
# shape, so the verify program keeps one signature per engine config.


def _window_slots(block_tables: torch.Tensor, pos: torch.Tensor,
                  active: torch.Tensor, n_valid: torch.Tensor,
                  block_size: int, k1: int):
    """Where each window position writes: ``(pos_ix, valid, blk, off)``,
    all ``[S, K1]``. Window position ``j`` of slot ``s`` is cache position
    ``pos[s] + j``; dead lanes and positions ``j >= n_valid[s]`` write to
    ``(scratch block, 0)``, so two writes share an index only there."""
    M = block_tables.shape[1]
    lane = torch.arange(k1, device=pos.device)
    pos_ix = pos[:, None] + lane[None, :]
    valid = (lane[None, :] < n_valid[:, None]) & active[:, None]
    blk = block_tables.gather(1, (pos_ix // block_size).clamp(0, M - 1))
    blk = torch.where(valid, blk, torch.zeros_like(blk))
    off = torch.where(valid, pos_ix % block_size, torch.zeros_like(pos_ix))
    return pos_ix, valid, blk, off


@torch.no_grad()
def verify_step_paged(cfg: TransformerConfig, params: Dict[str, Any],
                      k_pool: torch.Tensor, v_pool: torch.Tensor,
                      block_tables: torch.Tensor, toks: torch.Tensor,
                      pos: torch.Tensor, active: torch.Tensor,
                      n_valid: torch.Tensor,
                      t_logical: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused multi-position step over the paged pools, in place.

    ``toks`` [S, K1] is each slot's window, ``pos`` [S] the cache position
    of ``toks[:, 0]``, ``n_valid`` [S] in ``[1, K1]`` the window's real
    entries. Every valid position writes its K/V before the attention (so
    the window sees itself) and attends the slot's gathered ``[T, D]``
    view; the rest park in the scratch block. The engine clamps drafts to
    the request's remaining budget, so valid writes stay inside its
    reservation, and rejected positions need no rollback: the next window
    rewrites them before any mask reaches them. Returns ``(k_pool,
    v_pool, out_tok [S, K1])``, ``out_tok[s, j]`` the greedy token after
    ``toks[s, :j + 1]``."""
    S, K1 = toks.shape
    Bs = k_pool.shape[2]
    M = block_tables.shape[1]
    T = M * Bs if t_logical is None else int(t_logical)
    pos_ix, valid, blk, off = _window_slots(block_tables, pos, active,
                                            n_valid, Bs, K1)
    kv = _paged_kv(k_pool, v_pool, blk, off, _flat_rows(block_tables, Bs, T))
    h = _serve_layers(cfg, params, _chunk_embed(params, toks, pos_ix), pos,
                      kv)
    return k_pool, v_pool, _window_out(params, h, valid, toks.dtype)


# -- serving: the int8 paged KV cache ----------------------------------------
#
# The ``_q`` programs keep the pools as int8 with one fp32 scale per (layer,
# block): ``k_scales``/``v_scales`` [L, N] tensors of fixed shape passed
# beside the block tables, so each program keeps one signature.
#
# A write gathers the blocks it touches, dequantizes them with the old
# scale, inserts the new fp32 rows and requantizes the whole block against
# ``max(old scale, rowmax / 127)``. ``round(q * s / s) == q`` for |q| <= 127
# in fp32, so untouched rows (and whole untouched blocks swept up by a
# row-wide write: scratch padding, shared prefix blocks) get their exact old
# bytes back: duplicate writes of such blocks carry one value. A growing
# scale re-rounds a block's earlier rows once. The first write at a block's
# offset 0 drops the previous occupant's scale (``base = 0``), so a
# reallocated block does not keep its predecessor's scale. Rows divide by
# the scale (as JAX does, not multiply by a reciprocal) and round half to
# even (``torch.round``, as ``jnp.round``). Reads dequantize the gathered
# blocks before attention, so the attention operand has the fp programs'
# shape.

_KV_QMAX = 127.0


def _kv_q_safe(scale: torch.Tensor) -> torch.Tensor:
    """A never-written (scale 0) block divides by 1: zeros stay zeros."""
    return torch.where(scale > 0, scale, torch.ones_like(scale))


def _kv_q_requant(rows: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp32 ``rows`` [..., Bs, D] against per-block ``scale`` [...] ->
    int8 (symmetric, clipped)."""
    q = torch.round(rows / _kv_q_safe(scale)[..., None, None])
    return q.clamp(-_KV_QMAX, _KV_QMAX).to(torch.int8)


def _kv_q_dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 blocks [..., Bs, D] * per-block ``scale`` [...] -> fp32."""
    return q.float() * scale[..., None, None]


def _amax_into(n: int, index: torch.Tensor, values: torch.Tensor,
               dim: int = -1) -> torch.Tensor:
    """``zeros(n + 1).at[index].max(values)[:n]`` along ``dim`` (the last
    slot takes the dropped lanes): JAX's scatter-max with ``mode="drop"``
    onto zeros, for non-negative values."""
    shape = list(index.shape)
    shape[dim] = n + 1
    out = torch.zeros(shape, dtype=values.dtype, device=values.device)
    out.scatter_reduce_(dim, index, values, reduce="amax")
    return out.narrow(dim, 0, n)


def _row_write_q(pool: torch.Tensor, scales: torch.Tensor,
                 tables: torch.Tensor, flat_ix: torch.Tensor,
                 blk_local: torch.Tensor, fresh: torch.Tensor,
                 valid: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The whole-row quantized write of one layer, in place: each row of
    ``tables`` [R, M] round-trips through fp32, ``rows`` [R, C, D] land at
    flat positions ``flat_ix`` [R, C] (``M * Bs`` = dropped), the scales
    reset where ``fresh`` and grow by each written block's row max.
    Returns the dequantized rows ``[R, M * Bs, D]`` as written."""
    R, M = tables.shape
    Bs, D = pool.shape[1], pool.shape[2]
    row_s = scales[tables]                                   # [R, M]
    flat = _kv_q_dequant(pool[tables], row_s).reshape(R, M * Bs, D)
    flat = torch.cat([flat, flat.new_zeros(R, 1, D)], dim=1)
    rows32 = rows.float()
    flat[torch.arange(R, device=flat.device)[:, None], flat_ix] = rows32
    flat = flat[:, : M * Bs]
    reset = _amax_into(M, blk_local, fresh) > 0
    contrib = _amax_into(M, blk_local, torch.where(
        valid, rows32.abs().amax(-1), torch.zeros_like(fresh)))
    new_s = torch.maximum(torch.where(reset, torch.zeros_like(row_s), row_s),
                          contrib / _KV_QMAX)
    new_q = _kv_q_requant(flat.reshape(R, M, Bs, D), new_s)
    pool[tables] = new_q
    scales[tables] = new_s
    return _kv_q_dequant(new_q, new_s).reshape(R, M * Bs, D)


def _gather_q(pool: torch.Tensor, scales: torch.Tensor,
              block_tables: torch.Tensor, T: int, dtype) -> torch.Tensor:
    """Dequantized per-slot views ``[S, T, D]`` of one layer's pool."""
    S, M = block_tables.shape
    Bs, D = pool.shape[1], pool.shape[2]
    view = _kv_q_dequant(pool[block_tables], scales[block_tables])
    return view.to(dtype).reshape(S, M * Bs, D)[:, :T]


def _row_kv_q(k_pool: torch.Tensor, v_pool: torch.Tensor,
              k_scales: torch.Tensor, v_scales: torch.Tensor,
              tables: torch.Tensor, flat_ix: torch.Tensor,
              blk_local: torch.Tensor, fresh: torch.Tensor,
              valid: torch.Tensor, T: int) -> Callable:
    """The int8 pools' whole-row ``kv`` for :func:`_serve_layers`: each
    layer's new rows [R, K1, D] go through :func:`_row_write_q`, and the
    views are the rows as written, cut to ``T``."""
    def kv(i, k, v):
        kc = _row_write_q(k_pool[i], k_scales[i], tables, flat_ix,
                          blk_local, fresh, valid, k)
        vc = _row_write_q(v_pool[i], v_scales[i], tables, flat_ix,
                          blk_local, fresh, valid, v)
        return kc[:, :T].to(k.dtype), vc[:, :T].to(v.dtype)

    return kv


def _window_write_ix(pos_ix: torch.Tensor, valid: torch.Tensor,
                     block_size: int, n_blocks: int):
    """:func:`_row_write_q`'s ``(flat_ix, blk_local, fresh)`` for window
    positions ``pos_ix`` [R, K1]: invalid lanes are dropped, and a valid
    write at a block's offset 0 resets its scale."""
    drop = n_blocks * block_size
    return (torch.where(valid, pos_ix, drop),
            torch.where(valid, (pos_ix // block_size).clamp(
                0, n_blocks - 1), n_blocks),
            (valid & (pos_ix % block_size == 0)).float())


@torch.no_grad()
def decode_step_paged_q(cfg: TransformerConfig, params: Dict[str, Any],
                        k_pool: torch.Tensor, v_pool: torch.Tensor,
                        k_scales: torch.Tensor, v_scales: torch.Tensor,
                        block_tables: torch.Tensor, tok: torch.Tensor,
                        pos: torch.Tensor, active: torch.Tensor,
                        t_logical: Optional[int] = None):
    """:func:`decode_step_paged` over int8 pools ``[L, N, Bs, D]`` and
    fp32 ``k_scales``/``v_scales`` [L, N], in place. Each live slot writes
    one block it owns alone (the engine copies a shared block before any
    write), so the write is a per-slot gather, requantize and scatter of
    that block; dead lanes park on the scratch block. Returns ``(k_pool,
    v_pool, k_scales, v_scales, next_tok, pos)``."""
    S = tok.shape[0]
    Bs = k_pool.shape[2]
    M = block_tables.shape[1]
    T = M * Bs if t_logical is None else int(t_logical)
    write_blk, write_off = _step_slots(block_tables, pos, active, Bs)
    lanes = torch.arange(S, device=tok.device)

    def write(pool, scales, rows):
        cur_s = scales[write_blk]                            # [S]
        cur = _kv_q_dequant(pool[write_blk], cur_s)          # [S, Bs, D]
        rows32 = rows.float()
        cur[lanes, write_off] = rows32
        # entering a block at offset 0 drops the prior occupant's scale
        base = torch.where(write_off == 0, torch.zeros_like(cur_s), cur_s)
        new_s = torch.maximum(base, rows32.abs().amax(-1) / _KV_QMAX)
        pool[write_blk] = _kv_q_requant(cur, new_s)
        scales[write_blk] = new_s

    def kv(i, k, v):
        write(k_pool[i], k_scales[i], k[:, 0])
        write(v_pool[i], v_scales[i], v[:, 0])
        return (_gather_q(k_pool[i], k_scales[i], block_tables, T, k.dtype),
                _gather_q(v_pool[i], v_scales[i], block_tables, T, v.dtype))

    h = params["embed"][tok] + params["pos"][pos]
    h = _serve_layers(cfg, params, h[:, None], pos, kv)
    return (k_pool, v_pool, k_scales, v_scales) \
        + _step_out(params, h, tok, pos, active)


@torch.no_grad()
def prefill_chunk_paged_q(cfg: TransformerConfig, params: Dict[str, Any],
                          k_pool: torch.Tensor, v_pool: torch.Tensor,
                          k_scales: torch.Tensor, v_scales: torch.Tensor,
                          block_tables: torch.Tensor, slot: torch.Tensor,
                          tokens: torch.Tensor, offset: torch.Tensor,
                          length: torch.Tensor,
                          t_logical: Optional[int] = None):
    """:func:`prefill_chunk_paged` over the int8 pools: the chunk's writes
    span several blocks of one slot, so the slot's whole table row
    round-trips through fp32 (pad lanes dropped); untouched blocks get
    their exact old bytes back. Returns ``(k_pool, v_pool, k_scales,
    v_scales, logits [V])``."""
    C = tokens.shape[0]
    Bs = k_pool.shape[2]
    M = block_tables.shape[1]
    T = M * Bs if t_logical is None else int(t_logical)
    bt_row = block_tables.index_select(0, slot.reshape(1))   # [1, M]
    lane = torch.arange(C, device=tokens.device)
    pos_ix = (offset + lane)[None]
    valid = (lane < length)[None]
    kv = _row_kv_q(k_pool, v_pool, k_scales, v_scales, bt_row,
                   *_window_write_ix(pos_ix, valid, Bs, M), valid, T)
    h = _serve_layers(cfg, params, _chunk_embed(params, tokens, pos_ix[0])
                      [None], offset.reshape(1), kv)
    return (k_pool, v_pool, k_scales, v_scales,
            _last_logits(params, h[0], length))


@torch.no_grad()
def verify_step_paged_q(cfg: TransformerConfig, params: Dict[str, Any],
                        k_pool: torch.Tensor, v_pool: torch.Tensor,
                        k_scales: torch.Tensor, v_scales: torch.Tensor,
                        block_tables: torch.Tensor, toks: torch.Tensor,
                        pos: torch.Tensor, active: torch.Tensor,
                        n_valid: torch.Tensor,
                        t_logical: Optional[int] = None):
    """:func:`verify_step_paged` over the int8 pools: a window can write
    several positions of one block, so every slot's whole table row
    round-trips through fp32. Blocks a slot does not write (shared
    prefix blocks, scratch padding) get their exact old bytes back, so
    the cross-slot duplicate writes carry one value. Returns ``(k_pool,
    v_pool, k_scales, v_scales, out_tok [S, K1])``."""
    S, K1 = toks.shape
    Bs = k_pool.shape[2]
    M = block_tables.shape[1]
    T = M * Bs if t_logical is None else int(t_logical)
    pos_ix, valid, _, _ = _window_slots(block_tables, pos, active, n_valid,
                                        Bs, K1)
    kv = _row_kv_q(k_pool, v_pool, k_scales, v_scales, block_tables,
                   *_window_write_ix(pos_ix, valid, Bs, M), valid, T)
    h = _serve_layers(cfg, params, _chunk_embed(params, toks, pos_ix), pos,
                      kv)
    return (k_pool, v_pool, k_scales, v_scales,
            _window_out(params, h, valid, toks.dtype))


def cache_insert_paged_q(k_pool: torch.Tensor, v_pool: torch.Tensor,
                         k_scales: torch.Tensor, v_scales: torch.Tensor,
                         block_tables: torch.Tensor, ks: torch.Tensor,
                         vs: torch.Tensor):
    """:func:`cache_insert_paged` into the int8 pools: b whole prompts'
    K/V ``[L, b, P, D]`` quantize through per-row tables ``[b, M]``.
    Positions write from 0, so every written block resets its scale from
    the fresh data. Returns ``(k_pool, v_pool, k_scales, v_scales)``."""
    L, b, P, _ = ks.shape
    Bs = k_pool.shape[2]
    M = block_tables.shape[1]
    p = torch.arange(P, device=block_tables.device)
    loc = (p // Bs).clamp(0, M - 1)
    flat_ix = (loc * Bs + p % Bs).expand(b, P)
    fresh = (p % Bs == 0).float().expand(b, P)
    valid = torch.ones((b, P), dtype=torch.bool, device=p.device)
    loc_b = loc.expand(b, P)
    for i in range(L):
        _row_write_q(k_pool[i], k_scales[i], block_tables, flat_ix, loc_b,
                     fresh, valid, ks[i])
        _row_write_q(v_pool[i], v_scales[i], block_tables, flat_ix, loc_b,
                     fresh, valid, vs[i])
    return k_pool, v_pool, k_scales, v_scales


@torch.no_grad()
def admit_insert_paged_q(cfg: TransformerConfig, params: Dict[str, Any],
                         k_pool: torch.Tensor, v_pool: torch.Tensor,
                         k_scales: torch.Tensor, v_scales: torch.Tensor,
                         block_tables: torch.Tensor, tokens: torch.Tensor,
                         lengths: torch.Tensor):
    """:func:`admit_insert_paged` into the int8 pools: the fp prefill and
    the first token are unchanged (computed before quantization); only
    the insert quantizes. Returns ``(first [b], k_pool, v_pool, k_scales,
    v_scales)``."""
    logits, ks, vs = prefill(cfg, params, tokens)
    first = first_tokens(logits, lengths, tokens.dtype)
    cache_insert_paged_q(k_pool, v_pool, k_scales, v_scales, block_tables,
                         ks, vs)
    return first, k_pool, v_pool, k_scales, v_scales


def cow_block_copy_q(k_pool: torch.Tensor, v_pool: torch.Tensor,
                     k_scales: torch.Tensor, v_scales: torch.Tensor,
                     src: torch.Tensor, dst: torch.Tensor):
    """:func:`cow_block_copy` of the int8 pools: the copy takes its
    source's bytes and its scale column."""
    cow_block_copy(k_pool, v_pool, src, dst)
    for scales in (k_scales, v_scales):
        scales.index_copy_(1, dst.reshape(1),
                           scales.index_select(1, src.reshape(1)))
    return k_pool, v_pool, k_scales, v_scales


# -- serving: int8 decode parameter pins -------------------------------------


def _is_quant_leaf(x: Any) -> bool:
    return isinstance(x, dict) and set(x.keys()) == {"q", "s"}


def dequantize_decode_params(qparams: Dict[str, Any],
                             dtype=torch.float32) -> Dict[str, Any]:
    """Inverse of :func:`serving.snapshot.quantize_decode_params`: each
    ``{"q": int8, "s": fp32}`` leaf multiplies out to ``dtype``. XLA folds
    this into the compiled program; here it runs eagerly at the top of
    every serving program, so the int8 pin stays resident and each call
    materializes a ``dtype`` copy."""
    def deq(leaf):
        return (leaf["q"].float() * leaf["s"]).to(dtype)

    return {k: (deq(v) if _is_quant_leaf(v)
                else {n: deq(w) for n, w in v.items()})
            for k, v in qparams.items()}


@torch.no_grad()
def greedy_decode(cfg: TransformerConfig, params: Dict[str, Any],
                  tokens: torch.Tensor, lengths: torch.Tensor, max_new: int,
                  eos_id: Optional[int] = None, *,
                  slots: Optional[int] = None,
                  cache_len: Optional[int] = None) -> torch.Tensor:
    """Greedy continuation: up to ``max_new`` tokens per prompt.

    ``tokens`` [B, P] right-padded ids, ``lengths`` [B] true lengths.
    Returns [B, max_new] ids. With ``eos_id``, a lane that emits it is
    frozen: later emissions are 0 and its ``pos`` stops advancing.

    The decode steps run :func:`decode_step` over a cache of ``slots``
    lanes (default B; lanes past B stay inactive) and ``cache_len``
    positions (default ``P + max_new``). Passing a decode engine's slot
    count and cache length makes every product here the same shape as the
    engine's, so on the card the two agree bit for bit.
    """
    B, P = tokens.shape
    L, D = cfg.n_layers, cfg.d_model
    S = B if slots is None else int(slots)
    T = P + max_new if cache_len is None else int(cache_len)
    if S < B or T < P + max_new:
        raise ValueError(f"greedy_decode: slots {S} < batch {B} or "
                         f"cache_len {T} < {P + max_new}")
    dev = tokens.device
    logits, ks, vs = prefill(cfg, params, tokens)
    first = first_tokens(logits, lengths, tokens.dtype)
    if max_new <= 1:
        return first[:, None]
    k_cache = torch.zeros((L, S, T, D), dtype=ks.dtype, device=dev)
    v_cache = torch.zeros((L, S, T, D), dtype=vs.dtype, device=dev)
    k_cache[:, :B, :P] = ks
    v_cache[:, :B, :P] = vs
    tok = torch.zeros(S, dtype=tokens.dtype, device=dev)
    pos = torch.zeros(S, dtype=tokens.dtype, device=dev)
    done = torch.ones(S, dtype=torch.bool, device=dev)
    tok[:B] = first
    pos[:B] = lengths.to(tokens.dtype)
    done[:B] = (first == eos_id) if eos_id is not None else False
    out = [first]
    for _ in range(max_new - 1):
        k_cache, v_cache, tok, pos = decode_step(
            cfg, params, k_cache, v_cache, tok, pos, ~done)
        out.append(tok[:B].clone())
        if eos_id is not None:
            done = done | (tok == eos_id)
    return torch.stack(out, dim=1)


class TransformerLM:
    """The JAX ``TransformerLM`` on one device: a momentum-SGD trainer
    (:meth:`train_batch`) and the serving surface (``version`` and
    :meth:`snapshot_params`). The parameters require grad; the momentum
    buffers, in the parameter dtype, do not."""

    def __init__(self, config: TransformerConfig, device: Any = None) -> None:
        if config.d_model % config.n_heads != 0:
            Log.fatal("d_model must divide by n_heads")
        if device is None:
            from ..runtime import Session

            sess = Session.get()
            sess._require_started()
            device = sess.device
        self.config = config
        self.device = torch.device(device)
        # serving contract: ``version`` counts train steps, and
        # snapshot_params copies under the lock that a train step holds
        self._lock = threading.Lock()
        self.version = 0
        self.params = _map(lambda w: w.requires_grad_(),
                           init_params(config, device=self.device))
        self._momentum = _map(torch.zeros_like, self.params)

    def _tokens(self, tokens) -> torch.Tensor:
        """Token ids as int64 on the model's device; a host array goes to
        the card through pinned memory, without a host sync."""
        if isinstance(tokens, torch.Tensor):
            return tokens.to(self.device, torch.int64)
        host = torch.from_numpy(np.asarray(tokens, np.int64))
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host

    def _step(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        params = _leaves(self.params)
        loss = loss_fn(cfg, self.params, tokens)
        grads = torch.autograd.grad(loss, params)
        # m = mu * m + g, p = p - lr * m, in place: JAX donates the old
        # buffers and returns new ones, here the buffers are updated
        with torch.no_grad():
            for p, m, g in zip(params, _leaves(self._momentum), grads):
                m.mul_(cfg.momentum).add_(g.to(m.dtype))
                p.sub_(cfg.learning_rate * m.to(p.dtype))
        return loss.detach()

    def train_batch(self, tokens) -> torch.Tensor:
        """One step on [B, T] token ids; returns the loss before the step
        as a device scalar, without a host sync."""
        tokens = self._tokens(tokens)
        with self._lock:
            loss = self._step(tokens)
            self.version += 1
        return loss

    def snapshot_params(self) -> Tuple[Dict[str, Any], int]:
        """``(params copy, version)`` taken under the lock; the copies are
        detached, so serving them builds no autograd graph."""
        with self._lock:
            return _map(lambda w: w.detach().clone(), self.params), \
                self.version

    def logits(self, tokens) -> torch.Tensor:
        """Logits [B, T, V] f32 of the current parameters (no grad)."""
        with torch.no_grad():
            return forward(self.config, self.params, self._tokens(tokens))
