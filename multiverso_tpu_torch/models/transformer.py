"""Transformer language model: the serving math of the flagship LM.

Counterpart of ``multiverso_tpu/models/transformer.py`` for the serving
slice: the config, the random parameters (drawn from the same numpy
stream, so one seed gives the same weights in both packages), the causal
prefill, the one-token decode step over a slotted KV cache, the cache
insert, the greedy decode oracle, and the serving surface of
:class:`TransformerLM`. Training comes with a later slice.

Pre-LN, learned positions, tied input/output embeddings. Parameters are a
plain dict of tensors with per-layer weights stacked on dim 0, the JAX
pytree's layout. Where the JAX functions return updated caches, these
update the cache tensors in place and return them.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..log import Log

_NEG_INF = -1e30
_LAYER_KEYS = ("ln1_g", "ln2_g", "w_q", "w_k", "w_v", "w_o", "w_ff1",
               "w_ff2")


@dataclass
class TransformerConfig:
    """The JAX config's serving fields; the training fields
    (``learning_rate``, ``momentum``, ``scan_layers``) come with the
    training slice."""

    vocab_size: int
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    max_seq: int = 256
    dtype: Any = torch.float32
    seed: int = 0
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


def _layer(params: Dict[str, Any], i: int) -> Dict[str, torch.Tensor]:
    return {k: w[i] for k, w in params["layers"].items()}


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


def _cached_attention(q, k_cache, v_cache, n_heads: int,
                      pos: torch.Tensor) -> torch.Tensor:
    """One-token attention: ``q`` [B, D] against cache [B, T, D]; cache
    entries at positions <= ``pos`` [B] are live."""
    B, D = q.shape
    T = k_cache.shape[1]
    dh = D // n_heads
    qh = q.reshape(B, n_heads, dh)
    kh = k_cache.reshape(B, T, n_heads, dh)
    vh = v_cache.reshape(B, T, n_heads, dh)
    scores = torch.einsum("bhd,bthd->bht", qh.float(),
                          kh.float()) / math.sqrt(dh)
    mask = (torch.arange(T, device=q.device)[None, :]
            <= pos[:, None])[:, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bht,bthd->bhd", probs.to(vh.dtype), vh)
    return out.reshape(B, D).to(q.dtype)


def prefill(cfg: TransformerConfig, params: Dict[str, Any],
            tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal forward over right-padded prompts ``tokens`` [B, P],
    recording per-layer K/V. Returns ``(logits [B, P, V] f32,
    k [L, B, P, D], v [L, B, P, D])``; positions past a prompt's length
    hold garbage that decode overwrites before any mask reaches it."""
    B, P = tokens.shape
    h = params["embed"][tokens] + params["pos"][:P]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        layer = _layer(params, i)
        x = _rmsnorm(h, layer["ln1_g"])
        q, k, v = x @ layer["w_q"], x @ layer["w_k"], x @ layer["w_v"]
        ks.append(k)
        vs.append(v)
        h = h + _attention(q, k, v, cfg.n_heads,
                           cfg.attention) @ layer["w_o"]
        x = _rmsnorm(h, layer["ln2_g"])
        h = h + _gelu(x @ layer["w_ff1"]) @ layer["w_ff2"]
    h = _rmsnorm(h, params["ln_f_g"])
    return _logits(h, params["embed"]), torch.stack(ks), torch.stack(vs)


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
    h = params["embed"][tok] + params["pos"][pos]
    for i in range(cfg.n_layers):
        layer = _layer(params, i)
        x = _rmsnorm(h, layer["ln1_g"])
        q, k, v = x @ layer["w_q"], x @ layer["w_k"], x @ layer["w_v"]
        k_cache[i, slot_ix, write_pos] = k
        v_cache[i, slot_ix, write_pos] = v
        h = h + _cached_attention(q, k_cache[i], v_cache[i], cfg.n_heads,
                                  pos) @ layer["w_o"]
        x = _rmsnorm(h, layer["ln2_g"])
        h = h + _gelu(x @ layer["w_ff1"]) @ layer["w_ff2"]
    h = _rmsnorm(h, params["ln_f_g"])
    out = _logits(h, params["embed"])
    # torch.argmax returns the first maximal index, as jnp.argmax does
    nxt = torch.argmax(out, dim=-1).to(tok.dtype)
    nxt = torch.where(active, nxt, torch.zeros_like(nxt))
    pos = torch.where(active, pos + 1, pos)
    return k_cache, v_cache, nxt, pos


def cache_insert(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 slots, ks: torch.Tensor, vs: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write b prefilled sequences' K/V ``[L, b, P, D]`` into ``slots``
    [b], in place. Rows are written last-to-first so that row 0 wins when
    pad rows of a partial batch point at ``slots[0]``."""
    P = ks.shape[2]
    for i in reversed(range(ks.shape[1])):
        s = int(slots[i])
        k_cache[:, s, :P] = ks[:, i]
        v_cache[:, s, :P] = vs[:, i]
    return k_cache, v_cache


def first_tokens(logits: torch.Tensor, lengths: torch.Tensor,
                 dtype=torch.int64) -> torch.Tensor:
    """Greedy token at each prompt's last real position."""
    rows = torch.arange(logits.shape[0], device=logits.device)
    return torch.argmax(logits[rows, lengths - 1], dim=-1).to(dtype)


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
    """The serving surface of the JAX ``TransformerLM``: parameters on one
    device, a ``version`` counter and :meth:`snapshot_params`."""

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
        self._lock = threading.Lock()
        self.version = 0
        self.params = init_params(config, device=self.device)

    def snapshot_params(self) -> Tuple[Dict[str, Any], int]:
        """``(params copy, version)`` taken under the lock."""
        with self._lock:
            copy = {k: ({n: w.clone() for n, w in v.items()}
                        if isinstance(v, dict) else v.clone())
                    for k, v in self.params.items()}
            return copy, self.version
