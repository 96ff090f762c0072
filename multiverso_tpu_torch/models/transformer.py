"""Transformer language model: the flagship LM's training and serving math.

Counterpart of ``multiverso_tpu/models/transformer.py`` for the serving
and training slices: the config, the random parameters (drawn from the
same numpy stream, so one seed gives the same weights in both packages),
the training ``forward`` and ``loss_fn``, the causal prefill, the
one-token decode step over a slotted KV cache, the cache insert, the
greedy decode oracle, and :class:`TransformerLM` (one-device momentum-SGD
trainer and serving surface). The JAX trainer's mesh (dp batches, tp
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
    h = params["embed"][tok] + params["pos"][pos]
    for i, layer in enumerate(_layers(params)):
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
