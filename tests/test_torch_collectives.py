"""The collectives' pieces that need no group, against the JAX package.

The allreduce engine's step schedules (Bruck allgather, recursive
halving) for group sizes 1 to 16, ring attention's block step
(``_block_attn``) on the same inputs as JAX's, and the collectives and
attention of a process alone (a group of one). The cases across
processes are in ``tests/test_torch_seqpar.py``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.parallel import allreduce_engine as jax_engine
from multiverso_tpu_torch.ops import (reference_attention, ring_attention,
                                      ulysses_attention)
from multiverso_tpu_torch.parallel import allreduce_engine, collectives

# the modules (each package's ops/__init__ binds the function's name)
ring_module = importlib.import_module(
    "multiverso_tpu_torch.ops.ring_attention")
_jax_block_attn = importlib.import_module(
    "multiverso_tpu.ops.ring_attention")._block_attn


@pytest.mark.parametrize("n", range(1, 17))
def test_bruck_schedule_matches_jax(n):
    assert allreduce_engine.bruck_schedule(n) == \
        jax_engine.bruck_schedule(n)


@pytest.mark.parametrize("n", range(1, 17))
def test_recursive_halving_schedule_matches_jax(n):
    assert allreduce_engine.recursive_halving_schedule(n) == \
        jax_engine.recursive_halving_schedule(n)


def _block_inputs(seed: int, fresh: bool):
    rng = np.random.default_rng(seed)
    sq, sk, h, d = 12, 16, 3, 8
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((sq, h, d), (sk, h, d), (sk, h, d)))
    if fresh:    # the ring's first step: nothing accumulated yet
        m = np.full((h, sq), -1e30, np.float32)
        l = np.zeros((h, sq), np.float32)
        acc = np.zeros((sq, h, d), np.float32)
    else:        # a later step, some rows still at the sentinel
        m = rng.standard_normal((h, sq)).astype(np.float32)
        m[:, :3] = -1e30
        l = rng.uniform(0.5, 3.0, (h, sq)).astype(np.float32)
        l[:, :3] = 0.0
        acc = rng.standard_normal((sq, h, d)).astype(np.float32)
        acc[:3] = 0.0
    return q, k, v, m, l, acc


@pytest.mark.parametrize("fresh", [True, False])
@pytest.mark.parametrize("offsets", [(0, 0), (20, 0), (4, 10), (0, 16)])
@pytest.mark.parametrize("causal", [False, True])
def test_block_attn_matches_jax(causal, offsets, fresh):
    """One ring step's accumulation: the diagonal block, a block wholly
    before the rows, one the diagonal cuts, and one wholly after them
    (every score masked under causal)."""
    q, k, v, m, l, acc = _block_inputs(sum(offsets) + fresh, fresh)
    q_pos = offsets[0] + np.arange(q.shape[0])
    k_pos = offsets[1] + np.arange(k.shape[0])
    scale = 1.0 / np.sqrt(q.shape[-1])
    ref = _jax_block_attn(*(jnp.asarray(a) for a in (q, k, v, q_pos,
                                                     k_pos)),
                          causal, scale,
                          *(jnp.asarray(a) for a in (m, l, acc)))
    t = torch.from_numpy
    got = ring_module._block_attn(t(q), t(k), t(v), t(q_pos), t(k_pos),
                                  causal, scale, t(m), t(l), t(acc))
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_block_attn_batch_dim():
    """A leading batch dim is each batch element's step."""
    parts = [_block_inputs(s, False) for s in (1, 2)]
    q_pos, k_pos = torch.arange(4, 16), torch.arange(10, 26)
    stacked = [torch.from_numpy(np.stack(x)) for x in zip(*parts)]
    got = ring_module._block_attn(*stacked[:3], q_pos, k_pos, True, 0.3,
                                  *stacked[3:])
    for b, part in enumerate(parts):
        one = ring_module._block_attn(
            *(torch.from_numpy(a) for a in part[:3]), q_pos, k_pos, True,
            0.3, *(torch.from_numpy(a) for a in part[3:]))
        for x, y in zip(got, one):
            torch.testing.assert_close(x[b], y)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ring_attention_alone_is_attention(impl):
    """A process alone is a ring of one: exact attention, with grads,
    batched or not."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(rng.standard_normal((2, 24, 2, 8)),
                            dtype=torch.float32, requires_grad=True)
               for _ in range(3))
    out = ring_attention(q, k, v, causal=True, impl=impl)
    ref = reference_attention(q, k, v, causal=True)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad((out ** 2).sum(), (q, k, v))
    ref_grads = torch.autograd.grad((ref ** 2).sum(), (q, k, v))
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(
        ring_attention(q[0], k[0], v[0], causal=True, impl=impl), ref[0],
        rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="impl"):
        ring_attention(q, k, v, impl="flash")


def test_ulysses_alone_and_its_errors():
    rng = np.random.default_rng(6)
    q = torch.tensor(rng.standard_normal((16, 4, 8)), dtype=torch.float32)
    torch.testing.assert_close(ulysses_attention(q, q, q, causal=True),
                               reference_attention(q, q, q, causal=True))
    with pytest.raises(ValueError, match="impl"):
        ulysses_attention(q, q, q, impl="pallas")
    with pytest.raises(ValueError, match="attn_kwargs"):
        ulysses_attention(q, q, q, min_flash_seq=1)


def test_collectives_alone():
    """Alone, every collective returns its input's value in a new tensor,
    and stages nothing through the host."""
    collectives.reset_stats()
    x = torch.arange(12.0).reshape(4, 3)
    for fn in (collectives.allreduce, collectives.allreduce_replicated,
               collectives.all_gather, collectives.reduce_scatter,
               collectives.ring_shift,
               lambda t: collectives.all_to_all(t, 1, 0)):
        y = fn(x)
        torch.testing.assert_close(y, x)
        assert y.data_ptr() != x.data_ptr()
    torch.testing.assert_close(collectives.allreduce(x, mean=True), x)
    eng = allreduce_engine.AllreduceEngine()
    for fn in (eng.allgather, eng.reduce_scatter, eng.allreduce):
        torch.testing.assert_close(fn(x), x)
    assert collectives.STATS["staged_bytes"] == 0
