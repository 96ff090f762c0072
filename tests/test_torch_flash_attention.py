"""The port's flash attention against the JAX package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode (the one-block
kernel when K/V fit one ``block_k``, the online-softmax kernel otherwise);
the port's wrapper takes its plain version for CPU tensors. The CUDA
kernel itself runs only on the card (``chip_smoke.py`` holds it against
the plain version there). Tolerance 2e-5, the JAX suite's own.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.ops import flash_attention as jax_flash
from multiverso_tpu.ops import flash_attention_partial as jax_partial
from multiverso_tpu.ops import reference_attention as jax_reference
from multiverso_tpu_torch.ops import (best_attention, flash_attention,
                                      flash_attention_partial,
                                      merge_partials, reference_attention)

port_fa = importlib.import_module("multiverso_tpu_torch.ops.flash_attention")

TOL = dict(rtol=2e-5, atol=2e-5)

# (name, sq, sk, jax block_q, jax block_k): which JAX kernel answers
SHAPES = [
    ("one_block_k3", 128, 128, 128, 128),
    ("multi_block_k4", 256, 256, 64, 128),
    ("ragged", 96, 96, 64, 128),
    ("cross_lengths", 40, 72, 1024, 1024),
]


def _qkv(sq, sk, heads=2, dim=16, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    return (rng.standard_normal(lead + (sq, heads, dim)).astype(np.float32),
            rng.standard_normal(lead + (sk, heads, dim)).astype(np.float32),
            rng.standard_normal(lead + (sk, heads, dim)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name,sq,sk,bq,bk", SHAPES)
def test_flash_attention_matches_jax(name, sq, sk, bq, bk, causal):
    q, k, v = _qkv(sq, sk, seed=len(name))
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, block_q=bq, block_k=bk)
    got = flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name,sq,sk,bq,bk", SHAPES)
def test_flash_partial_matches_jax(name, sq, sk, bq, bk, causal):
    q, k, v = _qkv(sq, sk, seed=len(name) + 1)
    want = jax_partial(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0, 0,
                       causal=causal, block_q=bq, block_k=bk)
    got = flash_attention_partial(*_t(q, k, v), 0, 0, causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("q_base,k_base", [(64, 0), (0, 40), (16, 200)])
def test_flash_partial_offsets_match_jax(q_base, k_base, causal):
    """Global offsets, including rows that the causal mask leaves with no
    live key: those give m = -1e30, l = 0 and a zero accumulator."""
    q, k, v = _qkv(64, 96, seed=q_base + k_base)
    want = jax_partial(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       q_base, k_base, causal=causal, block_q=32,
                       block_k=128)
    got = flash_attention_partial(*_t(q, k, v), q_base, k_base,
                                  causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if causal and k_base > q_base:
        dead = k_base - q_base              # rows with no live key
        assert np.all(got[1].numpy()[:, :dead] == -1e30)
        assert np.all(got[2].numpy()[:, :dead] == 0)
        assert np.all(got[0].numpy()[:dead] == 0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_batched_matches_jax_per_example(causal):
    """A leading batch dim (the port's replacement for JAX's vmap)."""
    q, k, v = _qkv(48, 48, batch=3, seed=5)
    got = flash_attention(*_t(q, k, v), causal=causal).numpy()
    for b in range(3):
        want = jax_flash(jnp.asarray(q[b]), jnp.asarray(k[b]),
                         jnp.asarray(v[b]), causal=causal)
        np.testing.assert_allclose(got[b], np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_best_attention_reference_path(causal):
    """Below the crossover (and on the CPU always) best_attention is
    reference_attention, which equals the JAX reference."""
    q, k, v = _qkv(64, 64, seed=4)
    tq, tk, tv = _t(q, k, v)
    got = best_attention(tq, tk, tv, causal=causal)
    ref = reference_attention(tq, tk, tv, causal=causal)
    assert torch.equal(got, ref)
    want = jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_partial_merge_equals_full():
    q, k, v = _t(*_qkv(64, 64, seed=2))
    acc_a, m_a, l_a = flash_attention_partial(q, k[:32], v[:32], 0, 0,
                                              causal=True)
    acc_b, m_b, l_b = flash_attention_partial(q, k[32:], v[32:], 0, 32,
                                              causal=True)
    m, l, acc = merge_partials(m_a, l_a, acc_a, m_b, l_b, acc_b)
    out = acc / torch.clamp(l, min=1e-20).transpose(1, 0)[:, :, None]
    ref = reference_attention(q, k, v, causal=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


def test_cuda_wrapper_rejects_bad_head_dim():
    """The kernel takes head_dim <= 128 in multiples of 8; the wrapper
    checks before it builds or launches anything."""
    q = torch.zeros((1, 8, 2, 12))
    with pytest.raises(ValueError, match="head_dim"):
        port_fa._fa_cuda(q, q, q, 0, 0, causal=False, scale=1.0,
                         normalize=True)


def test_no_fallback_for_other_devices():
    """Only CPU tensors take the plain version: any other device launches
    the kernel or raises."""
    q = torch.zeros((8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)


def test_launch_count_ignores_the_plain_version():
    port_fa.reset_launches()
    q, k, v = _t(*_qkv(32, 32, seed=7))
    flash_attention(q, k, v, causal=True)
    assert port_fa.LAUNCHES == 0 and not port_fa.LAUNCHES_BY_KEY_LEN
