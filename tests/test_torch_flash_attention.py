"""The port's flash attention against the JAX package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode (the one-block
kernel when K/V fit one ``block_k``, the online-softmax kernel otherwise);
the port's wrapper takes its plain version for CPU tensors. The CUDA
kernel itself runs only on the card (``chip_smoke.py`` holds it against
the plain version there). Tolerance 2e-5 in f32, the JAX suite's own.

The bf16 cases hold the plain version, the oracle of the card's bf16
kernel, to the JAX kernels' casts: p rounded to bf16 for the PV product,
the unrounded p summed into l. m and l are held at f32 tightness (a sum
of the rounded p is ~1e-3 off); out and the accumulator within
``BF16_TOL`` (the bound the card's kernel is held to: a p whose bf16
rounding flips between two summation orders moves a row by up to
2^-8 |v| / l); and where JAX runs its one-block kernel, which rounds p
against the row's final max as the plain version does, the
accumulator's mean error within ``BF16_ACC_MEAN_TOL`` (a PV product of
the unrounded p is ~5e-4 off there; the online kernel rounds p against
each block's running max instead).
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
# bf16 (module docstring): out, and the accumulator relative to its row
# sum, as chip_smoke.py's phase 2 holds the card's kernel; m and l at f32
# tightness (a few ulps of a sum of at most 200 terms)
BF16_TOL = 2e-2
BF16_STAT_TOL = dict(rtol=2e-6, atol=1e-6)
BF16_ACC_MEAN_TOL = 1e-5


def _case(name, sq, sk, bq, bk, dtype="float32", dim=16):
    """A shape case; its id is the name and the sizes, then the dtype and
    head_dim where they are not f32 and 16."""
    extra = [] if (dtype, dim) == ("float32", 16) else [dtype, f"d{dim}"]
    return pytest.param(name, sq, sk, bq, bk, dtype, dim,
                        id="-".join(map(str, (name, sq, sk, bq, bk, *extra))))


# (name, sq, sk, jax block_q, jax block_k, dtype, head_dim): which JAX
# kernel answers
SHAPES = [
    _case("one_block_k3", 128, 128, 128, 128),
    _case("multi_block_k4", 256, 256, 64, 128),
    _case("ragged", 96, 96, 64, 128),
    _case("cross_lengths", 40, 72, 1024, 1024),
    # the oracle of the card's bf16 kernel: zero-filled head_dim columns
    # there, below one tile, cross lengths through JAX's online kernel
    _case("head_dim_40", 96, 96, 64, 128, "bfloat16", 40),
    _case("tiny", 7, 7, 8, 128, "bfloat16", 16),
    _case("cross_lengths", 40, 200, 32, 128, "bfloat16", 16),
]


def _qkv(sq, sk, heads=2, dim=16, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    return (rng.standard_normal(lead + (sq, heads, dim)).astype(np.float32),
            rng.standard_normal(lead + (sk, heads, dim)).astype(np.float32),
            rng.standard_normal(lead + (sk, heads, dim)).astype(np.float32))


def _t(*arrays, dtype="float32"):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _j(*arrays, dtype="float32"):
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _one_block(sk, bk):
    """Whether JAX's _fa_call takes its one-block kernel (nk == 1)."""
    return sk <= min(bk, max(128, 1 << (sk - 1).bit_length()))


def _assert_partial_close(got, want, dtype, one_block):
    """``(acc, m, l)`` of the port against JAX's at ``dtype``'s tolerances
    (module docstring)."""
    got, want = [_f32(x) for x in got], [_f32(x) for x in want]
    if dtype == "float32":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)
        return
    (acc, m, l), (w_acc, w_m, w_l) = got, want
    np.testing.assert_allclose(m, w_m, **BF16_STAT_TOL)
    np.testing.assert_allclose(l, w_l, **BF16_STAT_TOL)
    err = np.abs(acc - w_acc) / np.maximum(w_l, 1.0).T[:, :, None]
    assert err.max() <= BF16_TOL, err.max()
    if one_block:
        assert err.mean() <= BF16_ACC_MEAN_TOL, err.mean()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name,sq,sk,bq,bk,dtype,dim", SHAPES)
def test_flash_attention_matches_jax(name, sq, sk, bq, bk, dtype, dim,
                                     causal):
    q, k, v = _qkv(sq, sk, dim=dim, seed=len(name))
    want = jax_flash(*_j(q, k, v, dtype=dtype), causal=causal, block_q=bq,
                     block_k=bk)
    got = flash_attention(*_t(q, k, v, dtype=dtype), causal=causal)
    assert str(got.dtype) == f"torch.{dtype}"
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                                   atol=BF16_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name,sq,sk,bq,bk,dtype,dim", SHAPES)
def test_flash_partial_matches_jax(name, sq, sk, bq, bk, dtype, dim, causal):
    q, k, v = _qkv(sq, sk, dim=dim, seed=len(name) + 1)
    want = jax_partial(*_j(q, k, v, dtype=dtype), 0, 0, causal=causal,
                       block_q=bq, block_k=bk)
    got = flash_attention_partial(*_t(q, k, v, dtype=dtype), 0, 0,
                                  causal=causal)
    _assert_partial_close(got, want, dtype, _one_block(sk, bk))


def _offsets(q_base, k_base, dtype="float32"):
    return pytest.param(q_base, k_base, dtype, id="-".join(
        map(str, (q_base, k_base) + (() if dtype == "float32"
                                     else (dtype,)))))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("q_base,k_base,dtype", [
    _offsets(64, 0), _offsets(0, 40), _offsets(16, 200),
    # bf16: q_base > k_base with the diagonal inside the keys, and rows
    # with no live key
    _offsets(64, 0, "bfloat16"), _offsets(37, 5, "bfloat16"),
    _offsets(0, 40, "bfloat16"), _offsets(16, 200, "bfloat16")])
def test_flash_partial_offsets_match_jax(q_base, k_base, dtype, causal):
    """Global offsets, including rows that the causal mask leaves with no
    live key: those give m = -1e30, l = 0 and a zero accumulator."""
    q, k, v = _qkv(64, 96, seed=q_base + k_base)
    want = jax_partial(*_j(q, k, v, dtype=dtype), q_base, k_base,
                       causal=causal, block_q=32, block_k=128)
    got = flash_attention_partial(*_t(q, k, v, dtype=dtype), q_base, k_base,
                                  causal=causal)
    _assert_partial_close(got, want, dtype, _one_block(96, 128))
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
