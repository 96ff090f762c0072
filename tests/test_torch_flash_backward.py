"""The port's flash-attention backward against the JAX package's, on the CPU.

The JAX side runs its Pallas backward kernels in interpret mode, with
``block_q``/``block_k`` chosen so that each kernel answers: the one-pass
kernel (K5) when the keys fit one ``block_k``, the dq and dk/dv passes
(K6, K7) otherwise. The port's wrapper takes its plain version for CPU
tensors; the CUDA kernels run only on the card (``chip_smoke.py`` holds
them against the plain version there). Inputs are float32 numpy draws from
a seed; tolerance 1e-4, the JAX suite's own gradient tolerance
(``tests/test_flash_attention.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.ops import flash_attention as jax_flash
from multiverso_tpu.ops.flash_attention import \
    flash_attention_partial_bwd as jax_partial_bwd
from multiverso_tpu_torch.ops import (flash_attention,
                                      flash_attention_partial,
                                      flash_attention_partial_bwd)

port_fa = importlib.import_module("multiverso_tpu_torch.ops.flash_attention")

TOL = dict(rtol=1e-4, atol=1e-4)

# (name, sq, sk, jax block_q, jax block_k): which JAX kernel answers
SHAPES = [
    ("one_pass_k5", 128, 128, 64, 128),
    ("two_pass_k6_k7", 256, 256, 64, 128),
    ("ragged_two_pass", 96, 200, 64, 128),
    ("cross_lengths_one_pass", 40, 72, 1024, 1024),
]


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _stats(q, k, v, g, q_base, k_base, causal):
    """lse and delta of the rows from the forward partial (the port's,
    held to JAX's in test_torch_flash_attention.py), as a ring caller
    forms them: lse = m + log l, delta = rowsum(g * acc / l)."""
    acc, m, l = (x.numpy() for x in flash_attention_partial(
        *_t(q, k, v), q_base, k_base, causal=causal))
    lse = m + np.log(np.maximum(l, 1e-20))
    out = acc / np.maximum(l, 1e-20).T[:, :, None]
    delta = np.einsum("shd,shd->hs", g, out)
    return lse.astype(np.float32), delta.astype(np.float32)


def _check_partial_bwd(q, k, v, g, q_base, k_base, causal, bq, bk):
    lse, delta = _stats(q, k, v, g, q_base, k_base, causal)
    want = jax_partial_bwd(*(jnp.asarray(x) for x in (q, k, v, g, lse,
                                                      delta)),
                           q_base, k_base, causal=causal, block_q=bq,
                           block_k=bk)
    got = flash_attention_partial_bwd(*_t(q, k, v, g, lse, delta), q_base,
                                      k_base, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32, name
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)
    return got


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name,sq,sk,bq,bk", SHAPES)
def test_partial_bwd_matches_jax(name, sq, sk, bq, bk, causal):
    q, k, v, g = _draw(len(name), (sq, 2, 16), (sk, 2, 16), (sk, 2, 16),
                       (sq, 2, 16))
    _check_partial_bwd(q, k, v, g, 0, 0, causal, bq, bk)


@pytest.mark.parametrize("bk", [128, 32], ids=["one_pass", "two_pass"])
@pytest.mark.parametrize("q_base,k_base", [(64, 0), (0, 40), (16, 200)])
def test_partial_bwd_offsets_match_jax(q_base, k_base, bk):
    """Global offsets, including rows that the causal mask leaves with no
    live key (lse ~ -1e30, where exp(s - lse) is inf): their gradient is
    0, never NaN, and keys no live row sees get dk = dv = 0."""
    q, k, v, g = _draw(q_base + k_base, (64, 2, 16), (96, 2, 16),
                       (96, 2, 16), (64, 2, 16))
    dq, dk, dv = _check_partial_bwd(q, k, v, g, q_base, k_base, True, 32, bk)
    dead = max(0, min(64, k_base - q_base))   # rows with no live key
    assert torch.all(dq[:dead] == 0)
    last_row = q_base + 63 - k_base           # keys past it see no row
    if last_row < 95:
        assert torch.all(dk[max(0, last_row + 1):] == 0)
        assert torch.all(dv[max(0, last_row + 1):] == 0)


def test_partial_bwd_batched_equals_per_example():
    """A leading batch dim (the port's replacement for JAX's vmap)."""
    q, k, v, g = _draw(3, (2, 48, 2, 16), (2, 40, 2, 16), (2, 40, 2, 16),
                       (2, 48, 2, 16))
    stats = [_stats(q[b], k[b], v[b], g[b], 8, 0, True) for b in range(2)]
    lse = np.stack([s[0] for s in stats])
    delta = np.stack([s[1] for s in stats])
    got = flash_attention_partial_bwd(*_t(q, k, v, g, lse, delta), 8, 0,
                                      causal=True)
    for b in range(2):
        one = flash_attention_partial_bwd(
            *_t(q[b], k[b], v[b], g[b], lse[b], delta[b]), 8, 0, causal=True)
        for x, y in zip(got, one):
            np.testing.assert_allclose(x[b].numpy(), y.numpy(), **TOL)


def _jax_grads(q, k, v, w, causal, bq, bk):
    def loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=causal, block_q=bq,
                                 block_k=bk) * w)
    return jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name,sq,sk,bq,bk", SHAPES)
def test_autograd_matches_jax_grad(name, sq, sk, bq, bk, causal):
    """torch.autograd.grad through the port's flash_attention against
    jax.grad through JAX's custom VJP, at JAX's own 1e-4."""
    q, k, v, w = _draw(len(name) + 7, (sq, 2, 16), (sk, 2, 16), (sk, 2, 16),
                       (sq, 2, 16))
    want = _jax_grads(q, k, v, w, causal, bq, bk)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (tq, tk, tv))
    for name_, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name_)


def _port_grads(q, k, v, w, causal=True):
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    return torch.autograd.grad(
        (flash_attention(tq, tk, tv, causal=causal)
         * torch.from_numpy(w)).sum(), (tq, tk, tv))


def test_autograd_batched_and_bf16():
    """The batch dim of the model's calls equals per-example calls (each
    held to JAX above), and dq/dk/dv come back in the input dtype (JAX
    casts the f32 partials back: ``_flash_bwd``)."""
    q, k, v, w = _draw(11, (2, 32, 2, 16), (2, 32, 2, 16), (2, 32, 2, 16),
                       (2, 32, 2, 16))
    got = _port_grads(q, k, v, w)
    for b in range(2):
        want = _port_grads(q[b], k[b], v[b], w[b])
        for a, c in zip(got, want):
            np.testing.assert_allclose(a[b].numpy(), c.numpy(), **TOL)
    bq, bk, bv = (t.bfloat16().requires_grad_() for t in _t(q, k, v))
    grads = torch.autograd.grad(
        flash_attention(bq, bk, bv, causal=True).float().sum(), (bq, bk, bv))
    assert all(x.dtype == torch.bfloat16 for x in grads)


@pytest.mark.parametrize("sk", [1, 64, 1024, 1025, 2048, 4096])
def test_regime_choice_follows_jax_block_count(sk):
    """Key length <= 1024 takes the one-pass kernel, longer the dq + dk/dv
    passes: JAX's nk == 1 at its default block_k 1024."""
    block_k = min(1024, max(128, 1 << (sk - 1).bit_length()))
    nk = -(-sk // block_k)
    want = ("fused",) if nk == 1 else ("dq", "dkv")
    assert port_fa.bwd_kernels(sk) == want


def test_cuda_wrapper_rejects_cpu_tensors_without_fallback():
    """The CUDA wrapper raises on CPU tensors (it never computes the plain
    version), other devices raise at the dispatch, and the plain version
    is not counted as a launch."""
    port_fa.reset_launches()
    q, k, v, g = _t(*_draw(1, (1, 16, 2, 16), (1, 16, 2, 16),
                           (1, 16, 2, 16), (1, 16, 2, 16)))
    lse = torch.zeros((1, 2, 16))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        port_fa._bwd_cuda(q, k, v, g, lse, lse, 0, 0, causal=True,
                          scale=0.25)
    meta = torch.zeros((16, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_partial_bwd(meta, meta, meta, meta,
                                    torch.zeros((2, 16), device="meta"),
                                    torch.zeros((2, 16), device="meta"), 0, 0)
    tq = q.clone().requires_grad_()
    torch.autograd.grad(flash_attention(tq, k, v, causal=True).sum(), tq)
    flash_attention_partial_bwd(q, k, v, g, lse, lse, 0, 0, causal=True)
    assert port_fa.BWD_LAUNCHES == {"fused": 0, "dq": 0, "dkv": 0}


def test_partial_forward_refuses_grad():
    """The forward partial has no autograd rule (as in JAX): an input that
    requires grad is refused, not silently detached."""
    q = torch.zeros((8, 2, 16), requires_grad=True)
    with pytest.raises(NotImplementedError, match="partial_bwd"):
        flash_attention_partial(q, q, q, 0, 0)
    with torch.no_grad():
        acc, _, _ = flash_attention_partial(q, q, q, 0, 0)
    assert acc.grad_fn is None


def _views(kind):
    """q, k, v, g views of the given layout (bf16 unless named f32)."""
    bf = torch.bfloat16
    if kind == "packed_qkv":   # strided views into one [B, S, 3, H, D]
        q, k, v = torch.zeros((2, 16, 3, 2, 16), dtype=bf).unbind(2)
        return q, k, v, torch.zeros((2, 16, 2, 16), dtype=bf)
    if kind == "pointer_8_bytes":       # strides fine, start 8 bytes in
        t = torch.zeros((2, 16, 2, 24), dtype=bf)[..., 4:20]
    elif kind == "head_stride_20":      # start fine, head stride 20
        t = torch.zeros((2, 16, 2, 20), dtype=bf)[..., :16]
    elif kind == "seq_stride_36":       # start fine, seq stride 36
        t = torch.zeros((2, 16, 36), dtype=bf)[..., :32].unflatten(-1,
                                                                  (2, 16))
    elif kind == "f32_pointer_8_bytes":  # the f32 route has no such copy
        t = torch.zeros((2, 16, 2, 24))[..., 2:18]
    else:
        t = torch.zeros((2, 16, 2, 16), dtype=bf)
    return t, t, t, t


@pytest.mark.parametrize("kind,refused", [
    ("contiguous", False), ("packed_qkv", False),
    ("f32_pointer_8_bytes", False), ("pointer_8_bytes", True),
    ("head_stride_20", True), ("seq_stride_36", True)])
def test_cuda_wrapper_guards_the_16_byte_copies(kind, refused):
    """The bf16 backward kernels load tiles with 16-byte cp.async copies:
    the wrapper refuses, before its device check and without copying, a
    bf16 view that does not start on 16 bytes or whose batch, seq or head
    stride is not a multiple of 8 elements. An aligned view (packed q, k,
    v included) passes the guard and meets the device check, as does f32,
    which the CUDA-core kernels load element by element."""
    q, k, v, g = _views(kind)
    assert port_fa._async_copy_ok(q) is (kind in ("contiguous",
                                                  "packed_qkv"))
    lse = torch.zeros((2, 2, 16))
    match = "16-byte aligned" if refused else "CUDA tensors only"
    with pytest.raises(ValueError, match=match):
        port_fa._bwd_cuda(q, k, v, g, lse, lse, 0, 0, causal=True,
                          scale=0.25)
    with pytest.raises(ValueError, match=match):   # the forward too
        port_fa._fa_cuda(q, k, v, 0, 0, causal=True, scale=0.25,
                         normalize=True)
