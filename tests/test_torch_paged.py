"""The port's chunked and paged serving functions against the JAX package's.

Each of the seven functions (``_chunk_attention``, ``prefill_chunk``,
``decode_step_paged``, ``prefill_chunk_paged``, ``cache_insert_paged``,
``admit_insert_paged``, ``cow_block_copy``) runs on the same f32 inputs,
made from a numpy seed, in both packages: caches, pools and logits agree
within 1e-5 of the largest magnitude of the JAX value, tokens exactly,
and the copy-on-write exactly. The scratch block (block 0) holds pad
garbage, written in an undefined order on both sides and never read: it
is left out of the comparison. Also: a final chunk's pad tail past the
cache end never touches a real position, and in the port the paged
decode step and chunk equal the contiguous ones bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.models import transformer as jtf
from multiverso_tpu_torch.models import transformer as ttf

DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=48)
RTOL = 1e-5


@pytest.fixture(scope="module")
def models():
    jcfg = jtf.TransformerConfig(**DIMS)
    jparams = jtf.init_params(jcfg)
    tparams = ttf.params_from_jax(
        {"embed": np.asarray(jparams["embed"]),
         "pos": np.asarray(jparams["pos"]),
         "ln_f_g": np.asarray(jparams["ln_f_g"]),
         "layers": {k: np.asarray(v) for k, v in jparams["layers"].items()}},
        device="cpu")
    return jcfg, jparams, ttf.TransformerConfig(**DIMS), tparams


def _close(got, want, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= RTOL * max(np.abs(want).max(), 1e-30), (what, err)


def _t(a, dtype=torch.int64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _pool(rng, L, N, Bs, D):
    return rng.standard_normal((L, N, Bs, D)).astype(np.float32)


def test_chunk_attention_matches_jax():
    rng = np.random.default_rng(0)
    C, T, D, H = 4, 16, 32, 4
    q = rng.standard_normal((C, D)).astype(np.float32)
    k = rng.standard_normal((T, D)).astype(np.float32)
    v = rng.standard_normal((T, D)).astype(np.float32)
    for offset in (0, 5, 12):
        want = jtf._chunk_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), H, jnp.int32(offset))
        got = ttf._chunk_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), H, _t(offset))
        _close(got, want, f"offset {offset}")


@pytest.mark.parametrize("T,offset,length", [(16, 4, 3), (16, 0, 4),
                                             (11, 8, 2), (11, 8, 3)])
def test_prefill_chunk_matches_jax(models, T, offset, length):
    """(11, 8, 2) and (11, 8, 3): the final chunk's pad tail runs past
    the cache end (positions 11 and beyond), which JAX drops."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(T + offset + length)
    L, S, D, C = DIMS["n_layers"], 3, DIMS["d_model"], 4
    kc = rng.standard_normal((L, S, T, D)).astype(np.float32)
    vc = rng.standard_normal((L, S, T, D)).astype(np.float32)
    toks = np.zeros(C, np.int64)
    toks[:length] = rng.integers(1, DIMS["vocab_size"], length)
    slot = 1
    jk, jv, jl = jtf.prefill_chunk(
        jcfg, jparams, jnp.asarray(kc), jnp.asarray(vc), jnp.int32(slot),
        jnp.asarray(toks, jnp.int32), jnp.int32(offset), jnp.int32(length))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    _, _, tl = ttf.prefill_chunk(tcfg, tparams, tk, tv, _t(slot),
                                 _t(toks), _t(offset), _t(length))
    _close(tl, jl, "logits")
    for got, want, name in ((tk, jk, "k"), (tv, jv, "v")):
        _close(got, want, name)
        # the pad tail never touches a real position: the prefix and the
        # other slots are exactly as they were
        np.testing.assert_array_equal(got.numpy()[:, slot, :offset],
                                      (kc if name == "k" else vc)
                                      [:, slot, :offset])
        others = [s for s in range(S) if s != slot]
        np.testing.assert_array_equal(got.numpy()[:, others],
                                      (kc if name == "k" else vc)[:, others])


def _tables(rng, S, M, N, live_blocks):
    """Block tables with ``live_blocks[s]`` distinct blocks per slot,
    padded with the scratch block."""
    ids = rng.permutation(np.arange(1, N))
    bt = np.zeros((S, M), np.int64)
    at = 0
    for s, n in enumerate(live_blocks):
        bt[s, :n] = ids[at: at + n]
        at += n
    return bt


def test_decode_step_paged_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(1)
    L, D, Bs, S, T = DIMS["n_layers"], DIMS["d_model"], 4, 4, 14
    M = -(-T // Bs)
    N = S * M + 1
    kp, vp = _pool(rng, L, N, Bs, D), _pool(rng, L, N, Bs, D)
    bt = _tables(rng, S, M, N, [4, 2, 3, 4])
    tok = rng.integers(0, DIMS["vocab_size"], S)
    pos = np.array([13, 5, 9, 0])
    active = np.array([True, True, False, True])
    jk, jv, jn, jpos = jtf.decode_step_paged(
        jcfg, jparams, jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(bt, jnp.int32), jnp.asarray(tok, jnp.int32),
        jnp.asarray(pos, jnp.int32), jnp.asarray(active), t_logical=T)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    _, _, tn, tpos = ttf.decode_step_paged(
        tcfg, tparams, tk, tv, _t(bt), _t(tok), _t(pos),
        torch.from_numpy(active), t_logical=T)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    _close(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], "k pool")
    _close(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:], "v pool")


@pytest.mark.parametrize("offset,length", [(4, 4), (8, 3), (12, 1)])
def test_prefill_chunk_paged_matches_jax(models, offset, length):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(offset)
    L, D, Bs, S, T, C = DIMS["n_layers"], DIMS["d_model"], 4, 3, 14, 4
    M = -(-T // Bs)
    N = S * M + 1
    kp, vp = _pool(rng, L, N, Bs, D), _pool(rng, L, N, Bs, D)
    bt = _tables(rng, S, M, N, [M, 2, M])
    toks = np.zeros(C, np.int64)
    toks[:length] = rng.integers(1, DIMS["vocab_size"], length)
    slot = 2
    jk, jv, jl = jtf.prefill_chunk_paged(
        jcfg, jparams, jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(bt, jnp.int32), jnp.int32(slot),
        jnp.asarray(toks, jnp.int32), jnp.int32(offset),
        jnp.int32(length), t_logical=T)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    _, _, tl = ttf.prefill_chunk_paged(
        tcfg, tparams, tk, tv, _t(bt), _t(slot), _t(toks), _t(offset),
        _t(length), t_logical=T)
    _close(tl, jl, "logits")
    _close(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], "k pool")
    _close(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:], "v pool")


def test_cache_insert_paged_matches_jax():
    rng = np.random.default_rng(2)
    L, D, Bs, M, P = 2, 32, 4, 4, 8
    N = 3 * M + 1
    kp, vp = _pool(rng, L, N, Bs, D), _pool(rng, L, N, Bs, D)
    # row 2 is a pad row: its whole table is the scratch block; row 1's
    # reservation (1 block) is shorter than P, its tail goes to scratch
    bt = _tables(rng, 3, M, N, [2, 1, 0])
    ks = rng.standard_normal((L, 3, P, D)).astype(np.float32)
    vs = rng.standard_normal((L, 3, P, D)).astype(np.float32)
    jk, jv = jtf.cache_insert_paged(jnp.asarray(kp), jnp.asarray(vp),
                                    jnp.asarray(bt, jnp.int32),
                                    jnp.asarray(ks), jnp.asarray(vs))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    ttf.cache_insert_paged(tk, tv, _t(bt), torch.from_numpy(ks),
                           torch.from_numpy(vs))
    np.testing.assert_array_equal(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:])
    np.testing.assert_array_equal(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:])


def test_admit_insert_paged_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(3)
    L, D, Bs, M, P = DIMS["n_layers"], DIMS["d_model"], 4, 4, 8
    N = 2 * M + 1
    kp, vp = _pool(rng, L, N, Bs, D), _pool(rng, L, N, Bs, D)
    bt = _tables(rng, 2, M, N, [3, 2])
    lengths = np.array([7, 3])
    toks = np.zeros((2, P), np.int64)
    for r, n in enumerate(lengths):
        toks[r, :n] = rng.integers(1, DIMS["vocab_size"], n)
    jf, jk, jv = jtf.admit_insert_paged(
        jcfg, jparams, jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(bt, jnp.int32), jnp.asarray(toks, jnp.int32),
        jnp.asarray(lengths, jnp.int32))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tf_, _, _ = ttf.admit_insert_paged(tcfg, tparams, tk, tv, _t(bt),
                                       _t(toks), _t(lengths))
    np.testing.assert_array_equal(tf_.numpy(), np.asarray(jf))
    _close(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], "k pool")
    _close(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:], "v pool")


@pytest.mark.parametrize("src,dst", [(3, 5), (4, 4)])
def test_cow_block_copy_is_exact(src, dst):
    rng = np.random.default_rng(4)
    kp, vp = _pool(rng, 2, 7, 4, 8), _pool(rng, 2, 7, 4, 8)
    jk, jv = jtf.cow_block_copy(jnp.asarray(kp), jnp.asarray(vp),
                                jnp.int32(src), jnp.int32(dst))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    ttf.cow_block_copy(tk, tv, _t(src), _t(dst))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk.numpy()[:, dst], kp[:, src])


def _paged_copy_of(kc, bt, Bs, N, rng):
    """A random pool holding the contiguous caches' content ``kc`` [L, S,
    T, D] at the positions ``bt`` maps them to."""
    L, S, T, D = kc.shape
    pool = rng.standard_normal((L, N, Bs, D)).astype(np.float32)
    for s in range(S):
        for p in range(T):
            pool[:, bt[s, p // Bs], p % Bs] = kc[:, s, p]
    return pool


def test_paged_decode_and_chunk_bitwise_equal_contiguous(models):
    """The gathered per-slot view has the contiguous cache's shape and
    layout, so on the same K/V content the paged decode step writes the
    same bits and emits the same tokens as the contiguous one; the same
    holds for a chunk. The pools' unused positions hold other random
    values, which the masks never reach."""
    _, _, tcfg, tparams = models
    rng = np.random.default_rng(5)
    L, D, Bs, S, T = DIMS["n_layers"], DIMS["d_model"], 4, 4, 16
    M = T // Bs
    N = S * M + 3
    bt = _tables(rng, S, M, N, [M] * S)
    kc = rng.standard_normal((L, S, T, D)).astype(np.float32)
    vc = rng.standard_normal((L, S, T, D)).astype(np.float32)
    kp, vp = _paged_copy_of(kc, bt, Bs, N, rng), \
        _paged_copy_of(vc, bt, Bs, N, rng)
    tok = _t(rng.integers(0, DIMS["vocab_size"], S))
    pos = _t([15, 6, 9, 2])
    active = torch.tensor([True, True, False, True])
    ck, cv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    pk, pv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    _, _, cn, _ = ttf.decode_step(tcfg, tparams, ck, cv, tok, pos, active)
    _, _, pn, _ = ttf.decode_step_paged(tcfg, tparams, pk, pv, _t(bt), tok,
                                        pos, active, t_logical=T)
    assert torch.equal(cn, pn)
    for s in (0, 1, 3):                       # the live lanes' writes
        p = int(pos[s])
        blk, off = bt[s, p // Bs], p % Bs
        assert torch.equal(ck[:, s, p], pk[:, blk, off])
        assert torch.equal(cv[:, s, p], pv[:, blk, off])

    C, slot, offset, length = 4, 1, 8, 3
    toks = _t([5, 9, 2, 0])
    args = (_t(slot), toks, _t(offset), _t(length))
    _, _, cl = ttf.prefill_chunk(tcfg, tparams, ck, cv, *args)
    _, _, pl = ttf.prefill_chunk_paged(tcfg, tparams, pk, pv, _t(bt), *args,
                                       t_logical=T)
    assert torch.equal(cl, pl)
    for p in range(offset, offset + length):
        blk, off = bt[slot, p // Bs], p % Bs
        assert torch.equal(ck[:, slot, p], pk[:, blk, off])
