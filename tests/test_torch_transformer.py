"""The port's transformer serving math against the JAX package's, on the CPU.

Same weights in both packages (``init_params`` draws the same numpy
stream; ``params_from_jax`` carries the JAX pytree across), same token
inputs from a seeded numpy generator. f32 throughout; tolerance 1e-4 on
logits and K/V. Greedy comparisons also assert that every compared
argmax has a top-2 logit gap well above that tolerance, so a near-tie
cannot make them flaky.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.models import transformer as jtf
from multiverso_tpu_torch.models import transformer as ttf

DIMS = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq=48)
TOL = dict(rtol=1e-4, atol=1e-4)
GAP = 1e-3


def _cfgs(attention="reference", seed=0):
    return (jtf.TransformerConfig(**DIMS, attention=attention, seed=seed),
            ttf.TransformerConfig(**DIMS, attention=attention, seed=seed))


def _params(seed=0):
    jcfg, tcfg = _cfgs(seed=seed)
    jparams = jtf.init_params(jcfg)
    host = jax.tree.map(np.asarray, jparams)
    return jparams, ttf.params_from_jax(host, device="cpu")


def _prompts(lengths, P, seed):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lengths), P), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(0, DIMS["vocab_size"], n)
    return toks


def _assert_gaps(logits: np.ndarray):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    gaps = top2[..., 1] - top2[..., 0]
    assert gaps.min() > GAP, f"near-tie: top-2 gap {gaps.min()}"


def test_init_params_match_jax():
    jparams, from_jax = _params(seed=3)
    _, tcfg = _cfgs(seed=3)
    mine = ttf.init_params(tcfg, device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == 11
    for key in ("embed", "pos", "ln_f_g"):
        assert torch.equal(mine[key], from_jax[key])
        np.testing.assert_array_equal(mine[key].numpy(),
                                      np.asarray(jparams[key]))
    for key, w in mine["layers"].items():
        assert torch.equal(w, from_jax["layers"][key])
        np.testing.assert_array_equal(w.numpy(),
                                      np.asarray(jparams["layers"][key]))


@pytest.mark.parametrize("attention", ["reference", "flash_force"])
def test_prefill_matches_jax(attention):
    jcfg, tcfg = _cfgs(attention)
    jparams, tparams = _params()
    toks = _prompts([16, 9, 1], 16, seed=1)
    jl, jk, jv = jtf.prefill(jcfg, jparams, jnp.asarray(toks))
    tl, tk, tv = ttf.prefill(tcfg, tparams, torch.from_numpy(toks).long())
    assert tl.dtype == torch.float32 and tl.shape == (3, 16, 64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_decode_step_matches_jax():
    jcfg, tcfg = _cfgs()
    jparams, tparams = _params()
    S, T, L, D = 3, 24, DIMS["n_layers"], DIMS["d_model"]
    toks = _prompts([8, 5, 8], 8, seed=2)
    lengths = np.array([8, 5, 8], np.int32)
    _, ks, vs = jtf.prefill(jcfg, jparams, jnp.asarray(toks))
    jk = jnp.zeros((L, S, T, D)).at[:, :, :8].set(ks)
    jv = jnp.zeros((L, S, T, D)).at[:, :, :8].set(vs)
    tok = np.array([3, 7, 11], np.int32)
    active = np.array([True, True, False])
    jk2, jv2, jn, jp = jtf.decode_step(jcfg, jparams, jk, jv,
                                       jnp.asarray(tok),
                                       jnp.asarray(lengths),
                                       jnp.asarray(active))
    tk = torch.from_numpy(np.array(jk))
    tv = torch.from_numpy(np.array(jv))
    tk2, tv2, tn, tp = ttf.decode_step(
        tcfg, tparams, tk, tv, torch.from_numpy(tok).long(),
        torch.from_numpy(lengths).long(), torch.from_numpy(active))
    np.testing.assert_allclose(tk2.numpy(), np.asarray(jk2), **TOL)
    np.testing.assert_allclose(tv2.numpy(), np.asarray(jv2), **TOL)
    assert tn.tolist() == np.asarray(jn).tolist()
    assert tp.tolist() == np.asarray(jp).tolist() == [9, 6, 8]
    # the live lanes' next tokens are not near-ties: teacher-force the
    # sequence through prefill and read the step's logits at ``pos``
    full = np.zeros((2, 9), np.int32)
    for i in range(2):
        n = int(lengths[i])
        full[i, :n] = toks[i, :n]
        full[i, n] = tok[i]
    logits = ttf.prefill(tcfg, tparams, torch.from_numpy(full).long())[0]
    _assert_gaps(np.stack([logits[i, int(lengths[i])].numpy()
                           for i in range(2)]))


@pytest.mark.parametrize("attention", ["reference", "flash_force"])
@pytest.mark.parametrize("use_eos", [False, True])
def test_greedy_decode_token_identical_to_jax(attention, use_eos):
    jcfg, tcfg = _cfgs(attention)
    jparams, tparams = _params()
    lengths = np.array([12, 4, 7, 1], np.int32)
    toks = _prompts(lengths, 12, seed=4)
    max_new = 10
    eos_id = None
    if use_eos:
        # an eos the generation really emits: row 0's fourth token
        eos_id = int(np.asarray(jtf.greedy_decode(
            jcfg, jparams, jnp.asarray(toks), jnp.asarray(lengths),
            max_new))[0, 3])
    want = np.asarray(jtf.greedy_decode(jcfg, jparams, jnp.asarray(toks),
                                        jnp.asarray(lengths), max_new,
                                        eos_id=eos_id))
    got = ttf.greedy_decode(tcfg, tparams, torch.from_numpy(toks).long(),
                            torch.from_numpy(lengths).long(), max_new,
                            eos_id=eos_id).numpy()
    np.testing.assert_array_equal(got, want)
    # every emitted token's argmax had a clear margin
    for i, n in enumerate(lengths):
        seq = np.concatenate([toks[i, :n], got[i, :-1]])[None]
        logits = ttf.prefill(tcfg, tparams, torch.from_numpy(seq).long())[0]
        live = len(got[i]) if eos_id is None else (
            list(got[i]).index(eos_id) + 1 if eos_id in got[i]
            else len(got[i]))
        _assert_gaps(logits[0, n - 1: n - 1 + live].numpy())
    if eos_id is not None:
        hit = [i for i in range(len(lengths)) if eos_id in got[i]]
        assert hit
        for i in hit:           # frozen after eos: pad zeros
            j = list(got[i]).index(eos_id)
            assert not got[i, j + 1:].any()


def test_greedy_decode_engine_geometry_is_invisible():
    """Padding the decode batch to a slot count and the cache to a longer
    length changes no token (the engine's geometry, used as the oracle on
    the card)."""
    _, tcfg = _cfgs()
    _, tparams = _params()
    lengths = torch.tensor([6, 3])
    toks = torch.from_numpy(_prompts([6, 3], 8, seed=6)).long()
    plain = ttf.greedy_decode(tcfg, tparams, toks, lengths, 8)
    padded = ttf.greedy_decode(tcfg, tparams, toks, lengths, 8, slots=4,
                               cache_len=30)
    assert torch.equal(plain, padded)


def test_cache_insert_row_zero_wins():
    """Pad rows pointing at ``slots[0]`` are overwritten by row 0."""
    kc = torch.zeros((1, 3, 6, 2))
    vc = torch.zeros((1, 3, 6, 2))
    ks = torch.stack([torch.full((1, 4, 2), float(i + 1))
                      for i in range(3)], dim=1)
    ttf.cache_insert(kc, vc, [2, 0, 2], ks, ks.clone())
    assert torch.all(kc[0, 2, :4] == 1) and torch.all(kc[0, 0, :4] == 2)
    assert torch.all(kc[0, 1] == 0) and torch.all(kc[0, :, 4:] == 0)


def test_params_default_to_the_session_device():
    """``init_params`` / ``params_from_jax`` run on the session's device (the
    card unless ``-device=cpu``); with no session and no device they
    refuse instead of quietly choosing the CPU."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.log import FatalError
    from multiverso_tpu_torch.runtime import Session

    _, tcfg = _cfgs()
    host = jax.tree.map(np.asarray, jtf.init_params(_cfgs()[0]))
    Session._instance = None
    try:
        with pytest.raises(FatalError, match="device="):
            ttf.init_params(tcfg)
        with pytest.raises(FatalError, match="device="):
            ttf.params_from_jax(host)
        mv.init(["test", "-device=cpu"])
        assert ttf.init_params(tcfg)["embed"].device.type == "cpu"
        assert ttf.params_from_jax(host)["pos"].device.type == "cpu"
        mv.shutdown()
    finally:
        Session._instance = None
        mv.set_flag("device", "cuda")
