"""int8 KV pools and int8 parameter pins in the port, held to the JAX
package on the CPU.

Each ``_q`` function of ``models/transformer.py`` runs on the same int8
pools, fp32 scales and f32 parameters (numpy-seeded) in both packages:
scales within rtol 1e-6, int8 codes equal on at least 99.99% of elements
and never more than 1 apart (a row whose value lands on a rounding edge
may round the other way after the two packages' f32 matmuls differ in
the last bit), the dequantized pools within one scale step, next tokens
identical. The scratch block (block 0) takes pad writes in an undefined
order on both sides and is never read: it is left out. Then the engine
half of ``tests/test_quant_serving.py``: an int8 engine against its fp
engine (argmax-match rate >= 0.7, as in JAX; one signature per program;
the quant stats keys), the plain stats surface without them, the
refusal of contiguous KV, the int8 pin memoized per version and
``quantize_decode_params`` bitwise equal to JAX's (both host numpy), and
``kv_bytes_per_block(quant="int8")``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.models import transformer as jtf
from multiverso_tpu_torch.models import transformer as ttf
from multiverso_tpu_torch.serving import InferenceServer

DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=48)
L, D, BS = DIMS["n_layers"], DIMS["d_model"], 4


@pytest.fixture()
def port():
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.dashboard import Dashboard
    from multiverso_tpu_torch.runtime import Session

    Session._instance = None
    Dashboard.reset()
    mv.init(["test", "-device=cpu"])
    yield mv
    mv.shutdown()
    Dashboard.reset()
    Session._instance = None
    mv.set_flag("device", "cuda")


@pytest.fixture(scope="module")
def models():
    jcfg = jtf.TransformerConfig(**DIMS)
    jparams = jtf.init_params(jcfg)
    host = {"embed": np.asarray(jparams["embed"]),
            "pos": np.asarray(jparams["pos"]),
            "ln_f_g": np.asarray(jparams["ln_f_g"]),
            "layers": {k: np.asarray(v)
                       for k, v in jparams["layers"].items()}}
    return (jcfg, jparams, ttf.TransformerConfig(**DIMS),
            ttf.params_from_jax(host, device="cpu"), host)


def _argmax_match(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    n, m = min(a.size, b.size), max(a.size, b.size)
    return float((a[:n] == b[:n]).sum()) / m if m else 1.0


def _state(rng, N):
    """int8 pools with per-(layer, block) scales; every fourth block never
    written (scale 0, zero codes)."""
    pools = [rng.integers(-127, 128, (L, N, BS, D)).astype(np.int8)
             for _ in range(2)]
    scales = [np.abs(rng.standard_normal((L, N))).astype(np.float32) / 40
              for _ in range(2)]
    for p, s in zip(pools, scales):
        s[:, ::4] = 0.0
        p[:, ::4] = 0
    return pools, scales


def _tables(rng, S, M, N, live):
    ids = rng.permutation(np.arange(1, N))
    bt = np.zeros((S, M), np.int64)
    at = 0
    for s, n in enumerate(live):
        bt[s, :n] = ids[at: at + n]
        at += n
    return bt


def _held(got_pools, got_scales, want_pools, want_scales, what):
    """The tolerance of the module docstring, block 0 left out."""
    for gq, gs, wq, ws, name in zip(got_pools, got_scales, want_pools,
                                    want_scales, ("k", "v")):
        gq = np.asarray(gq)[:, 1:].astype(np.int32)
        wq = np.asarray(wq)[:, 1:].astype(np.int32)
        gs = np.asarray(gs)[:, 1:]
        ws = np.asarray(ws)[:, 1:]
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0,
                                   err_msg=f"{what} {name} scales")
        diff = np.abs(gq - wq)
        assert diff.max() <= 1, (what, name, diff.max())
        assert (diff == 0).mean() >= 0.9999, (what, name,
                                             (diff == 0).mean())
        deq = np.abs(gq * gs[..., None, None] - wq * ws[..., None, None])
        assert (deq <= ws[..., None, None] * (1 + 1e-6) + 1e-30).all(), \
            (what, name)


def _run(fn_name, models):
    """``(port outputs, jax outputs)`` of one ``_q`` function on one
    numpy-seeded input set."""
    jcfg, jp, tcfg, tp, _ = models
    rng = np.random.default_rng(len(fn_name))
    S, T = 4, 18
    M = -(-T // BS)
    N = S * M + 1
    (kp, vp), (ks, vs) = _state(rng, N)
    bt = _tables(rng, S, M, N, [M, M, 3, M])
    tj = lambda a: jnp.asarray(a)                     # noqa: E731
    tt = lambda a: torch.from_numpy(np.array(a))      # noqa: E731
    ji = lambda a: jnp.asarray(np.asarray(a), jnp.int32)   # noqa: E731
    pools = (kp, vp, ks, vs)
    if fn_name == "decode_step_paged_q":
        tok = rng.integers(1, DIMS["vocab_size"], S)
        # offsets 0 (a fresh block), mid-block, a block's last row; a dead
        # lane parks on scratch
        pos = np.array([8, 13, 7, 0])
        active = np.array([True, True, True, False])
        want = jtf.decode_step_paged_q(
            jcfg, jp, *map(tj, pools), ji(bt), ji(tok), ji(pos),
            tj(active), t_logical=T)
        got = ttf.decode_step_paged_q(
            tcfg, tp, *map(tt, pools), tt(bt), tt(tok), tt(pos),
            tt(active), t_logical=T)
        return got[:4], want[:4], (got[4], want[4])
    if fn_name == "prefill_chunk_paged_q":
        C, off, n = 4, 8, 3
        toks = np.zeros(C, np.int64)
        toks[:n] = rng.integers(1, DIMS["vocab_size"], n)
        want = jtf.prefill_chunk_paged_q(
            jcfg, jp, *map(tj, pools), ji(bt), jnp.int32(1), ji(toks),
            jnp.int32(off), jnp.int32(n), t_logical=T)
        got = ttf.prefill_chunk_paged_q(
            tcfg, tp, *map(tt, pools), tt(bt), torch.tensor(1), tt(toks),
            torch.tensor(off), torch.tensor(n), t_logical=T)
        return got[:4], want[:4], (torch.argmax(got[4]),
                                   jnp.argmax(want[4]))
    if fn_name == "verify_step_paged_q":
        K1 = 4
        toks = rng.integers(1, DIMS["vocab_size"], (S, K1))
        pos = np.array([5, 11, 7, 0])
        active = np.array([True, True, True, False])
        n_valid = np.array([4, 2, 1, 1])
        want = jtf.verify_step_paged_q(
            jcfg, jp, *map(tj, pools), ji(bt), ji(toks), ji(pos),
            tj(active), ji(n_valid), t_logical=T)
        got = ttf.verify_step_paged_q(
            tcfg, tp, *map(tt, pools), tt(bt), tt(toks), tt(pos),
            tt(active), tt(n_valid), t_logical=T)
        return got[:4], want[:4], (got[4], want[4])
    if fn_name in ("cache_insert_paged_q", "admit_insert_paged_q"):
        b, P = 2, 12
        rows = bt[:b]
        if fn_name == "cache_insert_paged_q":
            kv = [rng.standard_normal((L, b, P, D)).astype(np.float32)
                  for _ in range(2)]
            want = jtf.cache_insert_paged_q(*map(tj, pools), ji(rows),
                                            *map(tj, kv))
            got = ttf.cache_insert_paged_q(*map(tt, pools), tt(rows),
                                           *map(tt, kv))
            return got, want, None
        toks = rng.integers(1, DIMS["vocab_size"], (b, P))
        lens = np.array([12, 7])
        want = jtf.admit_insert_paged_q(jcfg, jp, *map(tj, pools),
                                        ji(rows), ji(toks), ji(lens))
        got = ttf.admit_insert_paged_q(tcfg, tp, *map(tt, pools),
                                       tt(rows), tt(toks), tt(lens))
        return got[1:], want[1:], (got[0], want[0])
    assert fn_name == "cow_block_copy_q"
    src, dst = int(bt[0, 1]), int(bt[3, 2])
    want = jtf.cow_block_copy_q(*map(tj, pools), jnp.int32(src),
                                jnp.int32(dst))
    got = ttf.cow_block_copy_q(*map(tt, pools), torch.tensor(src),
                               torch.tensor(dst))
    return got, want, None


@pytest.mark.parametrize("fn_name", [
    "decode_step_paged_q", "prefill_chunk_paged_q", "verify_step_paged_q",
    "cache_insert_paged_q", "admit_insert_paged_q", "cow_block_copy_q"])
def test_q_function_matches_jax(models, fn_name):
    got, want, tokens = _run(fn_name, models)
    _held(got[:2], got[2:4], want[:2], want[2:4], fn_name)
    if tokens is not None:
        np.testing.assert_array_equal(np.asarray(tokens[0]),
                                      np.asarray(tokens[1]))
    if fn_name == "cow_block_copy_q":
        # the copy is exact: bytes and scale columns
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_requant_rounds_half_to_even_by_division():
    """Rows divide by the scale and round half to even, as JAX's
    ``jnp.round(rows / scale)``: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, clipped at
    127; a zero scale divides by 1."""
    rows = np.array([[[0.5, 1.5, 2.5, -0.5, -1.5, 300.0, -300.0, 3.0]]],
                    np.float32)
    for scale in (np.array([1.0], np.float32), np.array([0.0], np.float32)):
        got = ttf._kv_q_requant(torch.from_numpy(rows),
                                torch.from_numpy(scale))
        want = jtf._kv_q_requant(jnp.asarray(rows), jnp.asarray(scale))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            got.numpy()[0, 0], [0, 2, 2, 0, -2, 127, -127, 3])


def _serve(eng, prompts, max_new):
    return [np.asarray(eng.submit(p, max_new).result(timeout=120)["result"])
            for p in prompts]


def test_kv_quant_engine_quality_and_invariants(port):
    lm = ttf.TransformerLM(ttf.TransformerConfig(**DIMS))
    srv = InferenceServer("t")
    kw = dict(slots=2, max_prompt=16, max_new=8, kv_block_size=4,
              prefill_token_budget=4, prefix_cache=True, watchdog=False)
    fp = srv.register_decoder("fp", lm, **kw)
    q = srv.register_decoder("q", lm, kv_quant="int8", **kw)
    fp.warmup()
    q.warmup()
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, DIMS["vocab_size"], int(n)).astype(np.int32)
               for n in (8, 10, 3, 12, 5)]
    fp_out = _serve(fp, prompts, 6)
    q_out = _serve(q, prompts, 6)
    rates = [_argmax_match(a, b) for a, b in zip(fp_out, q_out)]
    rate = float(np.mean(rates))
    assert rate >= 0.7, rates
    q.record_argmax_match(rate)
    st = q.stats()
    assert st["kv_quant"] == "int8"
    assert st["argmax_match_rate"] == pytest.approx(rate)
    assert st["quant_scale_blocks"] > 0
    assert st["decode_step_retraces"] == 0
    assert st["step_traces"] == 1
    assert st["prefill_traces"] == 1
    assert st["pin_copies"] == 1
    assert st["kv_bytes_per_device"] < fp.stats()["kv_bytes_per_device"] / 3
    assert q._k_cache.dtype == torch.int8
    assert q._k_scales.shape == (L, q._pool.capacity + 1)
    q._pool.check()
    assert q.pool_drift() is None


def test_kv_quant_off_stats_surface_unchanged(port):
    lm = ttf.TransformerLM(ttf.TransformerConfig(**DIMS))
    srv = InferenceServer("t")
    eng = srv.register_decoder(
        "plain", lm, slots=2, max_prompt=16, max_new=4, kv_block_size=4,
        prefill_token_budget=4, watchdog=False)
    st = eng.stats()
    for key in ("kv_quant", "quant_scale_blocks", "argmax_match_rate",
                "decode_param_quant"):
        assert key not in st


def test_kv_quant_rejects_contiguous_cache(port):
    from multiverso_tpu_torch.log import FatalError

    lm = ttf.TransformerLM(ttf.TransformerConfig(**DIMS))
    srv = InferenceServer("t")
    with pytest.raises(FatalError, match="kv_quant"):
        srv.register_decoder("bad", lm, slots=2, max_prompt=16,
                             max_new=4, kv_block_size=0,
                             kv_quant="int8", watchdog=False)


def test_param_quant_pin_memoized_and_serving(port):
    lm = ttf.TransformerLM(ttf.TransformerConfig(**DIMS))
    srv = InferenceServer("t")
    kw = dict(slots=2, max_prompt=16, max_new=8, kv_block_size=4,
              prefill_token_budget=4, watchdog=False)
    fp = srv.register_decoder("fp2", lm, **kw)
    pq = srv.register_decoder("pq", lm, decode_param_quant="int8", **kw)
    fp.warmup()
    pq.warmup()
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, DIMS["vocab_size"], int(n)).astype(np.int32)
               for n in (8, 5, 11)]
    fp_out = _serve(fp, prompts, 6)
    pq_out = _serve(pq, prompts, 6)       # wave 1
    _serve(pq, prompts, 6)                # wave 2: same pin
    rate = float(np.mean(
        [_argmax_match(a, b) for a, b in zip(fp_out, pq_out)]))
    assert rate >= 0.7
    st = pq.stats()
    assert st["decode_param_quant"] == "int8"
    assert st["pin_copies"] == 1
    assert st["decode_step_retraces"] == 0
    assert st["step_traces"] == 1
    # the int8 copy is what stays pinned
    assert pq._pinned["layers"]["w_q"]["q"].dtype == torch.int8


def test_quantize_decode_params_bitwise_equal_to_jax(models):
    from multiverso_tpu.serving.snapshot import \
        quantize_decode_params as jquant
    from multiverso_tpu_torch.serving.snapshot import quantize_decode_params

    _, _, _, tp, host = models
    want = jquant(host)
    got = quantize_decode_params(tp)
    for key in ("embed", "pos", "ln_f_g"):
        for part in ("q", "s"):
            np.testing.assert_array_equal(got[key][part].numpy(),
                                          want[key][part])
    for name, leaf in want["layers"].items():
        for part in ("q", "s"):
            g = got["layers"][name][part].numpy()
            assert g.dtype == leaf[part].dtype
            np.testing.assert_array_equal(g, leaf[part])
    # per output column for matrices, per tensor for vectors
    assert got["layers"]["w_q"]["s"].shape == (L, 1, D)
    assert got["ln_f_g"]["s"].shape == (1,)
    deq = ttf.dequantize_decode_params(got)
    jdeq = jtf.dequantize_decode_params(want)
    np.testing.assert_array_equal(deq["layers"]["w_ff1"].numpy(),
                                  np.asarray(jdeq["layers"]["w_ff1"]))


def test_kv_bytes_per_block_int8_matches_jax():
    from multiverso_tpu.serving import block_pool as jbp
    from multiverso_tpu_torch.serving import block_pool as tbp

    for quant in ("none", "int8"):
        got = tbp.kv_bytes_per_block(12, 768, 8, torch.bfloat16,
                                     quant=quant)
        want = jbp.kv_bytes_per_block(12, 768, 8, np.dtype("float16"),
                                      quant=quant)
        assert got == want
        assert tbp.blocks_for_bytes(10 ** 8, 12, 768, 8, torch.bfloat16,
                                    quant=quant) == \
            jbp.blocks_for_bytes(10 ** 8, 12, 768, 8, np.dtype("float16"),
                                 quant=quant)
    assert tbp.kv_bytes_per_block(2, 32, 4, quant="int8") \
        == 2 * 2 * (4 * 32 + 4)
