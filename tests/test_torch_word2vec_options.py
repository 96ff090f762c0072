"""The port's word2vec options against the JAX package's, on the CPU.

CBOW, hierarchical softmax (alone and with negatives), AdaGrad
(skip-gram and CBOW) and ``update_impl`` ``segsum``/``split8``, each one
step on the same tables with the same batch and the same negatives, in
f32 and bf16 tables, with row-mean off and on: the loss within 1e-5 and
the tables held by ``_assert_tables_close`` (f32 1e-5 absolute; bf16 per
row within (hits + 2) ulps). AdaGrad's accumulators within 1e-6 relative
to the largest (f32 sums of squares of grads that differ in the last
bits). Also: ``build_huffman`` bit for bit, the CBOW corpus step against
JAX's with its draws replayed, the gather compaction bit-identical to the
scatter compaction, and the flat AdaGrad learning rate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.apps import wordembedding as japp
from multiverso_tpu.models import word2vec as jw2v
from multiverso_tpu_torch.models import word2vec as tw2v
from test_torch_word2vec import (_assert_tables_close, _hits, _jax_draws,
                                 _jax_tables, _zipf_corpus,
                                 one_torch_thread, port, python_vocab)

# fixtures, imported for pytest
__all__ = ["one_torch_thread", "port", "python_vocab"]

V, D, B, K, W = 40, 16, 32, 3, 2

OPTIONS = {
    "cbow": dict(cbow=True),
    "hs": dict(hs=True, negative=0),
    "hs+neg": dict(hs=True),
    "adagrad": dict(use_adagrad=True),
    "adagrad-cbow": dict(use_adagrad=True, cbow=True),
    "hs+adagrad": dict(hs=True, use_adagrad=True),
    "segsum": dict(update_impl="segsum"),
    "split8": dict(update_impl="split8"),
}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def test_build_huffman_bit_identical():
    counts = np.random.default_rng(0).integers(1, 1000, 300)
    for L in (40, 6):                  # 6 truncates the deepest paths
        want = jw2v.build_huffman(counts, L)
        got = tw2v.build_huffman(counts, L)
        for f in ("paths", "codes", "mask"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
            assert getattr(got, f).dtype == getattr(want, f).dtype


def _batch(rng, cbow: bool):
    """Hot rows (few centers / context words) and ~20% masked slots; CBOW
    also has examples with no valid slot."""
    centers = rng.integers(0, 8, B).astype(np.int32)
    if not cbow:
        return (centers, rng.integers(0, V, B).astype(np.int32),
                (rng.random(B) > 0.2).astype(np.float32))
    contexts = rng.integers(0, V, (B, 2 * W)).astype(np.int32)
    mask = (rng.random((B, 2 * W)) > 0.3).astype(np.float32)
    mask[:3] = 0.0
    return centers, contexts, mask


@pytest.mark.parametrize("row_mean", [False, True], ids=["raw", "rowmean"])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("opt", list(OPTIONS))
def test_option_step_matches_jax(mv_session, port, opt, dt, row_mean):
    dtype = DTYPES[dt]
    opts = OPTIONS[opt]
    jw_in, jw_out = _jax_tables(mv_session, V, D, dtype, seed=2)
    tw_in, tw_out = tw2v.tables_from_jax(jw_in.get(), jw_out.get(),
                                         dtype=dtype)
    counts = np.random.default_rng(1).integers(1, 300, V).astype(np.float64)
    kw = dict(vocab_size=V, embedding_size=D, window=W, negative=K,
              batch_size=B, row_mean_updates=row_mean, row_update_cap=2.0)
    kw.update(opts)
    hj = jw2v.build_huffman(counts) if kw.get("hs") else None
    ht = tw2v.build_huffman(counts) if kw.get("hs") else None
    jm = jw2v.Word2Vec(jw2v.Word2VecConfig(**kw), jw_in, jw_out, counts, hj)
    tm = tw2v.Word2Vec(tw2v.Word2VecConfig(**kw), tw_in, tw_out, counts, ht)
    rng = np.random.default_rng(5)
    centers, contexts, mask = _batch(rng, kw.get("cbow", False))
    negs = (rng.integers(0, V, (B, K)).astype(np.int32)
            if kw["negative"] > 0 else None)
    lr = 0.05
    in_before = np.asarray(jw_in.get(), np.float32)
    out_before = np.asarray(jw_out.get(), np.float32)
    win, wout, g_in, g_out, jloss, _ = jm._raw_step(
        jw_in.array, jw_out.array, getattr(jm, "_g_in", None),
        getattr(jm, "_g_out", None), jnp.asarray(centers),
        jnp.asarray(contexts), jnp.asarray(mask), jnp.float32(lr), jm._key,
        None if negs is None else jnp.asarray(negs))
    jw_in.set_array(win)
    jw_out.set_array(wout)
    tloss = tm._raw_step(tw_in.array, tw_out.array,
                         torch.from_numpy(centers), torch.from_numpy(contexts),
                         torch.from_numpy(mask), lr,
                         None if negs is None else torch.from_numpy(negs))
    assert abs(float(tloss) - float(jloss)) < 1e-5
    in_ids = contexts if kw.get("cbow") else centers
    targets = centers if kw.get("cbow") else contexts
    out_ids = [targets] + ([negs] if negs is not None else [])
    if kw.get("hs"):
        out_ids.append(ht.paths[targets])
    _assert_tables_close(jw_in, tw_in, dtype, in_before, _hits(V, in_ids))
    _assert_tables_close(jw_out, tw_out, dtype, out_before,
                         _hits(V, *out_ids))
    if kw.get("use_adagrad"):
        for want, got in ((g_in, tm._g_in), (g_out, tm._g_out)):
            want = np.asarray(want, np.float32)[:V]
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
            assert np.abs(want).max() > 0


def test_adagrad_lr_is_flat(port):
    import multiverso_tpu_torch as mv

    w_in, w_out = mv.create_table("matrix", 8, 4), mv.create_table(
        "matrix", 8, 4)
    for adagrad, want in ((True, 0.025), (False, 0.025 * 0.5)):
        m = tw2v.Word2Vec(tw2v.Word2VecConfig(vocab_size=8,
                                              use_adagrad=adagrad),
                          w_in, w_out, counts=np.ones(8))
        m.total_words = 999
        m.set_words_trained(500)
        assert m.current_lr() == pytest.approx(want)


def _corpus_models(mv_session, tmp_path, dtype, **opts):
    corpus = _zipf_corpus(tmp_path / "c.txt")
    d = japp.Dictionary.build(corpus, min_count=1)
    jw_in, jw_out = _jax_tables(mv_session, d.vocab_size, D, dtype, seed=6)
    tw_in, tw_out = tw2v.tables_from_jax(jw_in.get(), jw_out.get(),
                                         dtype=dtype)
    counts = np.asarray(d.counts, np.float64)
    kw = dict(vocab_size=d.vocab_size, embedding_size=D, window=3,
              negative=3, batch_size=64, oversample=2.5, seed=11,
              cbow=True, row_mean_updates=True)
    kw.update(opts)
    hj = jw2v.build_huffman(counts) if kw.get("hs") else None
    ht = tw2v.build_huffman(counts) if kw.get("hs") else None
    jm = jw2v.Word2Vec(jw2v.Word2VecConfig(**kw), jw_in, jw_out, counts, hj)
    tm = tw2v.Word2Vec(tw2v.Word2VecConfig(**kw), tw_in, tw_out, counts, ht)
    ids, sents = japp.encode_corpus(corpus, d)
    discard = japp.subsample_probs(counts, 1e-2).astype(np.float32)
    return jm, tm, (jw_in, jw_out, tw_in, tw_out), ids, sents, discard


CBOW_CORPUS_CASES = {
    "ns-pool-G4-f32": (torch.float32, dict(neg_pool_size=4096,
                                           shared_negatives=4)),
    "hs-only-gather-bf16": (torch.bfloat16, dict(hs=True, negative=0,
                                                 compact_impl="gather")),
}


@pytest.mark.parametrize("case", list(CBOW_CORPUS_CASES))
def test_cbow_train_device_steps_matches_jax(mv_session, port, python_vocab,
                                             tmp_path, case):
    dtype, opts = CBOW_CORPUS_CASES[case]
    jm, tm, (jw_in, jw_out, tw_in, tw_out), ids, sents, discard = \
        _corpus_models(mv_session, tmp_path, dtype, **opts)
    jm.load_corpus_chunk(ids, sents, discard)
    tm.load_corpus_chunk(ids, sents, discard)
    jm.total_words = tm.total_words = 5000
    S, M = 2, tm._candidate_batch(ids.shape[0])
    Vt = jw_in.num_row
    for _ in range(2):
        assert tm.current_lr() == jm.current_lr()
        draws, _ = _jax_draws(jm, S, M, 64)
        assert set(draws) == ({"shrink", "u_center", "u_ctx"}
                              | ({"negs"} if jm.config.negative else set()))
        start = tm._stream_pos % ids.shape[0]
        slab = tm._ext_bufs[0].numpy()[start:start + S * M + 6]
        in_before = np.asarray(jw_in.get(), np.float32)
        out_before = np.asarray(jw_out.get(), np.float32)
        jloss, jcount = jm.train_device_steps(S)
        tloss, tcount = tm.train_device_steps(S, draws=draws)
        assert float(tcount) == float(jcount) > 0
        assert abs(float(tloss) - float(jloss)) < 1e-5
        # a slab word sits in up to 2W windows a step
        _assert_tables_close(jw_in, tw_in, dtype, in_before,
                             6 * _hits(Vt, slab))
        out_ids = [slab] + ([draws["negs"]] if "negs" in draws else [])
        if jm.config.hs:
            out_ids.append(tm._paths.numpy()[slab])
        _assert_tables_close(jw_out, tw_out, dtype, out_before,
                             _hits(Vt, *out_ids))
        if dtype == torch.bfloat16:
            tw_in.set_array(torch.from_numpy(np.asarray(jw_in.get(),
                                                        np.float32)))
            tw_out.set_array(torch.from_numpy(np.asarray(jw_out.get(),
                                                         np.float32)))


def test_compact_gather_packs_as_scatter(port):
    import multiverso_tpu_torch as mv

    w_in, w_out = mv.create_table("matrix", 8, 4), mv.create_table(
        "matrix", 8, 4)
    models = {impl: tw2v.Word2Vec(tw2v.Word2VecConfig(
        vocab_size=8, batch_size=48, compact_impl=impl), w_in, w_out,
        counts=np.ones(8)) for impl in ("scatter", "gather")}
    rng = np.random.default_rng(0)
    M = 120
    for p in (0.1, 0.4, 0.9):          # under- and overflowing the batch
        ok = torch.from_numpy(rng.random(M) < p)
        n_valid = torch.clamp(ok.sum(), max=48)
        arrays = (torch.from_numpy(rng.integers(0, 99, M).astype(np.int32)),
                  torch.from_numpy(rng.random((M, 6)) < 0.5),
                  torch.from_numpy(rng.random((M, 3)).astype(np.float32)))
        a = models["scatter"]._compact(ok, n_valid, 48, *arrays)
        b = models["gather"]._compact(ok, n_valid, 48, *arrays)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("cbow", [False, True], ids=["skipgram", "cbow"])
def test_compact_gather_trains_as_scatter(port, tmp_path, python_vocab,
                                          cbow):
    """tests/test_compact_impl.py's contract on the port: the same draws
    give the same losses and bit-identical tables."""
    import multiverso_tpu_torch as mv

    corpus = _zipf_corpus(tmp_path / "c.txt")
    d = japp.Dictionary.build(corpus, min_count=1)
    ids, sents = japp.encode_corpus(corpus, d)
    counts = np.asarray(d.counts, np.float64)
    runs = []
    for impl in ("scatter", "gather"):
        cfg = tw2v.Word2VecConfig(vocab_size=d.vocab_size, embedding_size=8,
                                  negative=3, batch_size=64, seed=11,
                                  oversample=2.0, cbow=cbow,
                                  compact_impl=impl)
        w_in = mv.create_table("matrix", d.vocab_size, 8,
                               init_value="random", seed=9)
        w_out = mv.create_table("matrix", d.vocab_size, 8)
        m = tw2v.Word2Vec(cfg, w_in, w_out, counts=counts)
        m.load_corpus_chunk(ids, sents, np.zeros(d.vocab_size, np.float32))
        losses = [float(m.train_device_steps(2)[0]) for _ in range(3)]
        runs.append((losses, w_in.get(), w_out.get()))
    (la, ia, oa), (lb, ib, ob) = runs
    assert la == lb
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(oa, ob)
