"""The port's host-stream word2vec trainer against the JAX package's, on the
CPU.

The example builders (``_pairs_from_chunk``, ``_cbow_from_chunk``) and
``iter_pair_batches`` must yield the JAX package's batches bit for bit
(the same numpy ``default_rng`` draws), progress counts and padded tail
included; ``prefetch_iterator`` keeps the producer's order and raises its
exceptions at the consumer. HS-only training through ``train(...,
device_corpus=False)`` draws no negatives, so both packages train the same
batches from the same tables: the saved f32 embeddings (6 decimals) agree
within 1e-5. Last, the port's copy of JAX's
``test_word2vec_learns_cooccurrence`` for every objective and update.
"""

import threading

import numpy as np
import pytest

from multiverso_tpu.apps import wordembedding as japp
from multiverso_tpu.models import word2vec as jw2v
from multiverso_tpu.parallel import prefetch_iterator as jprefetch
from multiverso_tpu_torch.apps import wordembedding as tapp
from multiverso_tpu_torch.models import word2vec as tw2v
from multiverso_tpu_torch.parallel import prefetch_iterator
from test_torch_word2vec import (_toy_corpus, _zipf_corpus,
                                 one_torch_thread, port, python_vocab)

# fixtures, imported for pytest
__all__ = ["one_torch_thread", "port", "python_vocab"]


def _chunk(seed=0, n=500, vocab=30):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, n).astype(np.int32)
    sents = np.repeat(np.arange(n // 25), 25).astype(np.int32)[:n]
    return ids, sents


@pytest.mark.parametrize("n", [0, 1, 2, 500])
def test_example_builders_bit_identical(n):
    ids, sents = _chunk()
    ids, sents = ids[:n], sents[:n]
    for port_fn, jax_fn in ((tapp._pairs_from_chunk, japp._pairs_from_chunk),
                            (tapp._cbow_from_chunk, japp._cbow_from_chunk)):
        for window in (1, 5):
            got = port_fn(ids, sents, window, np.random.default_rng(3))
            want = jax_fn(ids, sents, window, np.random.default_rng(3))
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cbow", [False, True], ids=["skipgram", "cbow"])
def test_iter_pair_batches_bit_identical(tmp_path, cbow):
    corpus = _zipf_corpus(tmp_path / "c.txt", n_words=4000)
    d = tapp.Dictionary.build(corpus, min_count=1)
    kw = dict(window=3, batch_size=96, sample=1e-2, seed=5, cbow=cbow,
              chunk_words=700)
    tp, jp = {}, {}
    got = list(tapp.iter_pair_batches(corpus, d, progress=tp, **kw))
    want = list(japp.iter_pair_batches(corpus, d, progress=jp, **kw))
    assert len(got) == len(want) > 3
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    assert tp == jp == {"words": 4000}
    # the padded tail: masked slots of id 0 after the last example
    tail_mask = got[-1][2]
    assert 0 < np.count_nonzero(tail_mask.reshape(96, -1).any(axis=1)) < 96
    assert not tail_mask[-1].any() and not got[-1][0][-1]


def test_prefetch_iterator_order_and_errors():
    assert list(prefetch_iterator(iter(range(100)), depth=3)) == list(
        range(100))

    def failing():
        yield 1
        yield 2
        raise ValueError("producer broke")

    seen = []
    with pytest.raises(ValueError, match="producer broke"):
        for x in prefetch_iterator(failing(), depth=1):
            seen.append(x)
    assert seen == [1, 2]
    # the JAX package's loader does the same
    jseen = []
    with pytest.raises(ValueError, match="producer broke"):
        for x in jprefetch(failing(), depth=1):
            jseen.append(x)
    assert jseen == seen

    # an abandoned consumer stops the producer (no thread left blocked)
    closed = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.set()

    it = prefetch_iterator(endless(), depth=2)
    assert [next(it) for _ in range(5)] == list(range(5))
    it.close()
    assert closed.wait(timeout=10)


def _read_vectors(path):
    with open(path) as f:
        header = f.readline().split()
        rows = {p[0]: np.asarray(p[1:], np.float64)
                for p in (line.split() for line in f)}
    return header, rows


def test_hs_host_train_matches_jax(mv_session, port, python_vocab, tmp_path):
    """HS-only, f32, host stream (groups of 4 through train_batches and the
    tail one at a time): the same batches and no random draws in the step,
    so the two trainers agree to f32 summation order."""
    corpus = _zipf_corpus(tmp_path / "c.txt")
    kw = dict(embedding_size=16, window=2, negative=0, hs=True,
              init_lr=0.05, batch_size=64, seed=3, steps_per_call=4)
    res = {}
    for name, app, w2v in (("jax", japp, jw2v), ("port", tapp, tw2v)):
        out = str(tmp_path / f"{name}_in.txt")
        ctx = str(tmp_path / f"{name}_out.txt")
        r = app.train(corpus, out, w2v.Word2VecConfig(**kw), epochs=2,
                      min_count=1, sample=1e-2, log_every=0,
                      device_corpus=False, output_path_ctx=ctx)
        res[name] = (r, _read_vectors(out), _read_vectors(ctx))
    (jr, jin, jout), (tr, tin, tout) = res["jax"], res["port"]
    assert tr.words_trained == jr.words_trained == 6000
    assert tr.pairs_trained == jr.pairs_trained > 0
    assert abs(tr.final_loss - jr.final_loss) < 1e-5
    for (th, trows), (jh, jrows) in ((tin, jin), (tout, jout)):
        assert th == jh and list(trows) == list(jrows)
        got = np.stack(list(trows.values()))
        want = np.stack(list(jrows.values()))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # training moved the output table off its zero init
    assert np.abs(np.stack(list(tout[1].values()))).max() > 1e-3


@pytest.mark.parametrize("mode", ["neg", "hs", "adagrad", "cbow", "hs+neg"])
def test_word2vec_learns_cooccurrence(port, tmp_path, mode):
    """tests/test_word2vec.py's check on the port: a 1,200-token corpus
    streams from the host (the auto rule), and in-cluster similarity beats
    cross-cluster."""
    corpus = _toy_corpus(tmp_path)
    cfg = tw2v.Word2VecConfig(
        embedding_size=16, window=2,
        negative=0 if mode == "hs" else 3,
        hs=(mode in ("hs", "hs+neg")), use_adagrad=(mode == "adagrad"),
        cbow=(mode == "cbow"), init_lr=0.03, batch_size=128, seed=3)
    out = str(tmp_path / f"vec_{mode}.txt")
    result = tapp.train(corpus, out, cfg, epochs=3, min_count=1, sample=0,
                        log_every=0)
    assert result.words_trained == 3600 and result.pairs_trained > 0
    header, vecs = _read_vectors(out)
    assert header == ["6", "16"]

    def sim(a, b):
        va, vb = vecs[a], vecs[b]
        return va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb) + 1e-9)

    in_cluster = np.mean([sim("a", "b"), sim("b", "c"), sim("x", "y"),
                          sim("y", "z")])
    cross = np.mean([sim("a", "x"), sim("b", "y"), sim("c", "z")])
    assert in_cluster > cross, (mode, in_cluster, cross)
