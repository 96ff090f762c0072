"""The port's word2vec against the JAX package's, on the CPU.

Same tables (``tables_from_jax`` carries the JAX tables' values across),
same batches and the same random draws (the JAX draws are replayed from
the model's key and injected into the port), so the two trainers must
agree. Tolerances: float32 tables 1e-5 absolute on values of order 1e-2
(summation order of the f32 scores and of duplicate scatter-adds); loss
1e-5; bfloat16 tables per row within (hits + 2) bf16 ulps of the row's
magnitude (see ``_assert_tables_close``). Also: the numpy helpers
bit for bit, the dictionary and corpus encoding, the app's training on a
toy corpus, the options that still raise, and the bench's CPU run.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.apps import wordembedding as japp
from multiverso_tpu.models import word2vec as jw2v
from multiverso_tpu_torch.apps import wordembedding as tapp
from multiverso_tpu_torch.log import FatalError
from multiverso_tpu_torch.models import word2vec as tw2v

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_ATOL = 1e-5


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
    Session._instance = None
    mv.set_flag("device", "cuda")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU steps are many small ops: with the suite's parallel
    workers each running torch's full thread pool, every parallel region
    waits for descheduled threads. One thread a test, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def python_vocab(monkeypatch):
    """The JAX Dictionary without its native library: the Python build the
    port copies (the native one breaks count ties by spelling)."""
    import multiverso_tpu.native as native

    monkeypatch.setattr(native, "available", lambda: False)


def _zipf_corpus(path, n_words=3000, vocab=60, seed=0):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    words = rng.choice(vocab, size=n_words, p=p / p.sum())
    lines = [" ".join(f"w{w}" for w in words[i:i + 40])
             for i in range(0, n_words, 40)]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _assert_tables_close(jtab, ttab, dtype, before=None, hits=None):
    """f32: 1e-5 absolute. bf16: both sides round after every scatter add,
    but the f32 deltas they round come from products summed in another
    order, so a delta may round to the other bf16 neighbour and a row hit h
    times may differ by up to h half-ulps plus a rounding of each side:
    held per row at (hits + 2) ulps of the row's largest magnitude (before
    or after)."""
    want = np.asarray(jtab.get(), np.float32)
    got = ttab.get()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
        return
    mag = np.max(np.maximum(np.maximum(np.abs(before), np.abs(want)),
                            np.abs(got)), axis=1, keepdims=True)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    excess = np.abs(got - want) / ((hits[:, None] + 2) * ulp)
    assert excess.max() <= 1.0, excess.max()


def _hits(V, *id_arrays):
    return sum(np.bincount(np.asarray(a).ravel(), minlength=V)
               for a in id_arrays).astype(np.float64)


def _jax_tables(mv, vocab, dim, dtype, seed):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    w_in = mv.create_table("matrix", vocab, dim, init_value="random",
                           seed=seed, dtype=jdt)
    w_out = mv.create_table("matrix", vocab, dim, dtype=jdt)
    # give w_out nonzero rows so the first step's scores are not all 0
    rng = np.random.default_rng(seed + 1)
    w_out.add((rng.standard_normal((vocab, dim)) * 0.05).astype(np.float32))
    return w_in, w_out


def test_alias_pool_and_packing_bit_identical():
    counts = np.random.default_rng(0).integers(1, 500, 97).astype(np.float64)
    jt, ja = jw2v.build_unigram_alias(counts)
    tt, ta = tw2v.build_unigram_alias(counts)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(
        tw2v.build_negative_pool(tt, ta, 5000, seed=3),
        jw2v.build_negative_pool(jt, ja, 5000, seed=3))
    np.testing.assert_array_equal(
        tw2v.pack_alias_table(tt, ta).numpy(),
        np.asarray(jw2v.pack_alias_table(jnp.asarray(jt), jnp.asarray(ja))))


def test_alias_and_pool_draws_follow_the_law():
    counts = np.array([100, 10, 1], np.float64)
    thresh, alias = tw2v.build_unigram_alias(counts)
    gen = torch.Generator().manual_seed(0)
    expect = counts ** 0.75 / (counts ** 0.75).sum()
    s = tw2v.sample_negatives(gen, tw2v.pack_alias_table(thresh, alias),
                              (20000,))
    assert s.dtype == torch.int32
    np.testing.assert_allclose(np.bincount(s.numpy(), minlength=3) / 20000,
                               expect, atol=0.02)
    pool = torch.from_numpy(tw2v.build_negative_pool(thresh, alias, 50000))
    a = tw2v.pool_negatives(gen, pool, (64, 5))
    b = tw2v.pool_negatives(gen, pool, (64, 5))
    assert a.shape == (64, 5) and not torch.equal(a, b)


def test_dictionary_encoding_and_subsampling_match(python_vocab, tmp_path):
    path = tmp_path / "c.txt"
    # count ties, a one-word line and an empty line
    path.write_text("b a c a b d\nd e\nz\n\nc c e a b f f\n" * 3)
    jd = japp.Dictionary.build(str(path), min_count=1)
    td = tapp.Dictionary.build(str(path), min_count=1)
    assert (td.words, td.counts, td.word2id) == (jd.words, jd.counts,
                                                 jd.word2id)
    for a, b in zip(tapp.encode_corpus(str(path), td),
                    japp.encode_corpus(str(path), jd)):
        np.testing.assert_array_equal(a, b)
    counts = np.asarray(td.counts, np.float64)
    for sample in (0.0, 1e-3, 0.1):
        np.testing.assert_array_equal(tapp.subsample_probs(counts, sample),
                                      japp.subsample_probs(counts, sample))
    td.save(str(tmp_path / "v.txt"))
    back = tapp.Dictionary.load(str(tmp_path / "v.txt"), min_count=4)
    assert back.words == [w for w, c in zip(td.words, td.counts) if c >= 4]
    # the reference dictionary extras, step by step on both
    for d in (jd, td):
        d.set_whitelist(["z"])
        d.insert("new", 2)
        d.insert("a", 5)
        d.merge_infrequent_words(4)
        d.remove_words_less_than(1)
    assert (td.words, td.counts, td.word2id) == (jd.words, jd.counts,
                                                 jd.word2id)
    (tmp_path / "wc.txt").write_text("hello 5\nab 2\nbad line here\n")
    tri = [tapp.Dictionary(), japp.Dictionary()]
    for d in tri:
        d.load_tri_letter(str(tmp_path / "wc.txt"), combine=True)
    assert (tri[0].words, tri[0].counts) == (tri[1].words, tri[1].counts)


STEP_CASES = [
    # name, G, row_mean_updates, row_mean_static, dtype
    ("raw-sum-G1", 1, False, False, torch.float32),
    ("realized-rowmean-G4", 4, True, False, torch.float32),
    ("static-rowmean-G4", 4, True, True, torch.float32),
    ("raw-sum-G1-bf16", 1, False, False, torch.bfloat16),
    ("static-rowmean-G4-bf16", 4, True, True, torch.bfloat16),
]


@pytest.mark.parametrize("name,G,row_mean,static,dtype", STEP_CASES)
def test_one_step_matches_jax(mv_session, port, name, G, row_mean, static,
                              dtype):
    V, D, B, K = 40, 16, 32, 3
    jw_in, jw_out = _jax_tables(mv_session, V, D, dtype, seed=2)
    tw_in, tw_out = tw2v.tables_from_jax(jw_in.get(), jw_out.get(),
                                         dtype=dtype)
    counts = np.random.default_rng(1).integers(1, 300, V).astype(np.float64)
    kw = dict(vocab_size=V, embedding_size=D, window=2, negative=K,
              batch_size=B, shared_negatives=G, row_mean_updates=row_mean,
              row_mean_static=static, oversample=2.5 if static else 0.0,
              row_update_cap=2.0)
    jm = jw2v.Word2Vec(jw2v.Word2VecConfig(**kw), jw_in, jw_out, counts)
    tm = tw2v.Word2Vec(tw2v.Word2VecConfig(**kw), tw_in, tw_out, counts)
    if static:
        discard = np.random.default_rng(4).random(V) * 0.5
        jm._build_static_scales(discard)
        tm._build_static_scales(discard)
        np.testing.assert_array_equal(tm._static_scale_out.numpy(),
                                      np.asarray(jm._static_scale_out))
    rng = np.random.default_rng(5)
    # hot rows: a zipf-ish draw over few rows gives heavy duplicates
    centers = rng.integers(0, 8, B).astype(np.int32)
    contexts = rng.integers(0, V, B).astype(np.int32)
    mask = (rng.random(B) > 0.2).astype(np.float32)
    negs = rng.integers(0, V, (B // G, K)).astype(np.int32)
    lr = 0.05
    in_before, out_before = jw_in.get(), jw_out.get()
    win, wout, _, _, jloss, _ = jm._raw_step(
        jw_in.array, jw_out.array, None, None, jnp.asarray(centers),
        jnp.asarray(contexts), jnp.asarray(mask), jnp.float32(lr),
        jm._key, jnp.asarray(negs))
    jw_in.set_array(win)
    jw_out.set_array(wout)
    tloss = tm._raw_step(tw_in.array, tw_out.array,
                         torch.from_numpy(centers), torch.from_numpy(contexts),
                         torch.from_numpy(mask), lr, torch.from_numpy(negs))
    assert abs(float(tloss) - float(jloss)) < 1e-5
    _assert_tables_close(jw_in, tw_in, dtype, np.asarray(in_before,
                                                         np.float32),
                         _hits(V, centers))
    _assert_tables_close(jw_out, tw_out, dtype, np.asarray(out_before,
                                                           np.float32),
                         _hits(V, contexts, negs))


def _jax_draws(jm, S, M, B):
    """Replay the JAX corpus step's key splits (word2vec.py:921-943), for
    skip-gram (``dsel``) and CBOW (``shrink``, ``u_ctx`` per window slot),
    with ``negs`` only when the model samples negatives."""
    cfg = jm.config
    W, K = cfg.window, cfg.negative
    G = max(int(cfg.shared_negatives), 1)
    key, k1, k2, k3, k4, k5 = jax.random.split(jm._key, 6)
    shrink = jax.random.randint(k1, (S, M), 1, W + 1)
    if cfg.cbow:
        draws = {"shrink": shrink,
                 "u_ctx": jax.random.uniform(k5, (S, M, 2 * W))}
    else:
        dmag = jnp.minimum(jax.random.randint(k2, (S, M), 1, W + 1), shrink)
        sign = jnp.where(jax.random.bernoulli(k3, 0.5, (S, M)), 1, -1)
        draws = {"dsel": jnp.where(sign > 0, W + dmag - 1, W - dmag),
                 "u_ctx": jax.random.uniform(k5, (S, M))}
    draws["u_center"] = jax.random.uniform(k4, (S, M))
    if K > 0:
        key, kn = jax.random.split(key)
        shape = (S, B // G, K)
        if cfg.neg_pool_size > 0:
            pool = jm._ensure_neg_pool(S * (B // G) * K)
            draws["negs"] = jw2v.pool_negatives(kn, pool, shape)
        else:
            draws["negs"] = jw2v.sample_negatives(kn, jm._packed_alias,
                                                  shape)
    return {k: np.asarray(v) for k, v in draws.items()}, key


@pytest.mark.parametrize("dtype,pool", [(torch.float32, True),
                                        (torch.float32, False),
                                        (torch.bfloat16, True)])
def test_train_device_steps_matches_jax(mv_session, port, python_vocab,
                                        tmp_path, dtype, pool):
    corpus = _zipf_corpus(tmp_path / "c.txt")
    d = japp.Dictionary.build(corpus, min_count=1)
    V, D, B, S = d.vocab_size, 16, 64, 3
    jw_in, jw_out = _jax_tables(mv_session, V, D, dtype, seed=6)
    tw_in, tw_out = tw2v.tables_from_jax(jw_in.get(), jw_out.get(),
                                         dtype=dtype)
    counts = np.asarray(d.counts, np.float64)
    kw = dict(vocab_size=V, embedding_size=D, window=3, negative=3,
              batch_size=B, oversample=2.5, shared_negatives=4,
              neg_pool_size=4096 if pool else 0, row_mean_updates=True,
              row_mean_static=True, seed=11)
    jm = jw2v.Word2Vec(jw2v.Word2VecConfig(**kw), jw_in, jw_out, counts)
    tm = tw2v.Word2Vec(tw2v.Word2VecConfig(**kw), tw_in, tw_out, counts)
    jm.total_words = tm.total_words = 5000
    ids, sents = japp.encode_corpus(corpus, d)
    discard = japp.subsample_probs(counts, 1e-2).astype(np.float32)
    jm.load_corpus_chunk(ids, sents, discard)
    tm.load_corpus_chunk(ids, sents, discard)
    M = tm._candidate_batch(ids.shape[0])
    assert M == jm._candidate_batch(ids.shape[0]) == 160
    W = kw["window"]
    for call in range(2):
        assert tm.current_lr() == jm.current_lr()
        draws, key_after = _jax_draws(jm, S, M, B)
        # every row a dispatch can touch: its candidate slabs and negatives
        start = tm._stream_pos % ids.shape[0]
        slab = tm._ext_bufs[0].numpy()[start:start + S * M + 2 * W]
        in_before = np.asarray(jw_in.get(), np.float32)
        out_before = np.asarray(jw_out.get(), np.float32)
        jloss, jcount = jm.train_device_steps(S)
        # the replay is the draw the JAX step made
        np.testing.assert_array_equal(np.asarray(jax.random.key_data(
            jm._key)), np.asarray(jax.random.key_data(key_after)))
        tloss, tcount = tm.train_device_steps(S, draws=draws)
        assert float(tcount) == float(jcount) > 0
        assert abs(float(tloss) - float(jloss)) < 1e-5
        _assert_tables_close(jw_in, tw_in, dtype, in_before, _hits(V, slab))
        _assert_tables_close(jw_out, tw_out, dtype, out_before,
                             _hits(V, slab, draws["negs"]))
        if dtype == torch.bfloat16:
            # hold each dispatch from the same start (bf16 rounding
            # differences would otherwise compound)
            tw_in.set_array(torch.from_numpy(np.asarray(jw_in.get(),
                                                        np.float32)))
            tw_out.set_array(torch.from_numpy(np.asarray(jw_out.get(),
                                                         np.float32)))


def test_host_batch_entry_points_train(port):
    import multiverso_tpu_torch as mv

    V, D, B = 30, 8, 16
    w_in = mv.create_table("matrix", V, D, init_value="random", seed=1)
    w_out = mv.create_table("matrix", V, D)
    counts = np.arange(1, V + 1, dtype=np.float64)
    m = tw2v.Word2Vec(tw2v.Word2VecConfig(vocab_size=V, embedding_size=D,
                                          negative=2, batch_size=B,
                                          shared_negatives=4), w_in, w_out,
                      counts)
    rng = np.random.default_rng(0)
    before = w_in.get()
    loss = m.train_batch(rng.integers(0, V, B), rng.integers(0, V, B))
    assert np.isfinite(float(loss)) and w_in.version == 1
    loss = m.train_batches(rng.integers(0, V, (3, B)),
                           rng.integers(0, V, (3, B)))
    assert np.isfinite(float(loss)) and w_in.version == 2
    assert not np.array_equal(w_in.get(), before)
    with pytest.raises(FatalError):
        m.train_batch(rng.integers(0, V, (2, B)), rng.integers(0, V, B))


def _toy_corpus(tmp_path, repeats=200):
    """tests/test_word2vec.py's two co-occurring clusters (a b c), (x y z)."""
    rng = np.random.default_rng(0)
    lines = []
    for _ in range(repeats):
        lines.append(" ".join(rng.permutation(["a", "b", "c"]).tolist()))
        lines.append(" ".join(rng.permutation(["x", "y", "z"]).tolist()))
    path = tmp_path / "corpus.txt"
    path.write_text("\n".join(lines))
    return str(path)


def test_app_train_learns_cooccurrence(port, tmp_path):
    corpus = _toy_corpus(tmp_path)
    cfg = tw2v.Word2VecConfig(embedding_size=16, window=2, negative=3,
                              init_lr=0.03, batch_size=128, seed=3)
    out = str(tmp_path / "vec.txt")
    # 1,200 tokens: the auto rule would stream them from the host, so
    # this asks for the device path, as JAX can be asked
    result = tapp.train(corpus, out, cfg, epochs=3, min_count=1, sample=0,
                        log_every=1, device_corpus=True)
    assert result.words_trained == 3600 and result.pairs_trained > 0
    assert np.isfinite(result.final_loss)
    with open(out) as f:
        assert f.readline().split() == ["6", "16"]
        vecs = {p[0]: np.asarray(p[1:], np.float64)
                for p in (line.split() for line in f)}

    def sim(a, b):
        va, vb = vecs[a], vecs[b]
        return va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb) + 1e-9)

    in_cluster = np.mean([sim("a", "b"), sim("b", "c"), sim("x", "y"),
                          sim("y", "z")])
    cross = np.mean([sim("a", "x"), sim("b", "y"), sim("c", "z")])
    assert in_cluster > cross


OPTIONS = [dict(cbow=True), dict(hs=True), dict(use_adagrad=True),
           dict(update_impl="segsum"), dict(update_impl="split8"),
           dict(compact_impl="gather"), dict(update_impl="fused"),
           dict(negative=0)]
STILL_REFUSED = [dict(update_impl="fused"), dict(negative=0)]


@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: str(o))
def test_unported_options_raise(port, opts):
    """Options the port once refused now build and train one batch; an
    unknown ``update_impl`` and ``negative=0`` without ``hs`` still
    raise."""
    import multiverso_tpu_torch as mv

    w_in = mv.create_table("matrix", 8, 4, init_value="random", seed=1)
    w_out = mv.create_table("matrix", 8, 4)
    counts = np.arange(1, 9, dtype=np.float64)
    cfg = tw2v.Word2VecConfig(vocab_size=8, embedding_size=4, window=2,
                              batch_size=16, **opts)
    if opts in STILL_REFUSED:
        with pytest.raises(FatalError):
            tw2v.Word2Vec(cfg, w_in, w_out, counts=counts)
        return
    huffman = tw2v.build_huffman(counts) if cfg.hs else None
    m = tw2v.Word2Vec(cfg, w_in, w_out, counts=counts, huffman=huffman)
    rng = np.random.default_rng(0)
    ctx_shape = (16, 4) if cfg.cbow else (16,)
    loss = m.train_batch(rng.integers(0, 8, 16),
                         rng.integers(0, 8, ctx_shape))
    # the zero output table moves first (the input's grads are 0 there)
    assert np.isfinite(float(loss)) and w_out.version == 1
    assert np.abs(w_out.get()).max() > 0


def test_auto_rule_refuses_a_small_corpus(port, tmp_path):
    """``device_corpus=None`` on a corpus under max(batch + 2*window + 2,
    65,536) tokens is the JAX trainer's host-stream path
    (``multiverso_tpu/apps/wordembedding.py:564-566``). The port refused
    it until the host stream was ported; now it streams it from the host,
    as JAX does: the device corpus is never loaded."""
    corpus = _toy_corpus(tmp_path)                 # 1,200 tokens
    cfg = tw2v.Word2VecConfig(embedding_size=16, window=2, negative=3,
                              batch_size=128, seed=3)
    loaded = []
    orig = tw2v.Word2Vec.load_corpus_chunk
    tw2v.Word2Vec.load_corpus_chunk = lambda self, *a: loaded.append(a)
    try:
        result = tapp.train(corpus, None, cfg, min_count=1, sample=0,
                            log_every=0)
    finally:
        tw2v.Word2Vec.load_corpus_chunk = orig
    assert not loaded
    assert result.words_trained == 1200 and result.pairs_trained > 0
    assert np.isfinite(result.final_loss)


def test_unported_paths_raise(port, tmp_path):
    import multiverso_tpu_torch as mv

    corpus = _toy_corpus(tmp_path, repeats=5)
    # the device path still needs a batch's worth of positions
    with pytest.raises(FatalError, match="device_corpus needs"):
        tapp.train(corpus, None, tw2v.Word2VecConfig(batch_size=1024),
                   min_count=1, device_corpus=True)
    w = mv.create_table("matrix", 8, 4)
    with pytest.raises(FatalError, match="hierarchical"):
        tw2v.Word2Vec(tw2v.Word2VecConfig(vocab_size=8, hs=True), w, w,
                      counts=np.ones(8))
    with pytest.raises(FatalError, match="compact_impl"):
        tw2v.Word2Vec(tw2v.Word2VecConfig(vocab_size=8, compact_impl="x"),
                      w, w, counts=np.ones(8))
    for kind in ("kv", "sparse", "ftrl"):
        with pytest.raises(FatalError, match="not ported"):
            mv.create_table(kind)


def test_worker_axis_parallelism_refused():
    """dp_sync / dp_exchange need a worker axis > 1: the session refuses the
    mesh that would give one."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.runtime import Session

    Session._instance = None
    try:
        with pytest.raises(FatalError, match="mesh_shape"):
            mv.init(["test", "-device=cpu", "-mesh_shape=2,1"])
    finally:
        mv.set_flag("mesh_shape", "")
        mv.set_flag("device", "cuda")
        Session._instance = None


def test_bench_cpu_run_prints_its_json_line():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run(
        [sys.executable, "-m", "multiverso_tpu_torch.bench", "-device=cpu",
         "-bench_quick=true", "-shared_negatives=8"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["metric"] == "word2vec_train_pairs_per_sec"
    assert rec["unit"] == "pairs/sec" and rec["value"] > 0
    assert rec["negatives"] == "group-shared G=8"
    assert rec["device"] == "cpu" and rec["card"] == "cpu"
    bad = subprocess.run(
        [sys.executable, "-m", "multiverso_tpu_torch.bench", "-device=cpu",
         "-no_such_flag=1"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert bad.returncode == 2 and "unknown flag" in bad.stderr


def test_app_main_runs_and_refuses_unported_options(tmp_path):
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.runtime import Session

    corpus = _toy_corpus(tmp_path)
    out = tmp_path / "vec.txt"
    base = ["-train_file", corpus, "-output", str(out), "-size", "8",
            "-window", "2", "-negative", "2", "-batch_size", "64",
            "-min_count", "1", "-sample", "0", "-save_vocab",
            str(tmp_path / "v.txt"), "-device=cpu"]
    # the 1,200-token corpus takes the device path only when asked
    dev = base + ["-device_corpus", "1"]
    Session._instance = None
    try:
        assert tapp.main(dev) == 0
        assert out.read_text().splitlines()[0] == "6 8"
        assert (tmp_path / "v.txt").read_text().count("\n") == 6
        assert tapp.main(dev + ["-bogus", "1"]) == 2
        assert tapp.main([]) == 2
        # CBOW on the device path, then the host stream: by the auto rule,
        # asked for, and with the CLI's hierarchical softmax and AdaGrad
        for argv in (dev + ["-cbow", "1"], base,
                     base + ["-device_corpus", "0", "-cbow", "1"],
                     base + ["-hs", "1", "-use_adagrad", "1"]):
            out.unlink()
            assert tapp.main(argv) == 0
            assert out.read_text().splitlines()[0] == "6 8"
    finally:
        Session._instance = None
        mv.set_flag("device", "cuda")
