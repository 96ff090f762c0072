"""The port's micro-batcher, its workloads and the SLO pieces, on the CPU.

The cases of ``tests/test_serving.py`` on the port's ``InferenceServer.
register`` path: a deadline flush and a size flush, one signature per
shape bucket, shedding at the queue cap, an idle server that never
wakes, a decoder's construction outside the registry lock. The
workloads against the JAX package's on the same inputs:
``EmbeddingNeighbors`` (ids equal, scores within 1e-5) and
``LMGreedyDecode`` (token-identical), both through the server. Also:
``DerivedCache`` computes once under concurrent readers, and the log
buckets, the bucket export, the SLO summary and the SLO rows of
``Dashboard.snapshot()`` equal the JAX package's on the same samples.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu_torch.serving import (EmbeddingNeighbors,
                                          InferenceServer, LMGreedyDecode,
                                          OverloadedError)


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


class _Echo:
    """A workload without a program or a table: the batcher alone."""

    source = (lambda: (None, 0), lambda: 0)

    def run(self, payloads, bucket, snap):
        return [p * 2 for p in payloads]


def _wait(pred, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.005)


def test_deadline_flush_vs_size_flush(port):
    srv = InferenceServer("t")
    srv.register("echo", _Echo(), max_batch=8, deadline_ms=60.0,
                 max_queue=64)
    entry = srv._entry("echo")
    t0 = time.monotonic()
    futs = [srv.submit("echo", i) for i in range(3)]
    assert [f.result(timeout=5)["result"] for f in futs] == [0, 2, 4]
    waited = time.monotonic() - t0
    n, bucket, cause = entry.batcher.flushes[-1]
    assert (n, cause) == (3, "deadline")
    assert bucket == 4
    assert waited >= 0.055
    t0 = time.monotonic()
    futs = [srv.submit("echo", i) for i in range(8)]
    assert [f.result(timeout=5)["result"]
            for f in futs] == [2 * i for i in range(8)]
    waited = time.monotonic() - t0
    assert entry.batcher.flushes[-1] == (8, 8, "size")
    assert waited < 0.055


def test_shape_bucket_reuse_one_signature_per_bucket(port):
    table = port.create_table("matrix", 64, 16, init_value="random")
    workload = EmbeddingNeighbors(table, k=4)
    srv = InferenceServer("t")
    srv.register("w2v", workload, max_batch=8, deadline_ms=5.0)
    entry = srv._entry("w2v")

    def flush_of(n):
        futs = [srv.submit("w2v", i) for i in range(n)]
        for f in futs:
            f.result(timeout=30)
        return entry.batcher.flushes[-1]

    assert flush_of(3)[1] == 4
    assert workload.jit_cache_size() == 1
    for _ in range(3):
        assert flush_of(3)[1] == 4
    assert workload.jit_cache_size() == 1
    assert flush_of(7)[1] == 8
    assert workload.jit_cache_size() == 2
    assert flush_of(7)[1] == 8
    assert workload.jit_cache_size() == 2


def test_load_shedding_at_queue_depth_cap(port):
    started, release = threading.Event(), threading.Event()

    class Blocker:
        source = (lambda: (None, 0), lambda: 0)

        def run(self, payloads, bucket, snap):
            started.set()
            release.wait(timeout=30)
            return payloads

    srv = InferenceServer("t")
    srv.register("slow", Blocker(), max_batch=1, deadline_ms=0.1,
                 max_queue=3)
    first = srv.submit("slow", 0)
    started.wait(timeout=5)
    queued = [srv.submit("slow", i) for i in range(1, 4)]
    with pytest.raises(OverloadedError) as exc:
        srv.submit("slow", 99)
    assert exc.value.depth == 3 and exc.value.cap == 3
    assert srv.stats("slow")["shed"] == 1
    release.set()
    assert first.result(timeout=10)["result"] == 0
    for f in queued:
        f.result(timeout=10)
    assert srv.stats("slow")["shed_rate"] > 0


def test_idle_server_never_wakes(port):
    srv = InferenceServer("t")
    srv.register("echo", _Echo(), max_batch=8, deadline_ms=5.0)
    batcher = srv._entry("echo").batcher
    _wait(lambda: batcher._thread.is_alive())
    baseline = batcher.idle_wakeups
    time.sleep(0.3)
    assert batcher.idle_wakeups == baseline
    assert len(batcher.flushes) == 0
    assert srv.submit("echo", 21).result(timeout=5)["result"] == 42
    srv.stop()
    batcher._thread.join(timeout=5)
    assert not batcher._thread.is_alive()


def test_bad_payload_rejected_at_submit_never_fails_its_batch(port):
    """A workload's ``validate`` runs in ``submit``: an out-of-range word
    id raises there, and the requests around it are served."""
    table = port.create_table("matrix", 32, 8, init_value="random")
    srv = InferenceServer("t")
    srv.register("w2v", EmbeddingNeighbors(table, k=3), max_batch=4,
                 deadline_ms=20.0)
    good = [srv.submit("w2v", 1), srv.submit("w2v", 2)]
    with pytest.raises(ValueError, match="outside vocab"):
        srv.submit("w2v", 32)
    good.append(srv.submit("w2v", 3))
    for f in good:
        ids, _ = f.result(timeout=30)["result"]
        assert len(ids) == 3
    assert srv._entry("w2v").batcher.flushes[-1][0] == 3


def test_register_decoder_builds_engine_outside_registry_lock(port):
    from multiverso_tpu_torch.serving import server as server_mod

    srv = InferenceServer("t")
    srv.register("echo", _Echo(), max_batch=4, deadline_ms=5.0,
                 max_queue=64)
    entered, release = threading.Event(), threading.Event()

    class _SlowEngine:
        def __init__(self, name, lm, cfg):
            self.name = name
            entered.set()
            release.wait(10)

        def stop(self):
            pass

    real = server_mod.DecodeEngine
    server_mod.DecodeEngine = _SlowEngine
    try:
        t = threading.Thread(
            target=lambda: srv.register_decoder("slow-lm", object()))
        t.start()
        assert entered.wait(5), "registration never reached construction"
        assert srv.submit("echo", 3).result(timeout=5)["result"] == 6
        release.set()
        t.join(10)
        assert not t.is_alive()
        assert srv._entry("slow-lm").engine.name == "slow-lm"
    finally:
        server_mod.DecodeEngine = real


def test_embedding_neighbors_matches_jax(port):
    """The same table through the port's server and the JAX workload's
    ``run`` on the same snapshot: neighbour ids equal, scores within
    1e-5; both equal a numpy cosine oracle."""
    from multiverso_tpu.serving import workloads as jw
    from multiverso_tpu.serving.snapshot import Snapshot as JSnap

    rows, dim, k = 48, 8, 5
    emb = np.random.default_rng(3).standard_normal(
        (rows, dim)).astype(np.float32)
    table = port.create_table("matrix", rows, dim, init_value=emb)
    srv = InferenceServer("t")
    srv.register("w2v", EmbeddingNeighbors(table, k=k), max_batch=4,
                 deadline_ms=1.0)

    class _Shape:
        shape = (rows, dim)

    jwork = jw.EmbeddingNeighbors(_Shape(), k=k)
    queries = [0, 7, 31, 47]
    jres = jwork.run(queries, 4, JSnap(jnp.asarray(emb), 0, 0.0))
    normed = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    for q, (jids, jscores) in zip(queries, jres):
        ids, scores = srv.predict("w2v", q, timeout_s=30)["result"]
        np.testing.assert_array_equal(np.asarray(ids), np.asarray(jids))
        np.testing.assert_allclose(np.asarray(scores), np.asarray(jscores),
                                   rtol=0, atol=1e-5)
        sims = normed @ normed[q]
        sims[q] = -np.inf
        np.testing.assert_array_equal(np.asarray(ids),
                                      np.argsort(-sims)[:k])


def test_lm_greedy_decode_matches_jax(port):
    """Prompts of 1..8 tokens micro-batched through the port's server
    give the tokens of the JAX workload run on the same padded bucket
    with the same parameters; pad rows are sliced off."""
    from multiverso_tpu.models import transformer as jtf
    from multiverso_tpu.serving import workloads as jw
    from multiverso_tpu.serving.snapshot import Snapshot as JSnap
    from multiverso_tpu_torch.models import transformer as ttf

    dims = dict(vocab_size=61, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_seq=16)
    jcfg = jtf.TransformerConfig(**dims)
    jparams = jtf.init_params(jcfg)
    lm = ttf.TransformerLM(ttf.TransformerConfig(**dims))
    carried = ttf.params_from_jax(
        {"embed": np.asarray(jparams["embed"]),
         "pos": np.asarray(jparams["pos"]),
         "ln_f_g": np.asarray(jparams["ln_f_g"]),
         "layers": {n: np.asarray(w)
                    for n, w in jparams["layers"].items()}}, device="cpu")
    with torch.no_grad():
        for name, w in lm.params.items():
            if isinstance(w, dict):
                for n, t in w.items():
                    t.copy_(carried[name][n])
            else:
                w.copy_(carried[name])
    workload = LMGreedyDecode(lm, max_prompt=8, max_new=5)
    srv = InferenceServer("t")
    srv.register("lm", workload, max_batch=4, deadline_ms=30.0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 61, int(n)) for n in (6, 3, 8, 1, 5)]
    with pytest.raises(ValueError):
        srv.submit("lm", np.arange(9))           # too long: rejected alone
    futs = [srv.submit("lm", p) for p in prompts]
    outs = [np.asarray(f.result(timeout=60)["result"]) for f in futs]

    class _LM:
        config = jcfg

    jwork = jw.LMGreedyDecode(_LM(), max_prompt=8, max_new=5)
    # the flushes took the FIFO queue in order: replay each one's batch
    # on its bucket through the JAX workload
    want, at = [], 0
    for n, bucket, _ in srv._entry("lm").batcher.flushes:
        assert n <= bucket
        want += jwork.run(prompts[at: at + n], bucket,
                          JSnap(jparams, 0, 0.0))
        at += n
    assert at == len(prompts)
    for got, w in zip(outs, want):
        assert got.shape == (5,)
        np.testing.assert_array_equal(got, np.asarray(w))
    assert workload.jit_cache_size() == len(
        {b for _, b, _ in srv._entry("lm").batcher.flushes})


def test_derived_cache_single_compute_under_concurrent_readers():
    from multiverso_tpu_torch.serving.snapshot import DerivedCache, Snapshot

    calls = []

    def fn(value):
        calls.append(threading.current_thread().name)
        time.sleep(0.05)
        return value * 2

    cache = DerivedCache(fn)
    snap = Snapshot(21, 7, 0.0)
    results = [None, None]
    barrier = threading.Barrier(2)

    def reader(ix):
        barrier.wait()
        results[ix] = cache.get(snap)

    threads = [threading.Thread(target=reader, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert results == [42, 42]
    assert len(calls) == 1
    assert cache.get(Snapshot(30, 8, 0.0)) == 60
    assert len(calls) == 2


def test_histogram_percentiles():
    from multiverso_tpu_torch.dashboard import Histogram

    h = Histogram("t", window=128, register=False)
    for v in range(1, 101):
        h.record(float(v))
    assert h.percentile(50) == pytest.approx(50, abs=1)
    assert h.percentile(99) == pytest.approx(99, abs=1)
    s = h.summary()
    assert s["count"] == 100 and s["p50_ms"] <= s["p99_ms"]


def _samples(seed, n=500):
    rng = np.random.default_rng(seed)
    vals = np.exp(rng.normal(1.0, 1.5, n))
    vals[:7] = 0.0                         # the zero bucket
    vals[7:9] = [1.0, 2 ** 0.5]            # on bucket edges
    return [float(v) for v in vals]


def test_bucket_functions_equal_jax():
    from multiverso_tpu import dashboard as jd
    from multiverso_tpu_torch import dashboard as td

    assert td.BUCKET_BASE == jd.BUCKET_BASE
    assert td.BUCKET_REL_ERROR == jd.BUCKET_REL_ERROR
    vals = _samples(1)
    for v in vals + [1e-9, 3.0e5, 2 ** 0.25, 2 ** 0.5]:
        assert td.bucket_index(v) == jd.bucket_index(v), v
    for i in range(-40, 60):
        assert td.bucket_value(i) == jd.bucket_value(i)
    exports = []
    for seed in (1, 2, 3):
        th = td.Histogram("t", window=256, register=False)
        jh = jd.Histogram("t", window=256, register=False)
        for v in _samples(seed):
            th.record(v)
            jh.record(v)
        te, je = th.buckets(), jh.buckets()
        assert te == je
        exports.append(te)
    exports.append(None)
    merged = td.merge_buckets(exports)
    assert merged == jd.merge_buckets(exports)
    for p in (0, 1, 50, 90, 99, 99.9, 100):
        assert td.bucket_percentile(merged, p) == \
            jd.bucket_percentile(merged, p)
    for thr in (0.0, 1.0, 2.7, 10.0, 1e4):
        assert td.bucket_breach_frac(merged, thr) == \
            jd.bucket_breach_frac(merged, thr)
    assert td.bucket_percentile({"counts": {}}, 50) == 0.0


def test_slo_rows_equal_jax():
    """One latency stream into both dashboards, the same SLOs declared:
    the SLO rows of ``snapshot()`` (and ``Dashboard.stats``) are equal,
    and re-targeting through ``set_slo`` moves the row."""
    from multiverso_tpu import dashboard as jd
    from multiverso_tpu_torch import dashboard as td

    td.Dashboard.reset()
    jd.Dashboard.reset()
    try:
        for dash in (td.Dashboard, jd.Dashboard):
            th = dash.get_or_create_histogram("SERVE_TTFT[lm]")
            for v in _samples(7):
                th.record(v)
            dash.set_slo("SERVE_TTFT[lm]", 20.0)
            dash.set_slo("SERVE_ITL[lm]", 5.0, percentile=95.0)
        trows = {k: v for k, v in td.Dashboard.snapshot().items()
                 if v["type"] == "slo"}
        jrows = {k: v for k, v in jd.Dashboard.snapshot().items()
                 if v["type"] == "slo"}
        assert trows == jrows
        assert set(trows) == {"SLO_P99[SERVE_TTFT[lm]]",
                              "SLO_P95[SERVE_ITL[lm]]"}
        assert trows["SLO_P95[SERVE_ITL[lm]]"]["window"] == 0
        row = trows["SLO_P99[SERVE_TTFT[lm]]"]
        assert row["ok"] == 0 and row["burn"] > 1.0
        td.Dashboard.set_slo("SERVE_TTFT[lm]", 1e6)
        jd.Dashboard.set_slo("SERVE_TTFT[lm]", 1e6)
        assert td.Dashboard.stats("SLO_P99[SERVE_TTFT[lm]]") == \
            jd.Dashboard.stats("SLO_P99[SERVE_TTFT[lm]]")
        assert td.Dashboard.stats("SLO_P99[SERVE_TTFT[lm]]")["ok"] == 1
    finally:
        td.Dashboard.reset()
        jd.Dashboard.reset()
