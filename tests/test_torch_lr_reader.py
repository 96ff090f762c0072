"""The port's LogReg readers: ``tests/test_lr_reader.py``'s cases on
``multiverso_tpu_torch.apps.lr_reader`` (the reference's
``LR/src/reader.{h,cpp}`` variants), the samples of every reader equal to
the JAX package's on the same files (bitwise: both parse in float64 with
the same Python code), and the double buffer and pipelined getter of
``parallel.async_buffer``.
"""

import threading
import time

import numpy as np
import pytest


@pytest.fixture()
def port():
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.dashboard import Dashboard
    from multiverso_tpu_torch.runtime import Session

    Session._instance = None
    Dashboard.reset()
    mv.set_flag("updater_type", "default")
    mv.init(["test", "-device=cpu"])
    yield mv
    mv.shutdown()
    Session._instance = None
    mv.set_flag("device", "cuda")


def test_parse_weighted():
    from multiverso_tpu_torch.apps.lr_reader import parse_weighted

    label, keys, vals = parse_weighted("1:2.5 3:0.5 7:2.0", True, 10)
    assert label == 1.0
    np.testing.assert_array_equal(keys, [3, 7])
    np.testing.assert_allclose(vals, [1.25, 5.0])  # scaled by weight

    label, keys, vals = parse_weighted("0:0.5 0.2 0.4", False, 3)
    assert label == 0.0
    np.testing.assert_allclose(vals, [0.1, 0.2, 0.0])

    # weightless lines behave like the default reader
    label, _, vals = parse_weighted("1 3:0.5", True, 10)
    np.testing.assert_allclose(vals, [0.5])


def test_bsparse_round_trip(tmp_path):
    from multiverso_tpu_torch.apps.lr_reader import iter_bsparse, write_bsparse

    path = str(tmp_path / "data.bsparse")
    rng = np.random.default_rng(0)
    samples = []
    for _ in range(100):
        nkeys = int(rng.integers(1, 12))
        keys = np.sort(rng.choice(1000, nkeys, replace=False)).astype(np.int64)
        weight = float(rng.standard_normal())
        samples.append((float(rng.integers(0, 2)), keys,
                        np.full(nkeys, weight, np.float64)))
    assert write_bsparse(path, samples) == 100

    out = list(iter_bsparse(path, chunk_size=64))  # tiny chunks: refill path
    assert len(out) == 100
    for (l0, k0, v0), (l1, k1, v1) in zip(samples, out):
        assert l0 == l1
        np.testing.assert_array_equal(k0, k1)
        np.testing.assert_allclose(v0, v1)


def test_bsparse_truncated_raises(tmp_path):
    from multiverso_tpu_torch.apps.lr_reader import iter_bsparse, write_bsparse

    path = str(tmp_path / "data.bsparse")
    write_bsparse(path, [(1.0, np.arange(8, dtype=np.int64),
                          np.ones(8))])
    blob = open(path, "rb").read()
    trunc = str(tmp_path / "trunc.bsparse")
    with open(trunc, "wb") as f:
        f.write(blob[:-4])
    with pytest.raises(EOFError):
        list(iter_bsparse(trunc))


def test_sample_iterator_factory(tmp_path):
    from multiverso_tpu_torch.apps.lr_reader import sample_iterator, write_bsparse

    a = tmp_path / "a.txt"
    b = tmp_path / "b.txt"
    a.write_text("1 3:0.5\n")
    b.write_text("0 7:2.0\n")
    # comma-separated multi-file list, read in order
    out = list(sample_iterator("default", f"{a},{b}", True, 10))
    assert [s[0] for s in out] == [1.0, 0.0]

    out = list(sample_iterator("weight", f"{a}", True, 10))
    assert out[0][0] == 1.0

    bs = str(tmp_path / "c.bsparse")
    write_bsparse(bs, out)
    out2 = list(sample_iterator("bsparse", bs, True, 10))
    np.testing.assert_array_equal(out2[0][1], out[0][1])


def test_async_reader_keyset_windows():
    from multiverso_tpu_torch.apps.lr_reader import AsyncSampleReader

    def gen():
        for i in range(10):
            yield float(i % 2), np.asarray([i, i + 100], np.int64), np.ones(2)

    reader = AsyncSampleReader(gen(), window_size=4, bias_key=999)
    seen = list(reader)
    assert len(seen) == 10
    ks1 = reader.next_keyset()
    ks2 = reader.next_keyset()
    ks3 = reader.next_keyset()
    assert reader.next_keyset(timeout=0.5) is None
    # windows of 4, 4, 2 samples; bias key in every keyset
    np.testing.assert_array_equal(
        ks1, sorted({0, 1, 2, 3, 100, 101, 102, 103, 999}))
    np.testing.assert_array_equal(
        ks2, sorted({4, 5, 6, 7, 104, 105, 106, 107, 999}))
    np.testing.assert_array_equal(ks3, sorted({8, 9, 108, 109, 999}))


def test_async_reader_propagates_errors():
    from multiverso_tpu_torch.apps.lr_reader import AsyncSampleReader

    def gen():
        yield 1.0, np.asarray([1], np.int64), np.ones(1)
        raise ValueError("boom")

    reader = AsyncSampleReader(gen(), window_size=4)
    with pytest.raises(ValueError, match="boom"):
        list(reader)


def test_sparse_pipeline_end_to_end(port, tmp_path):
    """Pipelined sparse training (bsparse reader + keyset prefetch) learns."""
    from multiverso_tpu_torch.apps import logreg as app
    from multiverso_tpu_torch.models.logreg import LogRegConfig

    rng = np.random.default_rng(3)
    dim = 60
    w = np.zeros(dim)
    w[:8] = rng.standard_normal(8) * 2
    lines = []
    for _ in range(400):
        keys = np.sort(rng.choice(dim, size=6, replace=False))
        vals = rng.standard_normal(6)
        label = int(w[keys] @ vals > 0)
        lines.append(f"{label} " + " ".join(
            f"{k}:{v:.5f}" for k, v in zip(keys, vals)))
    train = tmp_path / "train.txt"
    train.write_text("\n".join(lines) + "\n")

    cfg = LogRegConfig(input_size=dim, sparse=True, pipeline=True,
                       sync_frequency=2, minibatch_size=32,
                       learning_rate=0.5, learning_rate_coef=0.001)
    model = app.build_model(cfg)
    for _ in range(12):
        app.train_file(model, cfg, str(train), epochs=1, log_every=0)
    acc = app.test_file(model, cfg, str(train))
    assert acc > 0.85


def test_weight_reader_end_to_end(port, tmp_path):
    """weight reader: zero-weight samples must not move the model."""
    from multiverso_tpu_torch.apps import logreg as app
    from multiverso_tpu_torch.models.logreg import LogRegConfig

    # all-zero-weight samples -> zero feature values -> only bias learns
    lines = ["1:0.0 1:5.0 2:5.0"] * 16
    train = tmp_path / "train.txt"
    train.write_text("\n".join(lines) + "\n")
    cfg = LogRegConfig(input_size=4, sparse=True, reader_type="weight",
                       minibatch_size=8, learning_rate=0.5)
    model = app.build_model(cfg)
    app.train_file(model, cfg, str(train), epochs=1, log_every=0)
    weights = model.table.get_keys(np.asarray([1, 2], np.int64))
    np.testing.assert_allclose(np.asarray(weights), 0.0, atol=1e-12)


def _same_samples(a, b):
    assert len(a) == len(b)
    for (l0, k0, v0), (l1, k1, v1) in zip(a, b):
        assert l0 == l1
        np.testing.assert_array_equal(k0, k1)
        np.testing.assert_array_equal(v0, v1)
        assert k0.dtype == k1.dtype == np.int64
        assert v0.dtype == v1.dtype == np.float64


@pytest.mark.parametrize("reader_type,sparse", [("default", True),
                                                ("default", False),
                                                ("weight", True),
                                                ("weight", False),
                                                ("bsparse", True)])
def test_samples_equal_jax(tmp_path, reader_type, sparse):
    from multiverso_tpu.apps import lr_reader as jr
    from multiverso_tpu_torch.apps import lr_reader as tr

    rng = np.random.default_rng(5)
    lines = []
    for i in range(60):
        head = f"{i % 2}" + (f":{rng.random():.4f}"
                             if reader_type == "weight" else "")
        if sparse:
            keys = np.sort(rng.choice(1000, rng.integers(1, 9), replace=False))
            feats = [f"{k}:{rng.standard_normal():.6g}" for k in keys]
        else:
            feats = [f"{v:.6g}" for v in rng.standard_normal(rng.integers(1, 9))]
        lines.append(" ".join([head] + feats))
    text = tmp_path / "a.txt"
    text.write_text("\n".join(lines) + "\n\n")
    files = str(text)
    if reader_type == "bsparse":
        files = str(tmp_path / "a.bsparse")
        src = list(jr.sample_iterator("default", str(text), True, 1000))
        assert tr.write_bsparse(files, src) == jr.write_bsparse(
            str(tmp_path / "j.bsparse"), src) == 60
        assert open(files, "rb").read() == open(
            tmp_path / "j.bsparse", "rb").read()
    got = list(tr.sample_iterator(reader_type, files, sparse, 12))
    want = list(jr.sample_iterator(reader_type, files, sparse, 12))
    _same_samples(got, want)
    reader = tr.AsyncSampleReader(iter(got), window_size=16, bias_key=1000,
                                  buffer_samples=8)
    jreader = jr.AsyncSampleReader(iter(want), window_size=16,
                                   bias_key=1000, buffer_samples=8)
    _same_samples(list(reader), list(jreader))
    while True:
        a, b = reader.next_keyset(timeout=5), jreader.next_keyset(timeout=5)
        if a is None or b is None:
            assert a is None and b is None
            break
        np.testing.assert_array_equal(a, b)
    assert [len(b) for b in tr.batched(got, 25)] == [25, 25, 10]


def test_bsparse_needs_sparse_and_unknown_reader_raises(tmp_path):
    from multiverso_tpu_torch.apps.lr_reader import sample_iterator
    from multiverso_tpu_torch.log import FatalError

    with pytest.raises(FatalError, match="sparse"):
        list(sample_iterator("bsparse", str(tmp_path / "x"), False, 4))
    with pytest.raises(FatalError, match="reader_type"):
        list(sample_iterator("csv", str(tmp_path / "x"), True, 4))


def test_async_buffer_double_buffers():
    from multiverso_tpu_torch.parallel import ASyncBuffer

    fills = []

    def fill(buf):
        fills.append(id(buf))
        buf.append(len(fills))

    a, b = [], []
    ab = ASyncBuffer(a, b, fill)
    try:
        assert ab.get() is a and a == [1]
        assert ab.get() is b and b == [2]
        assert ab.get() is a and a == [1, 3]
        ab.join()
        with pytest.raises(RuntimeError, match="stopped"):
            ab.get()
        ab.restart()
        assert ab.get() is b
    finally:
        ab.join()
    assert not ab._thread.is_alive()


def test_pipelined_getter_overlaps_and_orders():
    from multiverso_tpu_torch.parallel import PipelinedGetter

    gate = threading.Event()
    seen = []

    def fetch(keys):
        seen.append(keys)
        if keys == "k1":
            gate.wait(5)          # the next fetch runs while we train
        return keys.upper()

    g = PipelinedGetter(fetch)
    with pytest.raises(RuntimeError, match="prime"):
        g.get()
    g.prime("k0")
    assert g.get("k1") == "K0"
    deadline = time.monotonic() + 5
    while seen != ["k0", "k1"] and time.monotonic() < deadline:
        time.sleep(0.01)
    assert seen == ["k0", "k1"]      # started before the consumer asked
    gate.set()
    assert g.get() == "K1"
    with pytest.raises(RuntimeError, match="prime"):
        g.get()
