"""The port's LogisticRegression application against the JAX package's,
on the CPU.

``tests/test_logreg.py``'s cases run on ``multiverso_tpu_torch``; then the
same inputs (numpy, from a seed) go through the JAX models and the port's:

* dense ``LogReg`` steps: weights after 5 steps within 1e-5 absolute
  (the closed-form gradients round in another order than JAX's autodiff
  of the same loss, and XLA's and torch's CPU GEMMs sum in other orders;
  f32 weights near 0.1 give ~1e-8 a step);
* ``SparseLogReg`` and ``FTRLLogReg``: losses and table states bitwise
  (the host math is float64 numpy in both, the tables' gathers copy and
  their adds round one float32 sum at a time, in index order on the CPU);
* models saved by either package's ``save_model`` load into the other's
  and predict the same (bitwise on the sparse and FTRL paths, 1e-6 on the
  dense GEMM);
* ``LogRegPredict`` / ``FTRLPredict`` replies on one snapshot, within
  1e-6 (f32 on both sides, GEMV sums in another order);
* ``main`` in every mode with ``-device=cpu``: the non-pipelined output
  models equal the JAX app's byte for byte (sparse, FTRL) or within 1e-5
  (dense).
"""

import io
import types

import numpy as np
import pytest
import torch

DENSE_ATOL = 1e-5
REPLY_ATOL = 1e-6


@pytest.fixture()
def port():
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.dashboard import Dashboard
    from multiverso_tpu_torch.runtime import Session

    Session._instance = None
    Dashboard.reset()
    mv.set_flag("updater_type", "default")
    mv.init(["test", "-device=cpu"])
    n = torch.get_num_threads()
    torch.set_num_threads(1)   # many small CPU ops under parallel workers
    yield mv
    torch.set_num_threads(n)
    mv.shutdown()
    Session._instance = None
    mv.set_flag("device", "cuda")


def _binary_data(n=512, dim=10, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(dim)
    x = rng.standard_normal((n, dim)).astype(np.float32)
    y = (x @ w + 0.1 * rng.standard_normal(n) > 0).astype(np.float32)
    return x, y[:, None], w


def test_dense_sigmoid_learns(port):
    from multiverso_tpu_torch.apps.logreg import build_model
    from multiverso_tpu_torch.models.logreg import LogRegConfig

    x, y, _ = _binary_data()
    cfg = LogRegConfig(input_size=10, output_size=1, objective_type="sigmoid",
                       learning_rate=0.5, learning_rate_coef=0.001,
                       minibatch_size=64)
    model = build_model(cfg)
    for epoch in range(30):
        for i in range(0, len(x), 64):
            model.train_minibatch(x[i:i + 64], y[i:i + 64])
    assert model.test(x, y) > 0.95


def test_dense_softmax_learns(port):
    from multiverso_tpu_torch.apps.logreg import build_model
    from multiverso_tpu_torch.models.logreg import LogRegConfig

    rng = np.random.default_rng(1)
    centers = np.asarray([[2, 0], [-2, 2], [0, -2]], np.float32)
    labels = rng.integers(0, 3, 600)
    x = centers[labels] + 0.5 * rng.standard_normal((600, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[labels]
    cfg = LogRegConfig(input_size=2, output_size=3, objective_type="softmax",
                       learning_rate=0.5, learning_rate_coef=0.001)
    model = build_model(cfg)
    for _ in range(40):
        for i in range(0, 600, 64):
            model.train_minibatch(x[i:i + 64], y[i:i + 64])
    assert model.test(x, y) > 0.9


def test_linear_objective_and_regulariser(port):
    from multiverso_tpu_torch.apps.logreg import build_model
    from multiverso_tpu_torch.models.logreg import LogRegConfig

    x, y, w_true = _binary_data()
    y_reg = (x @ w_true).astype(np.float32)[:, None]
    cfg = LogRegConfig(input_size=10, output_size=1, objective_type="linear",
                       regular_type="l2", regular_coef=1e-4,
                       learning_rate=0.05, learning_rate_coef=0.0)
    model = build_model(cfg)
    losses = []
    for _ in range(50):
        for i in range(0, len(x), 64):
            loss = model.train_minibatch(x[i:i + 64], y_reg[i:i + 64])
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.1


def test_sparse_logreg_learns(port):
    from multiverso_tpu_torch.apps.logreg import build_model
    from multiverso_tpu_torch.models.logreg import LogRegConfig

    rng = np.random.default_rng(2)
    dim = 100
    w = np.zeros(dim)
    w[:10] = rng.standard_normal(10) * 2
    samples = []
    for _ in range(400):
        keys = np.sort(rng.choice(dim, size=8, replace=False))
        vals = rng.standard_normal(8)
        label = float(w[keys] @ vals > 0)
        samples.append((keys.astype(np.int64), vals, label))
    cfg = LogRegConfig(input_size=dim, sparse=True, learning_rate=0.5,
                       learning_rate_coef=0.001, minibatch_size=32)
    model = build_model(cfg)
    for _ in range(30):
        for i in range(0, len(samples), 32):
            model.train_minibatch(samples[i:i + 32])
    correct = sum(
        (model.predict_sample(k, v) > 0.5) == (lab > 0.5)
        for k, v, lab in samples)
    assert correct / len(samples) > 0.85


def test_ftrl_learns_and_is_sparse(port):
    from multiverso_tpu_torch.apps.logreg import build_model
    from multiverso_tpu_torch.models.logreg import LogRegConfig

    rng = np.random.default_rng(3)
    dim = 50
    w = np.zeros(dim)
    w[:5] = [3, -3, 2, -2, 4]
    samples = []
    for _ in range(600):
        keys = np.sort(rng.choice(dim, size=6, replace=False))
        vals = np.ones(6)
        label = float(w[keys].sum() > 0)
        samples.append((keys.astype(np.int64), vals, label))
    cfg = LogRegConfig(input_size=dim, objective_type="ftrl",
                       ftrl_alpha=0.5, ftrl_beta=1.0,
                       ftrl_lambda1=0.1, ftrl_lambda2=0.01)
    model = build_model(cfg)
    for k, v, lab in samples:
        model.train_sample(k, v, lab)
    correct = sum(
        (model.predict_sample(k, v) > 0.5) == (lab > 0.5)
        for k, v, lab in samples)
    assert correct / len(samples) > 0.8
    # L1 proximal: |z| <= lambda1 reconstructs an exact zero weight
    weights = model._weights_from_zn(np.asarray([0.05, -0.05, 1.0]),
                                     np.asarray([1.0, 1.0, 1.0]))
    assert weights[0] == 0 and weights[1] == 0 and weights[2] != 0


def test_logreg_app_end_to_end(port, tmp_path):
    """Config-file driven app run: train -> test -> save -> load."""
    from multiverso_tpu_torch.apps import logreg as app

    x, y, _ = _binary_data(n=256, dim=5, seed=4)
    train_path = tmp_path / "train.txt"
    lines = [" ".join([str(int(y[i, 0]))] + [f"{v:.5f}" for v in x[i]])
             for i in range(200)]
    train_path.write_text("\n".join(lines))
    test_path = tmp_path / "test.txt"
    lines = [" ".join([str(int(y[i, 0]))] + [f"{v:.5f}" for v in x[i]])
             for i in range(200, 256)]
    test_path.write_text("\n".join(lines))
    config_path = tmp_path / "lr.config"
    config_path.write_text("\n".join([
        "input_size=5",
        "output_size=1",
        "objective_type=sigmoid",
        "learning_rate=0.5",
        "learning_rate_coef=0.001",
        "minibatch_size=32",
        f"train_file={train_path}",
        f"test_file={test_path}",
        "train_epoch=40",
        f"output_model_file={tmp_path}/model.bin",
    ]))

    conf = app.parse_config(str(config_path))
    cfg = app.config_from_dict(conf)
    model = app.build_model(cfg)
    app.train_file(model, cfg, conf["train_file"],
                   epochs=int(conf["train_epoch"]), log_every=0)
    acc = app.test_file(model, cfg, conf["test_file"])
    assert acc > 0.9
    app.save_model(model, conf["output_model_file"])

    model2 = app.build_model(cfg)
    app.load_model(model2, conf["output_model_file"])
    np.testing.assert_allclose(model2.table.get(), model.table.get())


def test_parse_sample_formats():
    from multiverso_tpu_torch.apps.logreg import parse_sample

    label, keys, vals = parse_sample("1 3:0.5 7:2.0", True, 10)
    assert label == 1.0
    np.testing.assert_array_equal(keys, [3, 7])
    np.testing.assert_allclose(vals, [0.5, 2.0])
    label, keys, vals = parse_sample("0 0.1 0.2 0.3", False, 5)
    assert label == 0.0
    np.testing.assert_allclose(vals[:3], [0.1, 0.2, 0.3])
    assert vals.shape == (5,)


def test_logreg_rejects_accumulate_updater(port):
    from multiverso_tpu_torch.log import FatalError
    from multiverso_tpu_torch.models.logreg import LogReg, LogRegConfig

    table = port.create_table("matrix", 1, 6)  # default updater
    with pytest.raises(FatalError):
        LogReg(LogRegConfig(input_size=5, output_size=1), table)


def _dense_batch(rng, objective, D, C, B=16):
    x = rng.standard_normal((B, D)).astype(np.float32)
    if objective == "softmax":
        y = np.eye(C, dtype=np.float32)[rng.integers(0, C, B)]
    elif objective == "sigmoid":
        y = (rng.random((B, C)) > 0.5).astype(np.float32)
    else:
        y = rng.standard_normal((B, C)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("objective,regular,updater", [
    ("sigmoid", "none", "sgd"), ("softmax", "l2", "momentum_sgd"),
    ("linear", "l1", "adagrad"), ("softmax", "none", "sgd")])
def test_dense_steps_match_jax(mv_session, port, objective, regular,
                               updater):
    from multiverso_tpu.models import logreg as jlr
    from multiverso_tpu_torch.models import logreg as tlr

    rng = np.random.default_rng(0)
    D, C = 12, 4 if objective == "softmax" else 1
    kw = dict(input_size=D, output_size=C, objective_type=objective,
              regular_type=regular, regular_coef=0.01, learning_rate=0.1,
              minibatch_size=16)
    init = (0.1 * rng.standard_normal((C, D + 1))).astype(np.float32)
    jt = mv_session.create_table("matrix", C, D + 1, updater=updater,
                                 init_value=init)
    tt = port.create_table("matrix", C, D + 1, updater=updater,
                           init_value=init)
    jm = jlr.LogReg(jlr.LogRegConfig(**kw), jt)
    tm = tlr.LogReg(tlr.LogRegConfig(**kw), tt)
    for _ in range(5):
        x, y = _dense_batch(rng, objective, D, C)
        jl, tl = float(jm.train_minibatch(x, y)), tm.train_minibatch(x, y)
        assert isinstance(tl, torch.Tensor) and tl.dim() == 0
        assert abs(float(tl) - jl) <= DENSE_ATOL * max(1.0, abs(jl))
    assert tm.current_lr() == jm.current_lr()
    np.testing.assert_allclose(tt.get(), jt.get(), rtol=0, atol=DENSE_ATOL)
    np.testing.assert_allclose(tm.predict(x), jm.predict(x), rtol=0,
                               atol=DENSE_ATOL)
    assert tm.test(x, y) == jm.test(x, y)
    assert tt.version == jt.version == 5


def _sparse_samples(rng, n, dim, nkeys, repeat=False):
    w = rng.standard_normal(dim)
    out = []
    for _ in range(n):
        keys = rng.choice(dim, size=nkeys, replace=repeat).astype(np.int64)
        vals = rng.standard_normal(nkeys)
        out.append((keys, vals, float(w[keys] @ vals > 0)))
    return out


@pytest.mark.parametrize("sync", [1, 3])
def test_sparse_steps_match_jax(mv_session, port, sync):
    from multiverso_tpu.models import logreg as jlr
    from multiverso_tpu_torch.models import logreg as tlr

    rng = np.random.default_rng(1)
    dim = 200
    kw = dict(input_size=dim, sparse=True, sync_frequency=sync,
              minibatch_size=16, learning_rate=0.5, learning_rate_coef=0.01)
    jm = jlr.SparseLogReg(jlr.LogRegConfig(**kw), mv_session.create_table(
        "sparse", dim + 1, updater="sgd"))
    tm = tlr.SparseLogReg(tlr.LogRegConfig(**kw), port.create_table(
        "sparse", dim + 1, updater="sgd"))
    samples = _sparse_samples(rng, 160, dim, 8)
    for i in range(0, 160, 16):
        batch = samples[i:i + 16]
        assert tm.train_minibatch(batch) == jm.train_minibatch(batch)
    assert tm.steps == jm.steps == 10
    np.testing.assert_array_equal(tm.table.get(),
                                  np.asarray(jm.table.get())[: dim + 1])
    assert tm._w_cache == jm._w_cache
    for k, v, _ in samples[:20]:
        assert tm.predict_sample(k, v) == jm.predict_sample(k, v)


@pytest.mark.parametrize("repeat", [False, True])
def test_ftrl_steps_match_jax(mv_session, port, repeat):
    from multiverso_tpu.models import logreg as jlr
    from multiverso_tpu_torch.models import logreg as tlr

    rng = np.random.default_rng(2)
    dim = 64
    kw = dict(input_size=dim, objective_type="ftrl")
    jm = jlr.FTRLLogReg(jlr.LogRegConfig(**kw),
                        mv_session.create_table("ftrl", dim + 1))
    tm = tlr.FTRLLogReg(tlr.LogRegConfig(**kw),
                        port.create_table("ftrl", dim + 1))
    for k, v, label in _sparse_samples(rng, 150, dim, 6, repeat=repeat):
        assert tm.train_sample(k, v, label) == jm.train_sample(k, v, label)
    np.testing.assert_array_equal(tm.table.get(),
                                  np.asarray(jm.table.get())[: dim + 1])
    for k, v, _ in _sparse_samples(rng, 20, dim, 6):
        assert tm.predict_sample(k, v) == jm.predict_sample(k, v)
    z = np.asarray([0.0005, -0.2, 0.3])
    n = np.asarray([1.0, 2.0, 0.5])
    np.testing.assert_array_equal(tm._weights_from_zn(z, n),
                                  jm._weights_from_zn(z, n))


def _trained(app, cfg, rng, mode):
    """A model of ``cfg`` built by ``app`` and trained on seeded data."""
    model = app.build_model(cfg)
    if mode == "dense":
        for _ in range(3):
            model.train_minibatch(*_dense_batch(rng, "softmax", 10, 3))
    elif mode == "sparse":
        model.train_minibatch(_sparse_samples(rng, 32, 50, 5))
    else:
        for k, v, label in _sparse_samples(rng, 30, 50, 5):
            model.train_sample(k, v, label)
    return model


def _predictions(model, mode, rng):
    if mode == "dense":
        return model.predict(rng.standard_normal((8, 10)).astype(np.float32))
    return np.asarray([model.predict_sample(k, v)
                       for k, v, _ in _sparse_samples(rng, 12, 50, 5)])


@pytest.mark.parametrize("mode", ["dense", "sparse", "ftrl"])
def test_saved_models_cross_packages(mv_session, port, tmp_path, mode):
    from multiverso_tpu.apps import logreg as japp
    from multiverso_tpu_torch.apps import logreg as tapp

    conf = {"dense": dict(input_size=10, output_size=3,
                          objective_type="softmax"),
            "sparse": dict(input_size=50, sparse=True),
            "ftrl": dict(input_size=50, objective_type="ftrl")}[mode]
    jcfg = japp.LogRegConfig(**conf)
    tcfg = tapp.LogRegConfig(**conf)
    atol = REPLY_ATOL if mode == "dense" else 0.0
    # JAX -> port
    jm = _trained(japp, jcfg, np.random.default_rng(3), mode)
    japp.save_model(jm, str(tmp_path / "j.bin"))
    tm = tapp.build_model(tcfg)
    tapp.load_model(tm, str(tmp_path / "j.bin"))
    np.testing.assert_allclose(
        _predictions(tm, mode, np.random.default_rng(4)),
        _predictions(jm, mode, np.random.default_rng(4)), rtol=0, atol=atol)
    # port -> JAX
    tm2 = _trained(tapp, tcfg, np.random.default_rng(5), mode)
    tapp.save_model(tm2, str(tmp_path / "t.bin"))
    jm2 = japp.build_model(jcfg)
    japp.load_model(jm2, str(tmp_path / "t.bin"))
    np.testing.assert_allclose(
        _predictions(jm2, mode, np.random.default_rng(6)),
        _predictions(tm2, mode, np.random.default_rng(6)), rtol=0,
        atol=atol)
    # and the port's own round trip predicts bit for bit the same
    tm3 = tapp.build_model(tcfg)
    tapp.load_model(tm3, str(tmp_path / "t.bin"))
    np.testing.assert_array_equal(
        _predictions(tm3, mode, np.random.default_rng(6)),
        _predictions(tm2, mode, np.random.default_rng(6)))


def test_logreg_workloads_match_jax(mv_session, port):
    from multiverso_tpu.models import logreg as jlr
    from multiverso_tpu.serving import workloads as jw
    from multiverso_tpu_torch.log import FatalError
    from multiverso_tpu_torch.models import logreg as tlr
    from multiverso_tpu_torch.serving import (FTRLPredict, InferenceServer,
                                              LogRegPredict)

    rng = np.random.default_rng(7)
    D, C = 10, 3
    kw = dict(input_size=D, output_size=C, objective_type="softmax")
    jm = jlr.LogReg(jlr.LogRegConfig(**kw), mv_session.create_table(
        "matrix", C, D + 1, updater="sgd"))
    tm = tlr.LogReg(tlr.LogRegConfig(**kw), port.create_table(
        "matrix", C, D + 1, updater="sgd"))
    for _ in range(3):
        jm.train_minibatch(*_dense_batch(rng, "softmax", D, C))
    tm.table.set_array(np.asarray(jm.table.get()))
    fkw = dict(input_size=50, objective_type="ftrl")
    jf = jlr.FTRLLogReg(jlr.LogRegConfig(**fkw),
                        mv_session.create_table("ftrl", 51))
    tf = tlr.FTRLLogReg(tlr.LogRegConfig(**fkw), port.create_table("ftrl", 51))
    for k, v, label in _sparse_samples(rng, 40, 50, 5):
        jf.train_sample(k, v, label)
        tf.train_sample(k, v, label)
    dense = [rng.standard_normal(D).astype(np.float32) for _ in range(5)]
    feats = [rng.standard_normal(50).astype(np.float32) for _ in range(5)]
    cases = ((jw.LogRegPredict(jm), LogRegPredict(tm), dense),
             (jw.FTRLPredict(jf.table, jf.cfg),
              FTRLPredict(tf.table, tf.cfg), feats))
    for jwl, twl, payloads in cases:
        jsnap = types.SimpleNamespace(value=jwl.source.snapshot_array()[0])
        tsnap = types.SimpleNamespace(value=twl.source.snapshot_array()[0])
        got = twl.run(payloads, 8, tsnap)
        want = jwl.run(payloads, 8, jsnap)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=REPLY_ATOL)
        with pytest.raises(ValueError, match="shape"):
            twl.validate(np.zeros(3))
    with pytest.raises(FatalError, match="LogReg"):
        LogRegPredict(tf)
    # behind the micro-batcher: replies equal predict / predict_sample
    srv = InferenceServer("lr")
    lr_w, ftrl_w = LogRegPredict(tm), FTRLPredict(tf.table, tf.cfg)
    srv.register("lr", lr_w, max_batch=4, deadline_ms=5.0)
    srv.register("ftrl", ftrl_w, max_batch=4, deadline_ms=5.0)
    futs = [srv.submit("lr", x) for x in dense]
    ffuts = [srv.submit("ftrl", x) for x in feats]
    for x, fut in zip(dense, futs):
        reply = fut.result(timeout=30)
        np.testing.assert_allclose(reply["result"], tm.predict(x[None])[0],
                                   rtol=0, atol=REPLY_ATOL)
        assert reply["snapshot_version"] == tm.table.version
    for x, fut in zip(feats, ffuts):
        nz = np.flatnonzero(x)
        want = tf.predict_sample(nz, x[nz].astype(np.float64))
        assert abs(fut.result(timeout=30)["result"] - want) <= REPLY_ATOL
    buckets = {b for _, b, _ in srv._entry("lr").batcher.flushes}
    assert lr_w.jit_cache_size() == len(buckets)
    srv.stop()


def _write_lines(path, lines):
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _app_files(tmp_path, mode):
    """Seeded train/test files and the config lines of ``mode``."""
    rng = np.random.default_rng(8)
    if mode == "dense":
        x = rng.random((160, 6))
        y = (x @ rng.standard_normal((6, 3))).argmax(-1)
        lines = [" ".join([str(int(c))] + [f"{v:.4f}" for v in row])
                 for c, row in zip(y, x)]
        conf = ["input_size=6", "output_size=3", "objective_type=softmax",
                "minibatch_size=16", "learning_rate=0.5"]
    else:
        lines = []
        for k, v, label in _sparse_samples(rng, 160, 80, 6):
            lines.append(f"{int(label)} " + " ".join(
                f"{a}:{b:.5f}" for a, b in zip(k, v)))
        conf = ["input_size=80", "sparse=true", "minibatch_size=16",
                "learning_rate=0.5", "learning_rate_coef=0.01"]
        if mode == "ftrl":
            conf.append("objective_type=ftrl")
        if mode == "pipeline":
            conf += ["pipeline=true", "sync_frequency=2"]
    train = _write_lines(tmp_path / "train.txt", lines[:128])
    test = _write_lines(tmp_path / "test.txt", lines[128:])
    return conf + [f"train_file={train}", f"test_file={test}",
                   "train_epoch=3"]


def _run_mains(tmp_path, conf):
    """The JAX app's main, then the port's with -device=cpu, each in a
    fresh session; returns the two output model files' bytes."""
    import multiverso_tpu as jmv
    import multiverso_tpu_torch as tmv
    from multiverso_tpu.apps import logreg as japp
    from multiverso_tpu.runtime import Session as JSession
    from multiverso_tpu_torch.apps import logreg as tapp
    from multiverso_tpu_torch.runtime import Session as TSession

    out = []
    for tag, app in (("j", japp), ("t", tapp)):
        cfg = tmp_path / f"{tag}.config"
        cfg.write_text("\n".join(
            conf + [f"output_model_file={tmp_path / tag}.bin"]))
        if tag == "j":
            JSession._instance = None
            jmv.set_flag("mesh_shape", "")
            assert app.main([str(cfg)]) == 0
        else:
            TSession._instance = None
            assert app.main([str(cfg), "-device=cpu"]) == 0
            assert TSession.get().started is False
            tmv.set_flag("device", "cuda")
        out.append((tmp_path / f"{tag}.bin").read_bytes())
    return out


@pytest.mark.parametrize("mode", ["dense", "sparse", "pipeline", "ftrl"])
def test_main_matches_jax_app(tmp_path, mode):
    from multiverso_tpu_torch.io import read_array

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jbin, tbin = _run_mains(tmp_path, _app_files(tmp_path, mode))
    finally:
        torch.set_num_threads(n)
    jw, tw = read_array(io.BytesIO(jbin)), read_array(io.BytesIO(tbin))
    assert tw.shape == jw.shape and tw.dtype == jw.dtype == np.float32
    assert np.isfinite(tw).all() and np.abs(tw).max() > 0
    if mode in ("sparse", "ftrl"):
        assert tbin == jbin
    elif mode == "dense":
        np.testing.assert_allclose(tw, jw, rtol=0, atol=DENSE_ATOL)
    # pipeline: which adds a background pull sees depends on the thread
    # schedule, in both packages; the run must train and save


def test_main_usage_errors(tmp_path, capsys):
    from multiverso_tpu_torch.apps import logreg as tapp

    assert tapp.main([]) == 2
    assert tapp.main([str(tmp_path / "missing.config")]) == 2
    assert "usage" in capsys.readouterr().out
