"""The port's parameter plane and its staleness surface, on the CPU.

Held against the JAX package on the same inputs:

* ``DecodeEngine.health()`` ships ``params_age_s``, ``params_stale`` and
  ``snapshot_epoch`` with the JAX engine's verdicts, and sets the
  ``SERVE_PARAMS_AGE[<name>]`` gauge (``tests/test_trainer_chaos.py::
  test_engine_health_ships_staleness``);
* the ``MVTA`` array framing (``io/stream.write_array``) is byte-equal
  to JAX's, bf16 included, and a bf16 record reads back where
  ``ml_dtypes`` cannot be imported;
* the async-PS record framing (``_serialize``), the wire codecs
  (``encode_dense``/``encode_keyed``, compress on and off, int8) and
  ``SparseFilter`` give JAX's fields and arrays;
* a JAX publisher drives port subscribers and a port publisher drives
  JAX subscribers over the real ``mvparam`` TCP wire: bitwise in f32,
  within the JAX test's bound for int8;
* the rebase, fence and staleness cases of
  ``tests/test_trainer_chaos.py`` run on the port's plane.

Tolerances: bitwise everywhere except the int8 codec, held to half a
quantization step plus one f32 ulp per record as
``tests/test_quant_serving.py`` holds it.
"""

from __future__ import annotations

import io
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeKV:
    """In-process coordination KV (the JAX tests' fake)."""

    def __init__(self):
        self.d = {}
        self.lock = threading.Lock()

    def key_value_set(self, key, val, allow_overwrite=False):
        with self.lock:
            self.d[key] = str(val)

    def key_value_try_get(self, key):
        with self.lock:
            if key not in self.d:
                raise KeyError("NOT_FOUND: " + key)
            return self.d[key]

    def blocking_key_value_get(self, key, timeout_ms):
        deadline = time.monotonic() + timeout_ms / 1000.0
        while True:
            with self.lock:
                if key in self.d:
                    return self.d[key]
            if time.monotonic() > deadline:
                raise TimeoutError(key)
            time.sleep(0.005)


@pytest.fixture()
def both():
    """A JAX session and a port session (CPU), both fresh."""
    import multiverso_tpu as jmv
    import multiverso_tpu_torch as tmv
    from multiverso_tpu.dashboard import Dashboard as JDash
    from multiverso_tpu.runtime import Session as JSession
    from multiverso_tpu_torch.dashboard import Dashboard as TDash
    from multiverso_tpu_torch.runtime import Session as TSession

    JSession._instance = None
    TSession._instance = None
    JDash.reset()
    TDash.reset()
    jmv.set_flag("mesh_shape", "")
    jmv.init()
    tmv.init(["test", "-device=cpu"])
    yield jmv, tmv
    tmv.shutdown()
    jmv.shutdown()
    for mod in (jmv, tmv):
        mod.set_flag("params_stale_after_s", 0.0)
    TSession._instance = None
    JSession._instance = None
    JDash.reset()
    TDash.reset()
    tmv.set_flag("device", "cuda")


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


# -- step 0: the engine's staleness surface -----------------------------------

def test_engine_health_ships_staleness(both):
    """The port's ``health()`` carries the JAX keys with the JAX engine's
    verdicts on the same config, and sets ``SERVE_PARAMS_AGE[<name>]``."""
    jmv, tmv = both
    from multiverso_tpu.dashboard import Dashboard as JDash
    from multiverso_tpu.models import transformer as jtf
    from multiverso_tpu.serving import DecodeEngine as JEngine
    from multiverso_tpu.serving import DecodeEngineConfig as JCfg
    from multiverso_tpu_torch.dashboard import Dashboard as TDash
    from multiverso_tpu_torch.models import transformer as ttf
    from multiverso_tpu_torch.serving import DecodeEngine as TEngine
    from multiverso_tpu_torch.serving import DecodeEngineConfig as TCfg

    dims = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=1, d_ff=32,
                max_seq=16)
    knobs = dict(slots=1, max_prompt=4, max_new=4, prompt_buckets=(4,),
                 watchdog=False)
    jlm = jtf.TransformerLM(jtf.TransformerConfig(**dims))
    tlm = ttf.TransformerLM(ttf.TransformerConfig(**dims))
    jeng = JEngine("stale_probe", jlm, JCfg(**knobs))
    teng = TEngine("stale_probe", tlm, TCfg(**knobs))
    keys = {"snapshot_version", "snapshot_epoch", "params_age_s",
            "params_stale"}
    batch = np.array([[1, 2, 3, 4]], np.int32)
    try:
        hj, ht = jeng.health(), teng.health()
        assert keys <= set(hj) and keys <= set(ht)
        for k in ("snapshot_version", "snapshot_epoch", "params_stale"):
            assert ht[k] == hj[k], k
        assert ht["params_stale"] is False     # flag default 0 = off
        assert ht["params_age_s"] == round(ht["params_age_s"], 4)
        for mod in (jmv, tmv):
            mod.set_flag("params_stale_after_s", 0.05)
        time.sleep(0.1)
        hj, ht = jeng.health(), teng.health()
        assert hj["params_stale"] is True and ht["params_stale"] is True
        assert ht["params_age_s"] > 0.05 and hj["params_age_s"] > 0.05
        gauge = TDash.get_or_create_gauge("SERVE_PARAMS_AGE[stale_probe]")
        assert gauge.get() >= 0.05
        assert "SERVE_PARAMS_AGE[stale_probe]" in TDash.snapshot()
        assert set(JDash.snapshot()) >= {"SERVE_PARAMS_AGE[stale_probe]"}
        jlm.train_batch(batch)
        tlm.train_batch(batch)
        hj, ht = jeng.health(), teng.health()
        assert hj["params_stale"] is False and ht["params_stale"] is False
        assert ht["params_age_s"] < 0.05
    finally:
        jeng.stop()
        teng.stop()


# -- the MVTA framing ----------------------------------------------------------

def _arrays(seed):
    """numpy arrays of every framed dtype, and the bf16 case as the JAX
    (ml_dtypes) array and the port (torch) tensor of the same bits."""
    import ml_dtypes

    rng = np.random.default_rng(seed)
    f = rng.standard_normal((5, 3)).astype(np.float32)
    plain = [f, f.astype(np.float64), rng.integers(-9, 9, 7).astype(np.int32),
             rng.integers(0, 1 << 40, (2, 2)).astype(np.int64),
             rng.integers(-128, 127, 6).astype(np.int8),
             np.asarray(3.5, np.float32), np.zeros((0, 4), np.float32),
             np.arange(12, dtype=np.uint8).reshape(2, 3, 2)]
    jbf = f.astype(ml_dtypes.bfloat16)
    tbf = torch.from_numpy(f).to(torch.bfloat16)
    return plain, jbf, tbf


@pytest.mark.parametrize("seed", [0, 1])
def test_write_array_bytes_equal_jax_bf16_included(seed):
    from multiverso_tpu.io import stream as jstream
    from multiverso_tpu_torch.io import stream as tstream

    plain, jbf, tbf = _arrays(seed)
    assert tbf.view(torch.int16).numpy().tobytes() == jbf.tobytes()
    for jarr, tarr in [(a, a) for a in plain] + [(jbf, tbf)]:
        jb, tb = io.BytesIO(), io.BytesIO()
        jstream.write_array(jb, jarr)
        tstream.write_array(tb, tarr)
        assert tb.getvalue() == jb.getvalue()
        # each reads the other's record back to the same bits
        back = tstream.read_array(io.BytesIO(jb.getvalue()))
        jback = jstream.read_array(io.BytesIO(tb.getvalue()))
        if isinstance(tarr, torch.Tensor):
            assert back.dtype == torch.bfloat16
            assert torch.equal(back.view(torch.int16),
                               tarr.view(torch.int16))
            assert jback.tobytes() == jbf.tobytes()
        else:
            # (a 0-d array frames as shape (1,) in both packages:
            # np.ascontiguousarray returns at least one dimension)
            assert back.dtype == jback.dtype == jarr.dtype
            assert back.shape == jback.shape
            assert back.tobytes() == jback.tobytes() == jarr.tobytes()
    # a torch tensor of a numpy dtype frames as its numpy array does
    jb, tb = io.BytesIO(), io.BytesIO()
    jstream.write_array(jb, plain[0])
    tstream.write_array(tb, torch.from_numpy(plain[0]))
    assert tb.getvalue() == jb.getvalue()


def test_bf16_record_reads_without_ml_dtypes(tmp_path):
    """A JAX-written bf16 record (and a whole bf16 STATE record) reads in
    a process where ``import ml_dtypes`` fails."""
    import ml_dtypes

    from multiverso_tpu.io import stream as jstream
    from multiverso_tpu.parallel import async_ps as jps

    rng = np.random.default_rng(7)
    f = rng.standard_normal((4, 6)).astype(np.float32)
    jbf = f.astype(ml_dtypes.bfloat16)
    buf = io.BytesIO()
    jstream.write_array(buf, jbf)
    (tmp_path / "a.bin").write_bytes(buf.getvalue())
    (tmp_path / "r.bin").write_bytes(jps._serialize(
        jps.STATE, 3, None, [jbf], epoch=2, version=9))
    (tmp_path / "want.bin").write_bytes(jbf.tobytes())
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "try:\n"
        "    import ml_dtypes\n"
        "    raise SystemExit('ml_dtypes imported')\n"
        "except ImportError:\n"
        "    pass\n"
        "import io, torch\n"
        "from multiverso_tpu_torch.io.stream import read_array\n"
        "from multiverso_tpu_torch.parallel.async_ps import _deserialize\n"
        f"d = {str(tmp_path)!r}\n"
        "want = open(d + '/want.bin', 'rb').read()\n"
        "a = read_array(io.BytesIO(open(d + '/a.bin', 'rb').read()))\n"
        "assert a.dtype == torch.bfloat16 and tuple(a.shape) == (4, 6)\n"
        "assert a.view(torch.int16).numpy().tobytes() == want\n"
        "rec = _deserialize(open(d + '/r.bin', 'rb').read())\n"
        "assert rec[0] == 4 and rec[1] == 3 and rec[6:] == (2, 9)\n"
        "assert rec[3][0].view(torch.int16).numpy().tobytes() == want\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr


# -- record framing and codecs -------------------------------------------------

def _same(a, b):
    """Bitwise equality of a JAX-side array and a port-side one."""
    if isinstance(b, torch.Tensor):
        assert b.dtype == torch.bfloat16
        assert np.asarray(a).tobytes() == \
            b.contiguous().view(torch.int16).numpy().tobytes()
    else:
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_serialize_fields_and_bytes_equal_jax(monkeypatch):
    """With both clocks fixed, a record is byte-identical; each side
    unpacks the other's fields."""
    import ml_dtypes

    from multiverso_tpu.parallel import async_ps as jps
    from multiverso_tpu.updaters import AddOption as JOpt
    from multiverso_tpu_torch import trace as ttrace
    from multiverso_tpu_torch.parallel import async_ps as tps
    from multiverso_tpu_torch.updaters import AddOption as TOpt

    monkeypatch.setattr(jps.time, "time", lambda: 1234.5)
    monkeypatch.setattr(tps.time, "time", lambda: 1234.5)
    rng = np.random.default_rng(2)
    ids = np.array([4, 1, 9], np.int32)
    f = rng.standard_normal((3, 5)).astype(np.float32)
    jopt = JOpt(worker_id=2, learning_rate=0.25, momentum=0.5, rho=0.1,
                lam=0.2)
    topt = TOpt(worker_id=2, learning_rate=0.25, momentum=0.5, rho=0.1,
                lam=0.2)
    from multiverso_tpu import trace as jtrace

    cases = [([ids, f], [ids, f]),
             ([ids, f.astype(ml_dtypes.bfloat16)],
              [ids, torch.from_numpy(f).to(torch.bfloat16)])]
    for kind in (tps.DENSE, tps.KEYED, tps.STATE):
        for jarrs, tarrs in cases:
            jb = jps._serialize(kind, 7, jopt, jarrs,
                                jtrace.SpanContext(11, 12), epoch=3,
                                version=40)
            tb = tps._serialize(kind, 7, topt, tarrs,
                                ttrace.SpanContext(11, 12), epoch=3,
                                version=40)
            assert tb == jb
            tk, ttid, to, ta, tts, tctx, tep, tver = tps._deserialize(jb)
            assert (tk, ttid, tts, tep, tver) == (kind, 7, 1234.5, 3, 40)
            assert (tctx.trace_id, tctx.span_id) == (11, 12)
            assert (to.worker_id, to.momentum) == (2, 0.5)
            for ja, ta_ in zip(jarrs, ta):
                _same(ja, ta_)
    assert tps._serialize(tps.DENSE, 0, None, [f]) == \
        jps._serialize(jps.DENSE, 0, None, [f])
    assert (tps.DENSE, tps.KEYED, tps.KV, tps.PART, tps.STATE) == \
        (jps.DENSE, jps.KEYED, jps.KV, jps.PART, jps.STATE)
    assert tps._HEADER.format == jps._HEADER.format


def _delta(rng, shape, density):
    d = rng.standard_normal(shape).astype(np.float32)
    d[rng.random(shape) > density] = 0.0
    return d


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compress,quant", [(True, "none"), (False, "none"),
                                            (True, "int8")])
@pytest.mark.parametrize("density", [0.05, 0.9])
def test_codec_arrays_equal_jax(dtype, compress, quant, density):
    import ml_dtypes

    from multiverso_tpu.serving import param_plane as jpp
    from multiverso_tpu_torch.serving import param_plane as tpp

    rng = np.random.default_rng(int(density * 100) + compress)
    d = _delta(rng, (16, 8), density)
    ids = np.array([3, 0, 12, 7], np.int32)
    vals = _delta(rng, (4, 8), density)
    if dtype == "bfloat16":
        jd, td = d.astype(ml_dtypes.bfloat16), torch.from_numpy(d).to(
            torch.bfloat16)
        jv, tv = vals.astype(ml_dtypes.bfloat16), torch.from_numpy(
            vals).to(torch.bfloat16)
        jdt, tdt = ml_dtypes.bfloat16, torch.bfloat16
    else:
        jd, td, jv, tv = d, d, vals, vals
        jdt, tdt = np.float32, torch.float32
    jenc = jpp.encode_dense(jd, compress, quant)
    tenc = tpp.encode_dense(td, compress, quant)
    assert len(jenc) == len(tenc)
    for a, b in zip(jenc, tenc):
        _same(a, b)
    _same(jpp.decode_dense(jenc, jdt, (16, 8)),
          tpp.decode_dense(tenc, tdt, (16, 8)))
    _same(jpp.decode_dense(tenc if dtype == "float32" else jenc, jdt,
                           (16, 8)),
          tpp.decode_dense(jenc, tdt, (16, 8)))
    jk = jpp.encode_keyed(ids, jv, compress, quant)
    tk = tpp.encode_keyed(ids, tv, compress, quant)
    assert len(jk) == len(tk)
    for a, b in zip(jk, tk):
        _same(a, b)
    jids, jvals = jpp.decode_keyed(jk, jdt)
    tids, tvals = tpp.decode_keyed(jk, tdt)
    np.testing.assert_array_equal(jids, tids)
    _same(np.asarray(jvals).reshape(4, 8), tvals.reshape(4, 8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_sparse_filter_equals_jax(dtype, clip):
    import ml_dtypes

    from multiverso_tpu.quantization import SparseFilter as JF
    from multiverso_tpu_torch.quantization import SparseFilter as TF

    rng = np.random.default_rng(9)
    blobs = [_delta(rng, (40,), 0.1), _delta(rng, (30,), 0.9),
             _delta(rng, (5, 6), 0.2), np.zeros(8, np.float32)]
    blobs[0][3] = -0.0
    if dtype == "bfloat16":
        jblobs = [b.astype(ml_dtypes.bfloat16) for b in blobs]
        tblobs = [torch.from_numpy(b).to(torch.bfloat16) for b in blobs]
        jf, tf = JF(clip, dtype=ml_dtypes.bfloat16), TF(clip,
                                                         dtype=torch.bfloat16)
    else:
        jblobs = tblobs = blobs
        jf, tf = JF(clip), TF(clip)
    for skip in (False, True):
        jf.skip_option_blob = tf.skip_option_blob = skip
        jout, tout = jf.filter_in(jblobs), tf.filter_in(tblobs)
        for a, b in zip(jout, tout):
            _same(a, b)
        assert tf.compressed_ratio(tblobs, tout) == \
            jf.compressed_ratio(jblobs, jout)
        for a, b in zip(jf.filter_out(jout), tf.filter_out(jout)):
            _same(np.asarray(a).ravel(), b.ravel() if isinstance(
                b, torch.Tensor) else np.asarray(b).ravel())


def test_quantize_and_dequantize_int8_equal_jax():
    import ml_dtypes

    from multiverso_tpu import quantization as jq
    from multiverso_tpu_torch import quantization as tq

    rng = np.random.default_rng(4)
    a = rng.standard_normal((6, 5)).astype(np.float32)
    for axis in (None, 0, -2):
        jqa, js = jq.quantize_int8(a, axis)
        tqa, ts = tq.quantize_int8(a, axis)
        _same(jqa, tqa)
        _same(js, ts)
        _same(jq.dequantize_int8(jqa, js), tq.dequantize_int8(tqa, ts))
        _same(jq.dequantize_int8(jqa, js, ml_dtypes.bfloat16),
              tq.dequantize_int8(tqa, ts, torch.bfloat16))
    tb = torch.from_numpy(a).to(torch.bfloat16)
    jqa, js = jq.quantize_int8(a.astype(ml_dtypes.bfloat16))
    tqa, ts = tq.quantize_int8(tb)
    _same(jqa, tqa)
    _same(js, ts)


# -- the fence ------------------------------------------------------------------

def test_claim_epoch_and_fence_equal_jax():
    from multiverso_tpu.parallel import async_ps as jps
    from multiverso_tpu_torch.parallel import async_ps as tps

    kv_j, kv_t = FakeKV(), FakeKV()
    for _ in range(3):
        assert tps.claim_epoch(kv_t, "k") == jps.claim_epoch(kv_j, "k")
    assert kv_t.d == kv_j.d
    # claims interleave across the packages on one KV
    kv = FakeKV()
    assert [jps.claim_epoch(kv, "e"), tps.claim_epoch(kv, "e"),
            jps.claim_epoch(kv, "e")] == [1, 2, 3]
    assert tps._kv_get_int(kv, "e") == 3 and tps._kv_get_int(kv, "x", 5) == 5
    jf, tf = jps.EpochFence("j"), tps.EpochFence("t")
    for epoch in (0, 2, 1, 0, 3, 2, 3):
        assert tf.admit(epoch) == jf.admit(epoch), epoch
    assert (tf.epoch, tf.rejections) == (jf.epoch, jf.rejections) == (3, 2)


# -- tables' remote entry points ---------------------------------------------------

def test_remote_apply_entry_points_equal_jax(both):
    jmv, tmv = both
    from multiverso_tpu.updaters import AddOption as JOpt
    from multiverso_tpu_torch.updaters import AddOption as TOpt

    rng = np.random.default_rng(8)
    init = rng.standard_normal((6, 4)).astype(np.float32)
    jt = jmv.create_table("matrix", 6, 4, init_value=init, is_sparse=True,
                          num_sim_workers=2)
    tt = tmv.create_table("matrix", 6, 4, init_value=init, is_sparse=True,
                          num_sim_workers=2)
    for t in (jt, tt):
        t._remote_accum = np.zeros((6, 4), np.float32)
    d = rng.standard_normal((6, 4)).astype(np.float32)
    ids = np.array([1, 4, 1], np.int32)
    vals = rng.standard_normal((3, 4)).astype(np.float32)
    jt._apply_remote_keyed(ids, vals, JOpt(worker_id=1))
    tt._apply_remote_keyed(ids, vals, TOpt(worker_id=1))
    jt._apply_remote_dense(d, JOpt(worker_id=1))
    tt._apply_remote_dense(d, TOpt(worker_id=1))
    np.testing.assert_array_equal(tt.get(), jt.get())
    np.testing.assert_array_equal(tt._remote_accum, jt._remote_accum)
    np.testing.assert_array_equal(tt._dirty, jt._dirty)
    assert tt.version == jt.version == 2
    (tarr,), tver = tt._state_arrays()
    (jarr,), jver = jt._state_arrays()
    _same(np.asarray(jarr), tarr)
    assert tver == jver
    tt._install_state_arrays([init], 17, epoch=4)
    jt._install_state_arrays([init], 17, epoch=4)
    np.testing.assert_array_equal(tt.get(), jt.get())
    assert (tt.version, tt.epoch) == (jt.version, jt.epoch) == (17, 4)
    # a bf16 table's STATE ships its own 16-bit words
    bt = tmv.create_table("matrix", 6, 4, init_value=init,
                          dtype=torch.bfloat16)
    (barr,), _ = bt._state_arrays()
    assert barr.dtype == torch.bfloat16
    assert torch.equal(barr, bt.array.cpu())


# -- the mvparam wire (in-process, real sockets) ---------------------------------

def _stream(pub, src, rng, n_dense=3, sparse=True):
    """STATE, then dense deltas and keyed deltas (unique ids), each
    applied to ``src`` first; returns the per-delta int8 steps."""
    pub.publish_state(src)
    steps = []
    shape = (src.num_row, src.num_col)
    for i in range(n_dense):
        d = _delta(rng, shape, 0.05 if (sparse and i % 2 == 0) else 1.0)
        src.add(d)
        pub.publish_delta(src, d)
        steps.append(float(np.abs(d).max()) / 127.0)
        ids = rng.choice(src.num_row, 3, replace=False).astype(np.int32)
        vals = rng.standard_normal((3, src.num_col)).astype(np.float32)
        src.add_rows(ids, vals)
        pub.publish_keyed(src, ids, vals)
        steps.append(float(np.abs(vals).max()) / 127.0)
    return steps


def _as_f32(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("dtype,quant", [("float32", "none"),
                                         ("bfloat16", "none"),
                                         ("float32", "int8")])
def test_cross_package_stream_converges(both, direction, dtype, quant):
    """A JAX trainer's stream into two port replicas, and a port
    trainer's into two JAX replicas: bitwise (f32 and bf16, raw words),
    with the trainer's version and epoch; int8 within half a step per
    delta plus 1e-6, the JAX test's bound."""
    import jax.numpy as jnp

    jmv, tmv = both
    from multiverso_tpu.serving import ParamPublisher as JPub
    from multiverso_tpu.serving import ParamSubscriber as JSub
    from multiverso_tpu_torch.serving import ParamPublisher as TPub
    from multiverso_tpu_torch.serving import ParamSubscriber as TSub

    jdt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    if direction == "jax_to_port":
        src_mod, src_dt, Pub, dst_mod, dst_dt, Sub = (jmv, jdt, JPub, tmv,
                                                      tdt, TSub)
    else:
        src_mod, src_dt, Pub, dst_mod, dst_dt, Sub = (tmv, tdt, TPub, jmv,
                                                      jdt, JSub)
    kv = FakeKV()
    label = f"x{direction[0]}{dtype[0]}{quant[0]}"
    src = src_mod.create_table("matrix", 12, 6, dtype=src_dt,
                               init_value="random", seed=3)
    dsts = [dst_mod.create_table("matrix", 12, 6, dtype=dst_dt)
            for _ in range(2)]
    pub = Pub(kv, 3, label=label, wire_quant=quant)
    subs = [Sub(kv, {src.table_id: d}, rank=r + 1, size=3, label=label,
                poll_s=0.01) for r, d in enumerate(dsts)]
    try:
        steps = _stream(pub, src, np.random.default_rng(6))
        n = 1 + len(steps)
        for sub in subs:
            assert _wait(lambda: sub.applied == n), sub.stats()
        want = _as_f32(src.get())
        for sub, d in zip(subs, dsts):
            assert (d.version, d.epoch) == (src.version, pub.epoch)
            assert sub.stats()["fence_rejections"] == 0
            if quant == "int8":
                np.testing.assert_allclose(_as_f32(d.get()), want,
                                           atol=sum(steps) / 2 + 1e-6)
            else:
                np.testing.assert_array_equal(_as_f32(d.get()), want)
        st = pub.stats()
        assert st["publishes"] == n and st["publish_bytes"] > 0
        if quant == "none":
            assert 0.0 < st["wire_compressed_ratio"] < 1.0
    finally:
        for sub in subs:
            sub.stop()
        pub.stop()


def test_param_plane_rebase_fence_and_staleness(both):
    """The port's plane on ``tests/test_trainer_chaos.py:134-212``'s
    cases: a STATE rebase and deltas converge a replica bitwise at the
    trainer's versions; a zombie-epoch record is rejected without
    touching state; a backwards epoch-key blip never detaches the live
    stream; silence flags STALE and a fenced restart (new epoch, rebase)
    clears it, switching streams."""
    jmv, tmv = both
    from multiverso_tpu_torch.parallel.async_ps import DENSE
    from multiverso_tpu_torch.serving import ParamPublisher, ParamSubscriber

    src = tmv.create_table("matrix", 6, 4)
    dst = tmv.create_table("matrix", 6, 4)
    kv = FakeKV()
    pub = ParamPublisher(kv, 2, label="pp", epoch=2)
    sub = ParamSubscriber(kv, {src.table_id: dst}, rank=1, size=2,
                          label="pp", poll_s=0.01, stale_after_s=0.6)
    try:
        rng = np.random.default_rng(5)
        pub.publish_state(src)
        for _ in range(4):
            d = rng.standard_normal((6, 4)).astype(np.float32)
            src.add(d)
            pub.publish_delta(src, d)
        assert _wait(lambda: sub.applied == 5)
        assert sub.states_applied == 1
        assert dst.version == src.version and dst.epoch == 2
        np.testing.assert_array_equal(dst.get(), src.get())

        before = dst.get().copy()
        pub.publish_record(DENSE, src.table_id,
                           [np.full((6, 4), 99.0, np.float32)],
                           epoch=1, version=src.version + 1)
        assert _wait(lambda: sub.stats()["fence_rejections"] == 1)
        np.testing.assert_array_equal(dst.get(), before)
        assert dst.version == src.version

        kv.key_value_set("pp/epoch", "1")
        time.sleep(0.5)                      # > the epoch-probe cadence
        assert sub._cur_epoch == 2
        kv.key_value_set("pp/epoch", "2")

        assert _wait(sub.params_stale)
        from multiverso_tpu_torch.dashboard import Dashboard

        assert Dashboard.get_or_create_gauge(
            "SERVE_PARAMS_AGE[param.r1]").get() > 0.6
        pub2 = ParamPublisher(kv, 2, label="pp")    # claims epoch 3
        try:
            assert pub2.epoch == 3
            src.add(np.ones((6, 4), np.float32))
            pub2.publish_state(src)
            assert _wait(lambda: sub.stats()["epoch_switches"] == 2)
            assert _wait(lambda: dst.version == src.version)
            assert dst.epoch == 3
            np.testing.assert_array_equal(dst.get(), src.get())
            assert not sub.params_stale()
            # the zombie chaos directive stamps the old epoch from publish 2
            from multiverso_tpu_torch.serving import FaultPlan

            pub2.chaos = FaultPlan("zombie_epoch=2:2")
            v = dst.version
            src.add(np.ones((6, 4), np.float32))
            pub2.publish_delta(src, np.ones((6, 4), np.float32))
            assert _wait(lambda: sub.stats()["fence_rejections"] == 2)
            assert dst.version == v
            assert pub2.stats()["chaos"]["zombie_publishes"] == 1
        finally:
            pub2.stop()
    finally:
        sub.stop()
        pub.stop()


def test_trainer_kill_point_fires_before_the_send(both):
    """``kill_trainer_at_publish`` fires at the k-th publish with the
    record unsent."""
    jmv, tmv = both
    from multiverso_tpu_torch.serving import (FaultPlan, ParamPublisher,
                                              ParamSubscriber)

    src = tmv.create_table("matrix", 4, 2)
    dst = tmv.create_table("matrix", 4, 2)
    kv = FakeKV()
    killed = []

    class _Killed(Exception):
        pass

    def kill():
        killed.append(pub.publishes)
        raise _Killed()

    pub = ParamPublisher(kv, 2, label="pk",
                         chaos=FaultPlan("kill_trainer_at_publish=2"),
                         kill_fn=kill)
    sub = ParamSubscriber(kv, {src.table_id: dst}, rank=1, size=2,
                          label="pk", poll_s=0.01)
    try:
        pub.publish_state(src)
        src.add(np.ones((4, 2), np.float32))
        with pytest.raises(_Killed):
            pub.publish_delta(src, np.ones((4, 2), np.float32))
        assert killed == [1] and pub.publishes == 1
        assert _wait(lambda: sub.applied == 1)
        time.sleep(0.1)
        assert sub.applied == 1 and dst.version == 0
    finally:
        sub.stop()
        pub.stop()


def test_kv_records_and_stateless_tables_are_refused(both):
    """``KV`` records cross the plane both ways: a JAX trainer's ``kv``
    table (a STATE rebase, then ``publish_kv`` of adds it applied) reaches
    a port replica, and a port trainer's reaches a JAX replica, each
    replica equal to its trainer at the trainer's version and epoch. A
    STATE publish of a table without the STATE protocol, and an unknown
    wire quantizer, are still errors that say so."""
    jmv, tmv = both
    from multiverso_tpu.serving import ParamPublisher as JPub
    from multiverso_tpu.serving import ParamSubscriber as JSub
    from multiverso_tpu_torch.log import FatalError
    from multiverso_tpu_torch.serving import ParamPublisher, ParamSubscriber

    pub = ParamPublisher(FakeKV(), 2, label="pkv", epoch=1)
    try:
        with pytest.raises(FatalError, match="STATE protocol"):
            pub.publish_state(object())
    finally:
        pub.stop()
    with pytest.raises(FatalError, match="int4"):
        ParamPublisher(FakeKV(), 2, label="qbad", epoch=1, wire_quant="int4")
    for direction in ("jax_to_port", "port_to_jax"):
        src_mod, Pub, dst_mod, Sub = (
            (jmv, JPub, tmv, ParamSubscriber) if direction == "jax_to_port"
            else (tmv, ParamPublisher, jmv, JSub))
        src = src_mod.create_table("kv")
        dst = dst_mod.create_table("kv")
        src.add([3, -2], [1.5, 0.25])
        kv = FakeKV()
        label = f"kv{direction[0]}"
        pub = Pub(kv, 2, label=label, epoch=3)
        sub = Sub(kv, {src.table_id: dst}, rank=1, size=2, label=label,
                  poll_s=0.01)
        try:
            pub.publish_state(src)
            for keys, vals in (([3, 7], [0.5, 2.0]), ([2**40], [-1.0])):
                src.add(keys, vals)
                pub.publish_kv(src, keys, vals)
            assert _wait(lambda: sub.applied == 3), sub.stats()
            probe = [3, -2, 7, 2**40, 5]
            assert dst.get(probe) == src.get(probe) == [2.0, 0.25, 2.0,
                                                         -1.0, 0]
            assert (dst.version, dst.epoch) == (src.version, 3)
            assert sub.states_applied == 1
            (dk, dv), _ = dst._state_arrays()
            (sk, sv), _ = src._state_arrays()
            np.testing.assert_array_equal(dk, sk)
            np.testing.assert_array_equal(dv, sv)
        finally:
            sub.stop()
            pub.stop()


def test_snapshot_manager_params_age_and_epoch(both):
    """``tests/test_trainer_chaos.py::test_snapshot_manager_params_age``
    on the port: silence accrues age, a move resets it, 0 disables the
    verdict, and a pin carries the source's (epoch, version)."""
    jmv, tmv = both
    from multiverso_tpu_torch.serving import SnapshotManager

    t = tmv.create_table("array", 8)
    mgr = SnapshotManager.of(t)
    t.add(np.ones(8, np.float32))
    assert mgr.params_age_s() < 0.5
    assert not mgr.params_stale(10.0) and not mgr.params_stale(0.0)
    time.sleep(0.12)
    assert mgr.params_age_s() >= 0.1
    assert mgr.params_stale(0.05)
    t.add(np.ones(8, np.float32))
    assert mgr.params_age_s() < 0.1
    with t._lock:
        t.epoch = 4
    snap = mgr.publish()
    assert (snap.epoch, snap.version) == (4, t.version)
    pair = SnapshotManager.of((t.snapshot_array, lambda: t.version))
    assert pair.publish().epoch == 0
