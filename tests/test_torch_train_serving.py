"""Train-while-serving in the port, on the CPU.

The interleavings of ``tests/test_decode_engine.py`` (snapshot pinning
while ``train_batch`` races) and ``tests/test_serving.py`` (snapshot
consistency under concurrent table adds, through the micro-batcher):

* every decode reply equals JAX ``greedy_decode`` run on the snapshot of
  the ``snapshot_version`` the reply reports (the published parameters
  carried into JAX), with plain and speculative decode and an int8 pin
  alike, and the pin moves only at a drain;
* the pin's copy (and an int8 pin's quantization) happens once per
  version: a forced re-publish of the same version copies nothing;
* a micro-batched read of a table that a writer thread keeps adding to
  is never torn, its version never goes back, and its staleness stays
  within the bound.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.models import transformer as jtf
from multiverso_tpu_torch.models import transformer as ttf
from multiverso_tpu_torch.serving import InferenceServer

DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=48)


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


def _jax_oracle(params, prompt, max_new):
    """JAX ``greedy_decode`` on a port parameter dict carried into JAX."""
    host = {k: ({n: jnp.asarray(w.detach().cpu().numpy())
                 for n, w in v.items()} if isinstance(v, dict)
                else jnp.asarray(v.detach().cpu().numpy()))
            for k, v in params.items()}
    return np.asarray(jtf.greedy_decode(
        jtf.TransformerConfig(**DIMS), host,
        jnp.asarray(np.asarray(prompt, np.int32)[None]),
        jnp.asarray([len(prompt)]), max_new))[0]


@pytest.mark.parametrize("knobs", [{}, {"spec_k": 2},
                                   {"decode_param_quant": "int8"}],
                         ids=["plain", "spec_k-2", "param_int8"])
def test_engine_pins_snapshot_per_generation(port, knobs):
    """While ``train_batch`` races, every reply matches the oracle run on
    the version it reports (the int8 pin against its own dequantized
    parameters), and the pin moves only when the engine drains."""
    lm = ttf.TransformerLM(ttf.TransformerConfig(**DIMS))
    srv = InferenceServer("t")
    engine = srv.register_decoder("lm", lm, slots=4, max_prompt=6,
                                  max_new=8, max_staleness_s=0.0, **knobs)
    engine.warmup()
    published = {0: lm.snapshot_params()[0]}
    orig_publish = engine._manager.publish

    def publish():
        snap = orig_publish()
        published[snap.version] = snap.value
        return snap

    engine._manager.publish = publish
    stop = threading.Event()

    def trainer():
        rng = np.random.default_rng(9)
        while not stop.is_set():
            lm.train_batch(rng.integers(0, DIMS["vocab_size"], (2, 12)))

    t = threading.Thread(target=trainer, daemon=True)
    t.start()
    checked = set()
    try:
        rng = np.random.default_rng(5)
        for _ in range(4):
            reqs = [rng.integers(1, DIMS["vocab_size"],
                                 int(rng.integers(1, 7))) for _ in range(6)]
            futs = [srv.submit("lm", p) for p in reqs]
            for prompt, fut in zip(reqs, futs):
                reply = fut.result(timeout=120)
                ver = reply["snapshot_version"]
                assert ver in published, ver
                params = published[ver]
                if knobs.get("decode_param_quant") == "int8":
                    from multiverso_tpu_torch.serving.snapshot import \
                        quantize_decode_params
                    params = ttf.dequantize_decode_params(
                        quantize_decode_params(params))
                np.testing.assert_array_equal(
                    reply["result"], _jax_oracle(params, prompt, 8),
                    err_msg=f"torn generation at version {ver}")
                checked.add(ver)
    finally:
        stop.set()
        t.join(timeout=30)
    stats = engine.stats()
    assert stats["snapshot_publishes"] >= 1
    assert len(checked) >= 2, "the pin never moved while training ran"
    assert stats["step_traces"] == 1
    assert stats["pin_copies"] <= stats["snapshot_publishes"] + 1


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_pin_replica_memoized_on_snapshot_version(port, quant):
    lm = ttf.TransformerLM(ttf.TransformerConfig(**DIMS))
    srv = InferenceServer("t")
    engine = srv.register_decoder("lm", lm, slots=2, max_prompt=6,
                                  max_new=4, decode_param_quant=quant)
    engine.warmup()
    assert engine.pin_copies == 1
    prompt = np.array([3, 5, 7])
    srv.submit("lm", prompt).result(timeout=120)
    assert engine.pin_copies == 1
    # a forced re-publish of the same version copies nothing
    engine._manager.publish()
    srv.submit("lm", prompt).result(timeout=120)
    assert engine.pin_copies == 1
    lm.train_batch(np.ones((2, 12), np.int64))
    time.sleep(engine.config.max_staleness_s + 0.05)
    reply = srv.submit("lm", prompt).result(timeout=120)
    assert engine.pin_copies == 2
    assert reply["snapshot_version"] == lm.version
    pinned = engine._pinned["embed"]
    if quant == "int8":
        assert pinned["q"].dtype == torch.int8
    else:
        assert pinned.dtype == torch.float32


def test_snapshot_consistency_under_concurrent_adds(port):
    """Uniform whole-table adds race the micro-batched read path: a torn
    reply would mix two versions' values."""
    rows, cols = 32, 16
    table = port.create_table("matrix", rows, cols)
    bound = 0.1

    class Rows:
        source = table

        def run(self, payloads, bucket, snap):
            arr = snap.value.cpu().numpy()[:rows]
            return [arr[p] for p in payloads]

    srv = InferenceServer("t")
    srv.register("rows", Rows(), max_batch=4, deadline_ms=1.0,
                 max_staleness_s=bound)
    stop = threading.Event()

    def writer():
        delta = np.ones((rows, cols), np.float32)
        while not stop.is_set():
            table.add(delta)

    w = threading.Thread(target=writer, daemon=True)
    w.start()
    try:
        deadline = time.monotonic() + 5.0
        while table.version < 3:
            assert time.monotonic() < deadline, "the writer never ran"
            time.sleep(0.005)
        last_version = -1
        for i in range(60):
            reply = srv.predict("rows", i % rows, timeout_s=30)
            row = np.asarray(reply["result"])
            assert np.unique(row).size == 1, f"torn read: {row}"
            assert float(row[0]) == int(row[0])
            assert reply["staleness_s"] <= bound + 0.02
            assert reply["snapshot_version"] >= last_version
            last_version = reply["snapshot_version"]
    finally:
        stop.set()
        w.join(timeout=10)
    entry = srv._entry("rows")
    assert entry.manager.publishes >= 1
    assert entry.manager.params_age_s() >= 0.0
    assert not entry.manager.params_stale(0.0)
