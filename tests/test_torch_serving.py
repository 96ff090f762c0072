"""The port's serving stack on the CPU against the JAX package's oracle.

The port's InferenceServer + DecodeEngine (monolithic admission,
contiguous KV strips, every other feature off) serve requests on
``-device=cpu``; their outputs must be token-identical to the JAX
package's ``greedy_decode`` on the same weights. Also: per-request
``max_new`` and ``eos_id``, queue-cap shedding, each ported engine
feature and the JAX flag defaults building and serving (speculation,
int8 KV and int8 parameter pins on the paged layout they need, which
refuses the contiguous one), the loud refusal of every engine feature
not ported yet, the session's refusal to fall back to the CPU, and
import hygiene (no port module pulls in jax or the JAX package).
``tests/test_torch_decode_defaults.py``, ``test_torch_spec_decode.py``
and ``test_torch_quant_serving.py`` hold the ported features to the JAX
engine's contract.
"""

import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.models import transformer as jtf
from multiverso_tpu_torch.log import FatalError
from multiverso_tpu_torch.models import transformer as ttf
from multiverso_tpu_torch.serving import InferenceServer, OverloadedError

DIMS = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq=48)
# the values that turn off every engine feature this port has not got
OFF = dict(prefill_token_budget=0, kv_block_size=0, decode_tp=1,
           prefix_cache=False, spec_k=0, kv_quant="none",
           decode_param_quant="none", prefill_sp=False, preempt=False,
           flight_recorder=False, watchdog=False, cost_ledger=False)
BUCKETS = (4, 8, 16)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _model(attention="flash_force"):
    cfg = ttf.TransformerConfig(**DIMS, attention=attention)
    return cfg, ttf.TransformerLM(cfg)


def _jax_oracle(prompts, max_new, eos_id=None, attention="flash_force"):
    """One batched JAX greedy_decode over all prompts (right-padded)."""
    jcfg = jtf.TransformerConfig(**DIMS, attention=attention)
    P = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), P), np.int32)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    lengths = np.array([len(p) for p in prompts], np.int32)
    return np.asarray(jtf.greedy_decode(
        jcfg, jtf.init_params(jcfg), jnp.asarray(toks), jnp.asarray(lengths),
        max_new, eos_id=eos_id))


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, max(BUCKETS) + 1, n)
    return [rng.integers(0, DIMS["vocab_size"], int(m)) for m in lengths]


def test_server_outputs_match_jax_greedy_decode(port):
    _, lm = _model()
    srv = InferenceServer("t")
    eng = srv.register_decoder("lm", lm, slots=4, max_prompt=16, max_new=8,
                               prompt_buckets=BUCKETS, **OFF)
    prompts = _prompts(12, seed=0)
    assert len({next(b for b in BUCKETS if b >= len(p))
                for p in prompts}) >= 3
    max_news = [8 if i % 3 else 3 + i % 5 for i in range(len(prompts))]
    futs = [srv.submit("lm", {"prompt": p, "max_new": n})
            for p, n in zip(prompts, max_news)]
    replies = [f.result(timeout=120) for f in futs]
    want = _jax_oracle(prompts, 8)
    for i, (rep, n) in enumerate(zip(replies, max_news)):
        assert rep["snapshot_version"] == 0
        np.testing.assert_array_equal(rep["result"], want[i, :n])
    stats = eng.stats()
    assert stats["completed"] == 12
    assert stats["tokens"] == sum(max_news)
    assert stats["prefill_tokens"] == sum(len(p) for p in prompts)
    assert stats["peak_live_seqs"] == 4
    assert eng.ttft_hist.count == 12
    assert eng.itl_hist.count == sum(max_news) - 12


def test_engine_honors_eos(port):
    _, lm = _model()
    prompts = _prompts(6, seed=1)
    eos = int(_jax_oracle(prompts, 8)[0, 2])   # a token really emitted
    want = _jax_oracle(prompts, 8, eos_id=eos)
    srv = InferenceServer("t")
    srv.register_decoder("lm", lm, slots=2, max_prompt=16, max_new=8,
                         eos_id=eos, prompt_buckets=BUCKETS, **OFF)
    replies = [f.result(timeout=120) for f in
               [srv.submit("lm", p) for p in prompts]]
    hit = 0
    for i, rep in enumerate(replies):
        row = list(want[i])
        n = row.index(eos) + 1 if eos in row else len(row)
        hit += eos in row
        np.testing.assert_array_equal(rep["result"], want[i, :n])
    assert hit >= 1


def test_max_queue_sheds(port):
    _, lm = _model(attention="reference")
    srv = InferenceServer("t")
    eng = srv.register_decoder("lm", lm, slots=2, max_prompt=16, max_new=4,
                               max_queue=2, prompt_buckets=BUCKETS, **OFF)
    gate = threading.Event()
    entered = threading.Event()
    real_admit = eng._admit

    def wedged_admit(arrivals):
        entered.set()
        gate.wait(30)
        real_admit(arrivals)

    eng._admit = wedged_admit
    first = srv.submit("lm", [1, 2, 3])
    assert entered.wait(30)           # popped from the queue, held here
    queued = [srv.submit("lm", [4, 5]), srv.submit("lm", [6])]
    with pytest.raises(OverloadedError) as exc:
        srv.submit("lm", [7, 8, 9])
    assert exc.value.what == "queue depth" and exc.value.retriable
    gate.set()
    for f in [first] + queued:
        assert len(f.result(timeout=60)["result"]) == 4
    assert eng.stats()["shed"] == 1


def test_concurrent_submitters(port):
    """More submitting threads than cores under a short switch interval:
    every request completes exactly once, with the oracle's tokens."""
    _, lm = _model(attention="reference")
    srv = InferenceServer("t")
    eng = srv.register_decoder("lm", lm, slots=4, max_prompt=16, max_new=4,
                               prompt_buckets=BUCKETS, **OFF)
    prompts = _prompts(32, seed=3)
    want = _jax_oracle(prompts, 4, attention="reference")
    results = [None] * len(prompts)

    def worker(i):
        results[i] = srv.submit("lm", prompts[i]).result(timeout=120)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for i, rep in enumerate(results):
        np.testing.assert_array_equal(rep["result"], want[i])
    stats = eng.stats()
    assert stats["completed"] == len(prompts)
    assert stats["tokens"] == 4 * len(prompts)


UNPORTED = [
    ("decode_tp", 2), ("prefill_sp", True),
]
# each ported feature, turned on alone over OFF
PORTED = [
    ("prefill_token_budget", 32), ("kv_block_size", 16),
    ("prefix_cache", True), ("preempt", True), ("flight_recorder", True),
    ("watchdog", True), ("cost_ledger", True),
]


@pytest.mark.parametrize("flag,value", UNPORTED)
def test_unported_feature_raises(port, flag, value):
    _, lm = _model()
    srv = InferenceServer("t")
    with pytest.raises(FatalError, match=flag):
        srv.register_decoder("lm", lm, slots=2, max_prompt=16, max_new=4,
                             prompt_buckets=BUCKETS,
                             **{**OFF, flag: value})


@pytest.mark.parametrize("flag,value", PORTED)
def test_ported_feature_builds(port, flag, value):
    """Each ported feature builds and serves on its own (prefix caching
    and preemption are inert without paged + chunked, as in JAX)."""
    _, lm = _model()
    srv = InferenceServer("t")
    eng = srv.register_decoder("lm", lm, slots=2, max_prompt=16, max_new=4,
                               prompt_buckets=BUCKETS,
                               **{**OFF, flag: value})
    prompts = _prompts(3, seed=5)
    replies = [f.result(timeout=120) for f in
               [srv.submit("lm", p) for p in prompts]]
    want = _jax_oracle(prompts, 4)
    for i, rep in enumerate(replies):
        np.testing.assert_array_equal(rep["result"], want[i])
    stats = eng.stats()
    assert stats["completed"] == 3
    assert stats["step_traces"] == 1
    assert (eng.recorder is not None) == (flag == "flight_recorder")
    assert (eng.watchdog is not None) == (flag == "watchdog")
    assert (eng.ledger is not None) == (flag == "cost_ledger")
    if flag == "cost_ledger":
        assert stats["accounting_drift"] == 0
        assert eng.ledger.tenants()["default"]["completed"] == 3


# served over OFF with the paged layout in place of OFF's contiguous one
# (JAX refuses speculation and int8 KV on contiguous strips): the exact
# features are held to the oracle token for token, the int8 ones to the
# JAX argmax-match floor
SERVED = [
    ("spec_k", 2, "exact"), ("slo_ttft_ms", 50.0, "exact"),
    ("slo_itl_ms", 5.0, "exact"), ("kv_quant", "int8", "match"),
    ("decode_param_quant", "int8", "match"),
]


def _argmax_match(a, b) -> float:
    """Agreement of two generations over the longer length (the JAX
    quant tests' metric)."""
    a, b = np.asarray(a), np.asarray(b)
    n, m = min(a.size, b.size), max(a.size, b.size)
    return float((a[:n] == b[:n]).sum()) / m if m else 1.0


@pytest.mark.parametrize("flag,value,held", SERVED,
                         ids=[f"{f}-{v}" for f, v, _ in SERVED])
def test_served_feature(port, flag, value, held):
    from multiverso_tpu_torch.dashboard import Dashboard

    _, lm = _model()
    srv = InferenceServer("t")
    eng = srv.register_decoder("lm", lm, slots=2, max_prompt=16, max_new=4,
                               prompt_buckets=BUCKETS,
                               **{**OFF, "kv_block_size": 16, flag: value})
    prompts = _prompts(4, seed=8)
    replies = [f.result(timeout=120) for f in
               [srv.submit("lm", p) for p in prompts]]
    want = _jax_oracle(prompts, 4)
    if held == "exact":
        for i, rep in enumerate(replies):
            np.testing.assert_array_equal(rep["result"], want[i])
    else:
        rate = np.mean([_argmax_match(rep["result"], want[i])
                        for i, rep in enumerate(replies)])
        assert rate >= 0.7, rate
    stats = eng.stats()
    assert stats["completed"] == 4
    assert stats["step_traces"] == 1
    assert (flag == "spec_k") == ("verify_traces" in stats)
    assert (flag == "kv_quant") == ("quant_scale_blocks" in stats)
    assert (flag == "decode_param_quant") == (
        stats.get("decode_param_quant") == "int8")
    slos = {name for name, row in Dashboard.snapshot().items()
            if row["type"] == "slo"}
    want_slo = {"slo_ttft_ms": "SLO_P99[SERVE_TTFT[lm]]",
                "slo_itl_ms": "SLO_P99[SERVE_ITL[lm]]"}.get(flag)
    assert slos == ({want_slo} if want_slo else set())


def test_all_served_features_together(port):
    """Speculation, int8 KV, int8 pins and both SLOs on one engine: the
    JAX argmax-match floor against the oracle, windows verified, one
    signature per program and both SLO rows."""
    from multiverso_tpu_torch.dashboard import Dashboard

    _, lm = _model()
    srv = InferenceServer("t")
    eng = srv.register_decoder(
        "lm", lm, slots=2, max_prompt=16, max_new=16, prompt_buckets=BUCKETS,
        **{**OFF, "kv_block_size": 16, "prefill_token_budget": 16,
           "spec_k": 2, "kv_quant": "int8", "decode_param_quant": "int8",
           "slo_ttft_ms": 50.0, "slo_itl_ms": 5.0})
    rng = np.random.default_rng(9)
    prompts = [np.tile(rng.integers(0, DIMS["vocab_size"], 3), 4)[:n]
               for n in (12, 7, 10, 5)]
    replies = [f.result(timeout=120) for f in
               [srv.submit("lm", p) for p in prompts]]
    want = _jax_oracle(prompts, 16)
    rate = np.mean([_argmax_match(rep["result"], want[i])
                    for i, rep in enumerate(replies)])
    assert rate >= 0.7, rate
    stats = eng.stats()
    assert stats["spec_steps"] > 0, "no window was verified"
    assert stats["step_traces"] == stats["prefill_traces"] == 1
    assert stats["verify_traces"] == 1 and stats["pin_copies"] == 1
    assert stats["kv_quant"] == stats["decode_param_quant"] == "int8"
    rows = {n for n, r in Dashboard.snapshot().items() if r["type"] == "slo"}
    assert rows == {"SLO_P99[SERVE_TTFT[lm]]", "SLO_P99[SERVE_ITL[lm]]"}


@pytest.mark.parametrize("flag,value", [("spec_k", 2), ("kv_quant", "int8")])
def test_paged_only_feature_refuses_contiguous_kv(port, flag, value):
    _, lm = _model()
    srv = InferenceServer("t")
    with pytest.raises(FatalError, match=flag):
        srv.register_decoder("lm", lm, slots=2, max_prompt=16, max_new=4,
                             prompt_buckets=BUCKETS,
                             **{**OFF, flag: value})


def test_engine_builds_at_jax_flag_defaults(port):
    """With no feature flag passed, the engine takes the JAX package's
    defaults (chunked prefill, paged KV, prefix cache, preemption,
    recorder, watchdog) and serves token-identically to JAX."""
    _, lm = _model()
    srv = InferenceServer("t")
    eng = srv.register_decoder("lm", lm, max_prompt=16, max_new=4)
    stats = eng.stats()
    assert (stats["prefill_token_budget"], stats["kv_block_size"]) == \
        (16, 16)                      # the 32 budget, clamped to max_prompt
    assert stats["prefix_cache"] == stats["preempt"] == 1
    assert eng.recorder is not None and eng.watchdog is not None
    prompts = _prompts(6, seed=6)
    replies = [f.result(timeout=120) for f in
               [srv.submit("lm", p) for p in prompts]]
    want = _jax_oracle(prompts, 4)
    for i, rep in enumerate(replies):
        np.testing.assert_array_equal(rep["result"], want[i])


@pytest.mark.parametrize("key,value", [("priority", 2), ("deadline_s", 30.0),
                                       ("tenant", "acme")])
def test_ported_payload_keys_served(port, key, value):
    _, lm = _model()
    srv = InferenceServer("t")
    eng = srv.register_decoder("lm", lm, slots=2, max_prompt=16, max_new=4,
                               cost_ledger=key == "tenant")
    prompt = _prompts(1, seed=7)[0]
    rep = srv.submit("lm", {"prompt": prompt, key: value}).result(timeout=120)
    np.testing.assert_array_equal(rep["result"], _jax_oracle([prompt], 4)[0])
    if key == "tenant":
        row = eng.ledger.tenants()[value]
        assert row["completed"] == 1 and row["decode_tokens"] == 4
        assert row["prefill_tokens"] == len(prompt)


def test_init_without_cpu_flag_refuses_to_fall_back():
    """On a host with no CUDA device the default -device=cuda is an error,
    never a silent run on the CPU."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.runtime import Session

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the refusal needs none")
    Session._instance = None
    mv.set_flag("device", "cuda")
    try:
        with pytest.raises(FatalError, match="-device=cpu"):
            mv.init(["test"])
        assert not Session.get().started
    finally:
        Session._instance = None


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import multiverso_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'multiverso_tpu', 'tensorstore', 'fsspec', 'orbax'))\n"
        "assert len(names) >= 43, names\n"
        "for m in ('block_pool', 'flight_recorder', 'watchdog', "
        "'decode_engine', 'batcher', 'workloads', 'snapshot', 'server', "
        "'faultinject', 'kv_transfer', 'accounting', 'replica', "
        "'router', 'obs_plane', 'param_plane', 'trainer_chaos'):\n"
        "    assert 'multiverso_tpu_torch.serving.' + m in names, m\n"
        "for m in ('quantization', 'dashboard', 'parallel.p2p', "
        "'parallel.async_ps', 'io', 'io.stream', 'parallel.async_buffer', "
        "'tables.sparse_table', 'tables.kv_table', 'models.logreg', "
        "'apps.logreg', 'apps.lr_reader', 'io.wal', 'io.checkpoint', "
        "'io.remote', 'topology', 'parallel.ssp', 'parallel.health'):\n"
        "    assert 'multiverso_tpu_torch.' + m in names, m\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
