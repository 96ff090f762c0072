"""The port's decode engine at the JAX package's default flags, on the CPU.

The engine built with no feature flags serves chunked (budget 32), paged
(block 16), prefix-cached and preemptive admission with the flight
recorder and the watchdog on. Its outputs must be token-identical to the
JAX package's ``greedy_decode`` on the same f32 parameters (carried across
with ``params_from_jax``), in all four layouts {monolithic, chunked} x
{contiguous, paged}, with the prefix cache on and off and under forced
preemption; each program keeps one signature. The JAX engine's own
contract cases (``tests/test_decode_engine.py``, ``tests/test_overload.py``)
run on the port with the same inputs and assert the same counts.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.models import transformer as jtf
from multiverso_tpu_torch.models import transformer as ttf
from multiverso_tpu_torch.serving import (DeadlineExceededError,
                                          InferenceServer, OverloadedError)

DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=48)
# the four admission layouts: (prefill_token_budget, kv_block_size)
LAYOUTS = {"chunked_paged": (None, None), "chunked_contiguous": (None, 0),
           "monolithic_paged": (0, None), "monolithic_contiguous": (0, 0)}


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
def jax_params():
    return jtf.init_params(jtf.TransformerConfig(**DIMS))


def _model(jax_params):
    """A port LM whose parameters are the JAX ones, carried across."""
    lm = ttf.TransformerLM(ttf.TransformerConfig(**DIMS))
    host = {"embed": np.asarray(jax_params["embed"]),
            "pos": np.asarray(jax_params["pos"]),
            "ln_f_g": np.asarray(jax_params["ln_f_g"]),
            "layers": {k: np.asarray(v)
                       for k, v in jax_params["layers"].items()}}
    carried = ttf.params_from_jax(host, device="cpu")
    with torch.no_grad():
        for name, w in lm.params.items():
            if isinstance(w, dict):
                for k, t in w.items():
                    t.copy_(carried[name][k])
            else:
                w.copy_(carried[name])
    return lm


def _oracle(jax_params, prompts, max_new, eos_id=None):
    """JAX ``greedy_decode`` over all prompts in one right-padded batch;
    row i cut to its ``max_new`` (an int or one per prompt) and at eos."""
    news = [max_new] * len(prompts) if np.isscalar(max_new) else max_new
    P = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), P), np.int32)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    lengths = np.array([len(p) for p in prompts], np.int32)
    out = np.asarray(jtf.greedy_decode(
        jtf.TransformerConfig(**DIMS), jax_params, jnp.asarray(toks),
        jnp.asarray(lengths), max(news), eos_id))
    rows = []
    for row, n in zip(out, news):
        row = row[:n]
        if eos_id is not None and eos_id in row:
            row = row[: list(row).index(eos_id) + 1]
        rows.append(row)
    return rows


def _prompts(rng, lens):
    return [rng.integers(1, DIMS["vocab_size"], int(n)) for n in lens]


def _serve(srv, name, prompts, max_new, **payload):
    news = [max_new] * len(prompts) if np.isscalar(max_new) else max_new
    futs = [srv.submit(name, {"prompt": p, "max_new": int(n), **payload})
            for p, n in zip(prompts, news)]
    return [f.result(timeout=120)["result"] for f in futs]


def _settle(eng):
    """Stats once the last iteration is recorded: a future resolves
    inside its iteration, before the iteration's record lands."""
    deadline = time.monotonic() + 10
    while True:
        s = eng.stats()
        if (s["live_seqs"] == 0 and s["queue_depth"] == 0
                and s["flight_records"] == s["iters_total"]):
            return s
        assert time.monotonic() < deadline, s
        time.sleep(0.005)


def _assert_equal_rows(got, want, what=""):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{what} request {i}")


def test_defaults_match_jax_across_chunk_and_block_boundaries(port,
                                                              jax_params):
    """No feature flags: budget 32, block 16, prefix cache, preemption,
    recorder and watchdog on. Prompt lengths straddle the block (16, 32)
    and chunk (32) boundaries; every output is the JAX oracle's, each
    program has one signature, and the books balance after the drain."""
    lm = _model(jax_params)
    srv = InferenceServer("t")
    eng = srv.register_decoder("lm", lm, slots=4, max_prompt=40, max_new=8)
    s = eng.stats()
    assert (s["prefill_token_budget"], s["kv_block_size"],
            s["prefix_cache"], s["preempt"]) == (32, 16, 1, 1)
    assert eng.recorder is not None and eng.watchdog is not None
    rng = np.random.default_rng(0)
    lens = [1, 15, 16, 17, 31, 32, 33, 40]
    lens += [int(n) for n in rng.integers(1, 41, 8)]
    prompts = _prompts(rng, lens)
    news = [int(n) for n in rng.integers(1, 9, len(prompts))]
    got = _serve(srv, "lm", prompts, news)
    _assert_equal_rows(got, _oracle(jax_params, prompts, news))
    s = _settle(eng)
    assert s["step_traces"] == s["prefill_traces"] == 1
    assert s["completed"] == len(prompts)
    assert s["tokens"] == sum(news)
    assert s["prefill_tokens"] == sum(lens)
    assert s["kv_blocks_live"] == 0 and eng.pool_drift() is None
    eng._pool.check()
    assert s["watchdog_trips"] == 0
    assert s["flight_records"] == s["iters_total"] > 0


def test_block_tables_upload_only_when_changed(port, jax_params):
    """One request whose generation stays inside its first block: the
    admission changes the tables once (one upload, read by the chunk),
    and the 7 decode steps upload nothing."""
    lm = _model(jax_params)
    srv = InferenceServer("t")
    eng = srv.register_decoder("lm", lm, slots=4, max_prompt=16, max_new=8)
    prompt = np.random.default_rng(1).integers(1, DIMS["vocab_size"], 4)
    _assert_equal_rows(_serve(srv, "lm", [prompt], 8),
                       _oracle(jax_params, [prompt], 8))
    s = _settle(eng)
    assert s["iters_total"] == 7 and s["block_table_uploads"] == 1


def test_four_layouts_identical_outputs(port, jax_params):
    lm = _model(jax_params)
    srv = InferenceServer("t")
    engines = {
        name: srv.register_decoder(
            name, lm, slots=3, max_prompt=16, max_new=6,
            prompt_buckets=(16,), prefill_token_budget=budget,
            kv_block_size=bs, prefix_cache=False)
        for name, (budget, bs) in LAYOUTS.items()}
    rng = np.random.default_rng(12)
    prompts = _prompts(rng, rng.integers(1, 17, 10))
    want = _oracle(jax_params, prompts, 6)
    for name, eng in engines.items():
        _assert_equal_rows(_serve(srv, name, prompts, 6), want, name)
        assert eng.step_cache_size() == 1, name
        assert eng.prefill_cache_size() == 1, name


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_one_signature_per_program(port, jax_params, layout):
    """Slot, offset, length, positions and block tables are tensors of
    fixed shape: a served run with every prompt length, warmup included,
    keeps each program at one signature."""
    budget, bs = LAYOUTS[layout]
    lm = _model(jax_params)
    srv = InferenceServer("t")
    eng = srv.register_decoder("lm", lm, slots=2, max_prompt=8, max_new=4,
                               prompt_buckets=(8,),
                               prefill_token_budget=budget,
                               kv_block_size=bs, kv_pool_blocks=8)
    eng.warmup()
    rng = np.random.default_rng(9)
    prompts = _prompts(rng, range(1, 9))
    _assert_equal_rows(_serve(srv, "lm", prompts, 4),
                       _oracle(jax_params, prompts, 4), layout)
    assert eng.step_cache_size() == 1
    assert eng.prefill_cache_size() == 1


@pytest.mark.parametrize("bs", [16, 0])
def test_chunk_pad_tail_past_cache_end_is_dropped(port, jax_params, bs):
    """The JAX regression case: max_prompt 10, max_new 1, budget 4, so
    the final chunk's pad tail of a 9- or 10-token prompt runs past the
    cache end (T = 11) and must not corrupt prompt K/V."""
    lm = _model(jax_params)
    srv = InferenceServer("t")
    srv.register_decoder("lm", lm, slots=2, max_prompt=10, max_new=1,
                         prefill_token_budget=4, kv_block_size=bs)
    rng = np.random.default_rng(6)
    prompts = _prompts(rng, (9, 10))
    _assert_equal_rows(_serve(srv, "lm", prompts, 1),
                       _oracle(jax_params, prompts, 1))


def _prefix_engines(srv, lm, **kw):
    return {label: srv.register_decoder(
        f"lm_{label}", lm, prefix_cache=on, **kw)
        for label, on in (("on", True), ("off", False))}


def test_prefix_cache_shared_prefix_bit_exact_vs_cache_off(port,
                                                           jax_params):
    lm = _model(jax_params)
    srv = InferenceServer("t")
    engines = _prefix_engines(srv, lm, slots=4, max_prompt=16, max_new=8,
                              kv_block_size=4, prefill_token_budget=4)
    rng = np.random.default_rng(21)
    shared = rng.integers(1, DIMS["vocab_size"], 8)      # 2 blocks
    prompts = [shared]
    for _ in range(6):
        tail = rng.integers(1, DIMS["vocab_size"], int(rng.integers(1, 9)))
        prompts.append(np.concatenate([shared, tail]))
    prompts.append(shared.copy())                        # the full hit
    want = _oracle(jax_params, prompts, 6)
    outs = {label: _serve(srv, f"lm_{label}", prompts, 6)
            for label in engines}
    for label in engines:
        _assert_equal_rows(outs[label], want, f"cache {label}")
    on, off = engines["on"].stats(), engines["off"].stats()
    assert on["prefix_hits"] > 0 and on["prefill_tokens_saved"] > 0
    assert 0.0 < on["prefix_hit_rate"] <= 1.0
    assert on["cow_copies"] >= 1
    assert off["prefix_hits"] == off["prefill_tokens_saved"] == 0
    assert on["prefill_tokens"] < off["prefill_tokens"]
    assert on["tokens"] == off["tokens"]
    for e in engines.values():
        assert e.step_cache_size() == e.prefill_cache_size() == 1
    assert engines["on"]._cow_fn.cache_size() == 1
    engines["on"]._pool.check()
    assert engines["on"].pool_drift() is None


def test_prefix_cache_cow_divergence(port, jax_params):
    """Serial submits: exact repeats are full hits (copy-on-write of the
    last block), a prompt diverging inside block 1 shares block 0 only,
    a longer one shares both. The counts follow from the inputs."""
    lm = _model(jax_params)
    srv = InferenceServer("t")
    eng = srv.register_decoder("lm", lm, slots=2, max_prompt=12, max_new=6,
                               kv_block_size=4, prefill_token_budget=4)
    rng = np.random.default_rng(31)
    base = rng.integers(1, DIMS["vocab_size"], 8)
    diverged = base.copy()
    diverged[6] = (diverged[6] % (DIMS["vocab_size"] - 1)) + 1
    longer = np.concatenate([base, rng.integers(1, DIMS["vocab_size"], 3)])
    cases = [base, base.copy(), diverged, base.copy(), longer,
             diverged.copy()]
    want = _oracle(jax_params, cases, 6)
    for i, p in enumerate(cases):
        got = srv.submit("lm", {"prompt": p, "max_new": 6}).result(
            timeout=120)["result"]
        np.testing.assert_array_equal(got, want[i], err_msg=f"case {i}")
    s = eng.stats()
    # base: 2 misses; repeat: 2 hits, a full hit (CoW); diverged: 1 hit
    # 1 miss; repeat: 2 hits (CoW); longer: 2 hits, not full; diverged
    # again: 2 hits, a full hit (CoW)
    assert s["cow_copies"] == 3
    assert (s["prefix_hits"], s["prefix_misses"]) == (9, 3)
    eng._pool.check()
    assert eng.pool_drift() is None


def test_prefix_cache_eviction_under_pressure_stays_exact(port, jax_params):
    lm = _model(jax_params)
    srv = InferenceServer("t")
    eng = srv.register_decoder("lm", lm, slots=2, max_prompt=8, max_new=6,
                               kv_block_size=4, kv_pool_blocks=4,
                               prefill_token_budget=4)
    rng = np.random.default_rng(41)
    distinct = _prompts(rng, [8] * 4)
    order = [0, 1, 2, 3, 0, 2, 1, 3]
    want = _oracle(jax_params, distinct, 4)
    for i in order:
        got = srv.submit("lm", {"prompt": distinct[i], "max_new": 4}).result(
            timeout=120)["result"]
        np.testing.assert_array_equal(got, want[i], err_msg=f"prefix {i}")
    s = eng.stats()
    assert s["prefix_evictions"] > 0, "pool never came under pressure"
    assert s["kv_blocks_live"] == 0
    eng._pool.check()
    assert eng.pool_drift() is None


def test_prefix_cache_gate_counts_cached_hits_against_supply(port,
                                                             jax_params):
    """Pool 4: a live occupant holds 1 block, 2 cached prefix blocks, 1
    free; a prompt hitting both cached blocks whose reservation needs 4
    must queue until the occupant completes, then succeed."""
    lm = _model(jax_params)
    srv = InferenceServer("t")
    eng = srv.register_decoder("lm", lm, slots=2, max_prompt=12, max_new=4,
                               kv_block_size=4, kv_pool_blocks=4,
                               prefill_token_budget=4)
    rng = np.random.default_rng(61)
    prefix = rng.integers(1, DIMS["vocab_size"], 8)
    srv.submit("lm", {"prompt": prefix, "max_new": 2}).result(timeout=120)
    assert eng._pool.n_cached == 2
    occ = srv.submit("lm", {"prompt": prefix[:1], "max_new": 3})
    victim_prompt = np.concatenate(
        [prefix, rng.integers(1, DIMS["vocab_size"], 4)])
    victim = srv.submit("lm", {"prompt": victim_prompt, "max_new": 4})
    want = _oracle(jax_params, [prefix[:1], victim_prompt], [3, 4])
    np.testing.assert_array_equal(occ.result(timeout=120)["result"], want[0])
    np.testing.assert_array_equal(victim.result(timeout=120)["result"],
                                  want[1])
    assert eng.stats()["prefix_hits"] >= 2
    eng._pool.check()
    assert eng.pool_drift() is None


def test_prefix_cache_full_pool_full_hit_resubmit_never_deadlocks(
        port, jax_params):
    lm = _model(jax_params)
    srv = InferenceServer("t")
    eng = srv.register_decoder("lm", lm, slots=2, max_prompt=8, max_new=8,
                               kv_block_size=4, kv_pool_blocks=4,
                               prefill_token_budget=4)
    rng = np.random.default_rng(71)
    prompt = rng.integers(1, DIMS["vocab_size"], 8)
    want = _oracle(jax_params, [prompt], 8)[0]
    for attempt in range(3):
        got = srv.submit("lm", {"prompt": prompt, "max_new": 8}).result(
            timeout=120)["result"]
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"resubmission {attempt}")
    s = eng.stats()
    # the second submission is a full hit (CoW); its decode growth then
    # evicts the copied block's cached source, so the third hits block 0
    # only
    assert s["cow_copies"] == 1 and s["shed"] == 0
    eng._pool.check()
    assert eng.pool_drift() is None


@pytest.mark.parametrize("budget", [3, 0])
def test_eos_at_first_token_slot_never_goes_live(port, jax_params, budget):
    lm = _model(jax_params)
    rng = np.random.default_rng(3)
    probe = rng.integers(1, DIMS["vocab_size"], 5)
    eos = int(_oracle(jax_params, [probe], 1)[0][0])
    srv = InferenceServer("t")
    eng = srv.register_decoder("lm", lm, slots=1, max_prompt=8, max_new=10,
                               eos_id=eos, prefill_token_budget=budget)
    out = srv.submit("lm", probe).result(timeout=120)["result"]
    np.testing.assert_array_equal(out, [eos])
    s = eng.stats()
    assert s["active_slots"] == 0 and s["completed"] == 1
    assert s["tokens"] == 1 and s["queue_depth"] == 0
    assert s["kv_blocks_live"] == 0
    prompts = _prompts(rng, rng.integers(1, 9, 4))
    want = _oracle(jax_params, prompts, 10, eos)
    for i, p in enumerate(prompts):
        got = srv.submit("lm", p).result(timeout=120)["result"]
        np.testing.assert_array_equal(got, want[i], err_msg=f"{budget} {i}")
    assert eng.stats()["active_slots"] == 0


def test_paged_out_of_blocks_sheds_and_never_deadlocks(port, jax_params):
    lm = _model(jax_params)
    srv = InferenceServer("t")
    eng = srv.register_decoder("lm", lm, slots=2, max_prompt=4, max_new=8,
                               kv_block_size=4, kv_pool_blocks=2,
                               preempt=False)
    rng = np.random.default_rng(8)
    big = rng.integers(1, DIMS["vocab_size"], 4)
    with pytest.raises(OverloadedError) as exc:
        srv.submit("lm", {"prompt": big, "max_new": 8})
    assert exc.value.what == "kv block pool" and not exc.value.retriable
    assert exc.value.depth == 3 and exc.value.cap == 2
    prompts = _prompts(rng, [2, 2, 2])
    _assert_equal_rows(_serve(srv, "lm", prompts, 4),
                       _oracle(jax_params, prompts, 4))
    s = eng.stats()
    assert s["shed"] == 1 and s["completed"] == 3
    assert s["peak_live_seqs"] == 1        # the pool serialized them
    assert s["kv_blocks_live"] == 0
    assert s["kv_blocks_free"] == s["kv_pool_blocks"] == 2
    assert s["block_allocs"] == s["block_frees"] == 6


def test_failure_path_returns_shared_blocks(port, jax_params):
    lm = _model(jax_params)
    srv = InferenceServer("t")
    eng = srv.register_decoder("lm", lm, slots=4, max_prompt=12, max_new=8,
                               kv_block_size=4, prefill_token_budget=4)
    rng = np.random.default_rng(51)
    shared = rng.integers(1, DIMS["vocab_size"], 8)
    srv.submit("lm", {"prompt": shared, "max_new": 2}).result(timeout=120)

    def boom(*a, **k):
        raise RuntimeError("injected step failure")

    real = eng._step_fn
    eng._step_fn = boom
    futs = [srv.submit("lm", {"prompt": np.concatenate([shared, [7 + i]]),
                              "max_new": 4}) for i in range(2)]
    for f in futs:
        with pytest.raises(RuntimeError):
            f.result(timeout=60)
    eng._step_fn = real
    assert eng.stats()["kv_blocks_live"] == 0
    eng._pool.check()


# -- preemption, priorities and deadlines (tests/test_overload.py) ----------

@pytest.mark.parametrize("prefix,spec_k", [
    pytest.param(True, 0, id="True"), pytest.param(False, 0, id="False"),
    pytest.param(True, 2, id="True-spec_k-2")])
def test_preemption_oracle_bit_identical(port, jax_params, prefix, spec_k):
    """4 slots x optimistic 2-block prompt reservations fill the 8-block
    pool; every generation crosses block boundaries, so growth must
    preempt (with speculation, growth covers each slot's whole window).
    Outputs are the un-preempted oracle's, the books balance after every
    preemption, and each program keeps one signature."""
    lm = _model(jax_params)
    srv = InferenceServer("t")
    eng = srv.register_decoder(
        "lm", lm, slots=4, max_prompt=8, max_new=16, kv_block_size=4,
        kv_pool_blocks=8, prefill_token_budget=4, prefix_cache=prefix,
        spec_k=spec_k, max_queue=64)
    drift_after = []
    orig = eng._preempt

    def checked(req, why=""):
        orig(req, why)
        drift_after.append(eng._pool.drift())

    eng._preempt = checked
    rng = np.random.default_rng(23)
    reqs, futs = [], []
    for _ in range(14):
        prompt = rng.integers(1, DIMS["vocab_size"], int(rng.integers(4, 9)))
        max_new = int(rng.integers(8, 17))
        reqs.append((prompt, max_new))
        futs.append(srv.submit("lm", {"prompt": prompt, "max_new": max_new,
                                      "priority": int(rng.integers(0, 3))}))
    want = _oracle(jax_params, [p for p, _ in reqs], [n for _, n in reqs])
    _assert_equal_rows([f.result(timeout=180)["result"] for f in futs],
                       want, f"prefix={prefix}")
    s = eng.stats()
    assert s["preemptions"] > 0, "pool never pressured; geometry bug"
    assert s["preempted"] > 0
    assert all(msg is None for msg in drift_after), drift_after
    assert s["step_traces"] == s["prefill_traces"] == 1
    assert s["completed"] == len(reqs)
    assert s["kv_blocks_live"] == 0
    if spec_k:
        assert s["verify_traces"] == 1
    eng._pool.check()


def test_livelock_two_oversized_requests_terminate(port, jax_params):
    lm = _model(jax_params)
    srv = InferenceServer("t")
    eng = srv.register_decoder(
        "lm", lm, slots=2, max_prompt=8, max_new=16, kv_block_size=4,
        kv_pool_blocks=8, prefill_token_budget=4, preempt_budget=3)
    rng = np.random.default_rng(5)
    prompts = _prompts(rng, [8, 8])
    _assert_equal_rows(_serve(srv, "lm", prompts, 16),
                       _oracle(jax_params, prompts, 16))
    s = eng.stats()
    assert s["preemptions"] > 0
    assert s["preemptions"] <= 2 * (3 + 1)
    assert s["kv_blocks_live"] == 0
    eng._pool.check()


def test_starvation_bound_low_priority_completes(port, jax_params):
    lm = _model(jax_params)
    srv = InferenceServer("t")
    srv.register_decoder("lm", lm, slots=2, max_prompt=8, max_new=8,
                         kv_block_size=4, prefill_token_budget=4,
                         max_queue=64)
    rng = np.random.default_rng(11)
    order, lock = [], threading.Lock()

    def tag(label):
        def cb(_f):
            with lock:
                order.append(label)
        return cb

    flood = []
    for i in range(12):
        f = srv.submit("lm", {"prompt": rng.integers(1, 64, 6),
                              "max_new": 8, "priority": 7})
        f.add_done_callback(tag(f"hi{i}"))
        flood.append(f)
    low = srv.submit("lm", {"prompt": rng.integers(1, 64, 6), "max_new": 8,
                            "priority": 0})
    low.add_done_callback(tag("low"))
    low.result(timeout=120)
    for f in flood:
        f.result(timeout=120)
    with lock:
        assert order.index("low") < len(flood), order


def test_deadline_dropped_at_pop_burns_no_prefill(port, jax_params):
    from multiverso_tpu_torch.dashboard import Dashboard

    lm = _model(jax_params)
    srv = InferenceServer("t")
    eng = srv.register_decoder("lm", lm, slots=1, max_prompt=8, max_new=24,
                               kv_block_size=4, prefill_token_budget=4,
                               max_queue=16)
    orig_step = eng._step_fn

    def slow_step(*a):
        time.sleep(0.003)
        return orig_step(*a)

    eng._step_fn = slow_step
    rng = np.random.default_rng(3)
    p0 = rng.integers(1, DIMS["vocab_size"], 8)
    occupant = srv.submit("lm", {"prompt": p0, "max_new": 24})
    deadline = time.monotonic() + 10
    while not eng._active.any():
        assert time.monotonic() < deadline
        time.sleep(0.002)
    doomed = [srv.submit("lm", {"prompt": p0, "max_new": 4,
                                "deadline_s": 0.005}) for _ in range(3)]
    occupant.result(timeout=120)
    for fut in doomed:
        with pytest.raises(DeadlineExceededError):
            fut.result(timeout=60)
    eng._step_fn = orig_step
    s = eng.stats()
    assert s["deadline_drops"] == 3
    assert Dashboard.snapshot()["DEADLINE_DROPS[lm]"]["value"] >= 3
    assert eng.prefill_tokens == len(p0)
    assert s["completed"] == 1


def test_submit_validates_priority_and_deadline(port, jax_params):
    lm = _model(jax_params)
    srv = InferenceServer("t")
    srv.register_decoder("lm", lm, slots=1, max_prompt=4, max_new=4,
                         kv_block_size=4, prefill_token_budget=4)
    p = np.ones(2, np.int64)
    for bad in ({"priority": 9}, {"priority": -1}, {"deadline_s": 0.0},
                {"deadline_s": -1.0}):
        with pytest.raises(ValueError):
            srv.submit("lm", {"prompt": p, **bad})


def test_prio_queue_weighted_fair_and_lookahead():
    from multiverso_tpu_torch.serving.decode_engine import (_PrioQueue,
                                                            _Request)

    def req(priority, deadline=None):
        return _Request(np.ones(2, np.int64), 4, priority=priority,
                        deadline=deadline)

    q = _PrioQueue("t", lookahead=4)
    for _ in range(4):
        q.append(req(2))
    for _ in range(4):
        q.append(req(0))
    now = time.monotonic()
    got = []
    while len(q):
        r, expired = q.pop_admissible(now, lambda r: True)
        assert expired == []
        got.append(r.priority)
    assert got == [2, 0, 2, 2, 2, 0, 0, 0]

    q = _PrioQueue("t", lookahead=2)
    head = req(1)
    others = [req(1) for _ in range(3)]
    q.append(head)
    for r in others:
        q.append(r)
    covers = lambda r: r is not head
    first, _ = q.pop_admissible(now, covers)
    assert first is others[0] and head.skips == 1
    second, _ = q.pop_admissible(now, covers)
    assert second is others[1] and head.skips == 2
    blocked, _ = q.pop_admissible(now, covers)
    assert blocked is None
    unblocked, _ = q.pop_admissible(now, lambda r: True)
    assert unblocked is head

    q = _PrioQueue("t", lookahead=4)
    dead1, live, dead2 = (req(1, deadline=now - 1.0), req(1),
                          req(1, deadline=now - 2.0))
    for r in (dead1, live, dead2):
        q.append(r)
    got, expired = q.pop_admissible(now, lambda r: True)
    assert got is live and set(expired) == {dead1}
    got2, expired2 = q.pop_admissible(now, lambda r: True)
    assert got2 is None and expired2 == [dead2]
    assert len(q) == 0

    q = _PrioQueue("t", lookahead=0)
    a, b = req(1), req(1)
    q.append(a)
    q.appendleft(b)
    first, _ = q.pop_admissible(now, lambda r: True)
    assert first is b

    q = _PrioQueue("t", lookahead=2)
    head0 = req(0)
    q.append(head0)
    for _ in range(4):
        q.append(req(2))
    covers = lambda r: r is not head0
    got1, _ = q.pop_admissible(now, covers)
    assert got1.priority == 2 and head0.skips == 0
    got2, _ = q.pop_admissible(now, covers)
    assert got2.priority == 2 and head0.skips == 1
    got3, _ = q.pop_admissible(now, covers)
    assert got3.priority == 2 and head0.skips == 2
    frozen, _ = q.pop_admissible(now, covers)
    assert frozen is None
    thaw, _ = q.pop_admissible(now, lambda r: True)
    assert thaw is head0
    resumed, _ = q.pop_admissible(now, covers)
    assert resumed is not None and resumed.priority == 2


def test_pin_holds_while_preempted_request_waits(port, jax_params):
    from multiverso_tpu_torch.serving.decode_engine import _Request

    lm = _model(jax_params)
    srv = InferenceServer("t")
    eng = srv.register_decoder("lm", lm, slots=2, max_prompt=8, max_new=8,
                               kv_block_size=4, prefill_token_budget=4,
                               max_staleness_s=0.0)
    eng.warmup()
    v0 = eng._pinned_version
    saved_slots = list(eng._free_q)
    eng._free_q.clear()
    waiter = _Request(np.ones(4, np.int64), 8)
    waiter.out = [1, 2]
    waiter.resumed = True
    waiter.preempts = 1
    with eng._cv:
        eng._q.appendleft(waiter)
    assert eng._q.n_resumed == 1
    rng = np.random.default_rng(2)
    lm.train_batch(rng.integers(0, DIMS["vocab_size"], (2, 12)))
    eng._maybe_refresh()
    assert eng._pinned_version == v0        # held for the waiter
    with eng._cv:
        popped, _ = eng._q.pop_admissible(time.monotonic(), lambda r: True)
    assert popped is waiter and eng._q.n_resumed == 0
    eng._maybe_refresh()
    assert eng._pinned_version > v0         # released: the pin moves
    eng._free_q.extend(saved_slots)
