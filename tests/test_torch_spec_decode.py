"""Speculative decoding in the port, held to the JAX package on the CPU.

The cases of ``tests/test_spec_decode.py`` on the port's engine, with the
JAX parameters carried across (``params_from_jax``, f32): a ``spec_k > 0``
engine's outputs are token-identical to JAX ``greedy_decode`` and to a
``spec_k=0`` engine, prefix cache on and off, chunked and monolithic;
eos inside a window truncates; the multi-token metrics, the ``accepted``
span attribute and the recorder's columns; the ``spec_k=0`` surface has
no speculation key; the fail-fasts. Also: the port's ``_PromptLookup``
proposes what JAX's does on the same sequences, ``verify_step_paged``
matches JAX's (tokens exactly, pools within 1e-5 of the largest JAX
value), and the engine's window writes share an index only in the
scratch block (where the card's ``index_put_`` order is undefined).
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.models import transformer as jtf
from multiverso_tpu_torch import trace
from multiverso_tpu_torch.models import transformer as ttf
from multiverso_tpu_torch.serving import InferenceServer

DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=48)
RTOL = 1e-5


@pytest.fixture()
def port():
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.dashboard import Dashboard
    from multiverso_tpu_torch.runtime import Session

    Session._instance = None
    Dashboard.reset()
    mv.init(["test", "-device=cpu"])
    yield mv
    trace.disable()
    trace.collector().clear()
    mv.shutdown()
    Dashboard.reset()
    Session._instance = None
    mv.set_flag("device", "cuda")


@pytest.fixture(scope="module")
def jax_params():
    return jtf.init_params(jtf.TransformerConfig(**DIMS))


def _host(jax_params):
    return {"embed": np.asarray(jax_params["embed"]),
            "pos": np.asarray(jax_params["pos"]),
            "ln_f_g": np.asarray(jax_params["ln_f_g"]),
            "layers": {k: np.asarray(v)
                       for k, v in jax_params["layers"].items()}}


def _model(jax_params):
    """A port LM whose parameters are the JAX ones, carried across."""
    lm = ttf.TransformerLM(ttf.TransformerConfig(**DIMS))
    carried = ttf.params_from_jax(_host(jax_params), device="cpu")
    with torch.no_grad():
        for name, w in lm.params.items():
            if isinstance(w, dict):
                for k, t in w.items():
                    t.copy_(carried[name][k])
            else:
                w.copy_(carried[name])
    return lm


def _oracle(jax_params, prompt, max_new, eos_id=None):
    """JAX ``greedy_decode`` of one prompt, cut at eos."""
    out = np.asarray(jtf.greedy_decode(
        jtf.TransformerConfig(**DIMS), jax_params,
        jnp.asarray(np.asarray(prompt, np.int32)[None]),
        jnp.asarray([len(prompt)]), max_new, eos_id))[0]
    if eos_id is not None:
        hits = np.nonzero(out == eos_id)[0]
        if hits.size:
            return out[: hits[0] + 1]
    return out


def _spec_trace(rng, vocab, max_prompt, max_new, n=10):
    """JAX's mixed trace: motif-tiled and random prompts, then an exact
    block-aligned repeat (a full prefix hit when the cache is on)."""
    reqs = []
    for i in range(n):
        plen = int(rng.integers(2, max_prompt + 1))
        if i % 3 == 2:
            prompt = rng.integers(1, vocab, plen).astype(np.int32)
        else:
            motif = rng.integers(1, vocab,
                                 int(rng.integers(2, 5))).astype(np.int32)
            prompt = np.tile(motif, -(-plen // len(motif)))[:plen]
        reqs.append((prompt.astype(np.int32),
                     int(rng.integers(2, max_new + 1))))
    reqs.append((reqs[0][0][:8] if len(reqs[0][0]) >= 8
                 else np.tile(reqs[0][0], 8)[:8].astype(np.int32),
                 max_new))
    reqs.append((reqs[-1][0].copy(), max_new))
    return reqs


def _wait_records(eng, tokens):
    deadline = time.monotonic() + 10.0
    while (time.monotonic() < deadline
           and sum(r["decode_toks"] for r in eng.recorder.records())
           < tokens):
        time.sleep(0.01)


@pytest.mark.parametrize("budget,prefix", [(4, True), (4, False),
                                           (0, False)])
def test_spec_matches_baseline_and_oracle(port, jax_params, budget, prefix):
    lm = _model(jax_params)
    srv = InferenceServer("t")
    engines = {
        k: srv.register_decoder(
            f"lm_k{k}", lm, slots=4, max_prompt=12, max_new=10,
            kv_block_size=4, prefill_token_budget=budget,
            prompt_buckets=(12,), prefix_cache=prefix, spec_k=k)
        for k in (3, 0)
    }
    for e in engines.values():
        e.warmup()
    reqs = _spec_trace(np.random.default_rng(17), DIMS["vocab_size"],
                       max_prompt=12, max_new=10)
    outs = {}
    for k in engines:
        futs = [srv.submit(f"lm_k{k}", {"prompt": p, "max_new": n})
                for p, n in reqs]
        outs[k] = [f.result(timeout=120)["result"] for f in futs]
    for i, (p, n) in enumerate(reqs):
        expect = _oracle(jax_params, p, n)
        np.testing.assert_array_equal(outs[0][i], expect,
                                      err_msg=f"spec_k=0, request {i}")
        np.testing.assert_array_equal(outs[3][i], expect,
                                      err_msg=f"spec_k=3, request {i}")
    spec, base = engines[3].stats(), engines[0].stats()
    assert spec["spec_accepted"] > 0, "trace never speculated"
    assert spec["spec_steps"] > 0
    assert 0.0 < spec["acceptance_rate"] <= 1.0
    assert spec["accepted_per_step"] > 0.0
    assert spec["verify_traces"] == 1
    assert engines[0].verify_cache_size() == 0
    for e in engines.values():
        s = e.stats()
        assert s["step_traces"] == 1, s
        assert s["decode_step_retraces"] == 0
        assert e.prefill_cache_size() >= 1
    if budget > 0:
        assert engines[3].prefill_cache_size() == 1
    if prefix:
        assert spec["prefix_hits"] > 0
        assert spec["cow_copies"] >= 1          # the full-hit repeat
        assert engines[3]._cow_fn.cache_size() == 1
    assert spec["tokens"] == base["tokens"] == sum(n for _, n in reqs)
    engines[3]._pool.check()
    assert engines[3].pool_drift() is None


def test_spec_eos_inside_window_truncates(port, jax_params):
    lm = _model(jax_params)
    probe = eos = None
    for seed in range(29, 61):
        rng = np.random.default_rng(seed)
        motif = rng.integers(1, DIMS["vocab_size"], 3).astype(np.int32)
        cand = np.tile(motif, 4)[:10].astype(np.int32)
        run = [int(t) for t in _oracle(jax_params, cand, 12)]
        fresh = [j for j in range(2, len(run)) if run[j] not in run[:j]]
        if fresh:
            probe, eos = cand, run[fresh[0]]
            break
    assert probe is not None, "no workable eos candidate; widen the scan"
    srv = InferenceServer("t")
    engine = srv.register_decoder("lm", lm, slots=2, max_prompt=12,
                                  max_new=12, eos_id=eos, kv_block_size=4,
                                  prefill_token_budget=4, spec_k=4)
    engine.warmup()
    out = srv.submit("lm", probe).result(timeout=120)["result"]
    np.testing.assert_array_equal(out, _oracle(jax_params, probe, 12, eos))
    assert out[-1] == eos and 3 <= len(out) < 12
    s = engine.stats()
    assert s["spec_steps"] >= 1, "no verify window ran before eos"
    assert s["spec_accepted"] <= len(out) - 1
    assert s["active_slots"] == 0
    assert s["kv_blocks_live"] == 0
    engine._pool.check()


def test_spec_multi_token_metrics_and_iter_span(port, jax_params):
    from multiverso_tpu_torch.dashboard import Dashboard

    lm = _model(jax_params)
    srv = InferenceServer("t")
    engine = srv.register_decoder("lm_m", lm, slots=2, max_prompt=12,
                                  max_new=10, kv_block_size=4,
                                  prefill_token_budget=4, spec_k=3)
    engine.warmup()
    rng = np.random.default_rng(5)
    motif = rng.integers(1, DIMS["vocab_size"], 3).astype(np.int32)
    prompts = [np.tile(motif, 4)[:10].astype(np.int32) for _ in range(4)]
    trace.enable(65536)
    try:
        futs = [srv.submit("lm_m", {"prompt": p, "max_new": 10})
                for p in prompts]
        outs = [f.result(timeout=120)["result"] for f in futs]
        deadline = time.monotonic() + 10.0
        while (time.monotonic() < deadline
               and sum(sp.name == "decode.iter"
                       for sp in trace.collector().spans()) == 0):
            time.sleep(0.01)
        spans = trace.collector().spans()
    finally:
        trace.disable()
        trace.collector().clear()
    s = engine.stats()
    tokens = sum(len(o) for o in outs)
    assert s["tokens"] == tokens == 40
    assert Dashboard.get_or_create_counter("DECODE_TOKENS[lm_m]").get() \
        == tokens
    assert Dashboard.get_or_create_counter("SPEC_ACCEPTED[lm_m]").get() \
        == s["spec_accepted"] > 0
    assert engine.ttft_hist.count == len(prompts)
    assert engine.itl_hist.count == tokens - len(prompts)
    iters = [sp for sp in spans if sp.name == "decode.iter"]
    assert iters and all("accepted" in sp.attrs for sp in iters)
    assert sum(sp.attrs["accepted"] for sp in iters) \
        == s["spec_accepted"] > 0
    steps = Dashboard.get_or_create_counter("DECODE_STEPS[lm_m]").get()
    assert steps < tokens - len(prompts)


def test_queued_full_hit_window_itl_excludes_queue_wait(port, jax_params):
    """A fully cached admission's first window divides (now - t_last)
    over its tokens; the base is the admission, so a full hit that sat
    queued behind a long generation keeps its wait out of ITL."""
    lm = _model(jax_params)
    srv = InferenceServer("t")
    engine = srv.register_decoder("lm_q", lm, slots=1, max_prompt=8,
                                  max_new=38, kv_block_size=4,
                                  kv_pool_blocks=16,
                                  prefill_token_budget=4, spec_k=4)
    engine.warmup()
    rng = np.random.default_rng(33)
    motif = rng.integers(1, DIMS["vocab_size"], 2).astype(np.int32)
    hot = np.tile(motif, 4).astype(np.int32)       # 8 = 2 blocks, aligned
    srv.submit("lm_q", {"prompt": hot, "max_new": 2}).result(timeout=120)

    def slowed(fn):
        def run(*a, **k):
            time.sleep(0.08)
            return fn(*a, **k)
        return run

    engine._step_fn = slowed(engine._step_fn)
    engine._verify_fn = slowed(engine._verify_fn)
    engine.reset_stats()
    occupant = srv.submit("lm_q", {"prompt": rng.integers(
        1, DIMS["vocab_size"], 3).astype(np.int32), "max_new": 38})
    victim = srv.submit("lm_q", {"prompt": hot.copy(), "max_new": 8})
    occupant.result(timeout=120)
    victim.result(timeout=120)
    s = engine.stats()
    assert s["prefix_hits"] >= 2 and s["cow_copies"] >= 1  # full hit ran
    assert s["spec_accepted"] > 0, "victim window never speculated"
    assert engine.ttft_hist.summary()["max_ms"] > 500.0
    itl = engine.itl_hist.summary()
    assert itl["max_ms"] < 120.0, itl


def test_spec_k0_metrics_surface_identical_to_today(port, jax_params):
    from multiverso_tpu_torch.dashboard import Dashboard

    lm = _model(jax_params)
    srv = InferenceServer("t")
    engine = srv.register_decoder("lm_p", lm, slots=2, max_prompt=12,
                                  max_new=8, kv_block_size=4,
                                  prefill_token_budget=4, spec_k=0)
    engine.warmup()
    rng = np.random.default_rng(9)
    motif = rng.integers(1, DIMS["vocab_size"], 3).astype(np.int32)
    prompts = [np.tile(motif, 4)[:10].astype(np.int32) for _ in range(3)]
    trace.enable(65536)
    try:
        futs = [srv.submit("lm_p", {"prompt": p, "max_new": 8})
                for p in prompts]
        for f in futs:
            assert len(f.result(timeout=120)["result"]) == 8
        deadline = time.monotonic() + 10.0
        while (time.monotonic() < deadline
               and sum(sp.name == "decode.iter"
                       for sp in trace.collector().spans()) == 0):
            time.sleep(0.01)
        spans = trace.collector().spans()
    finally:
        trace.disable()
        trace.collector().clear()
    s = engine.stats()
    assert not any(k.startswith("spec") or k == "acceptance_rate"
                   or k == "accepted_per_step" or k == "verify_traces"
                   for k in s), sorted(s)
    snapshot = Dashboard.snapshot()
    assert not any(name.startswith("SPEC_") and "lm_p" in name
                   for name in snapshot), sorted(snapshot)
    iters = [sp for sp in spans if sp.name == "decode.iter"]
    assert iters and all("accepted" not in sp.attrs for sp in iters)
    assert engine.ttft_hist.count == len(prompts)
    assert engine.itl_hist.count == s["tokens"] - len(prompts)
    assert engine.verify_cache_size() == 0


def test_spec_flight_recorder_columns_and_timeline(port, jax_params,
                                                   tmp_path):
    from tools.engine_timeline import load_ring, render, timeline_report

    lm = _model(jax_params)
    srv = InferenceServer("t")
    engines = {
        k: srv.register_decoder(f"lm_fr{k}", lm, slots=2, max_prompt=12,
                                max_new=8, kv_block_size=4,
                                prefill_token_budget=4, spec_k=k)
        for k in (3, 0)
    }
    rng = np.random.default_rng(13)
    motif = rng.integers(1, DIMS["vocab_size"], 3).astype(np.int32)
    prompt = np.tile(motif, 4)[:10].astype(np.int32)
    for k, e in engines.items():
        e.warmup()
        srv.submit(f"lm_fr{k}", prompt).result(timeout=120)
        _wait_records(e, e.stats()["tokens"])
    spec_recs = engines[3].recorder.records()
    assert engines[3].recorder.meta["spec_k"] == 3
    assert any(r["spec_proposed"] > 0 for r in spec_recs)
    assert sum(max(0, r["spec_accepted"]) for r in spec_recs) \
        == engines[3].stats()["spec_accepted"] > 0
    base_recs = engines[0].recorder.records()
    assert all(r["spec_proposed"] == r["spec_accepted"] == -1
               for r in base_recs)
    assert "spec_k" not in engines[0].recorder.meta

    path = str(tmp_path / "spec_ring.jsonl")
    engines[3].recorder.export_jsonl(path)
    meta, records = load_ring(path)
    report = timeline_report(records, buckets=4)
    assert report["spec_enabled"]
    assert report["spec_accepted"] > 0
    assert 0.0 < report["acceptance_rate"] <= 1.0
    text = render(report, meta.get("name", ""))
    assert "acceptance" in text and "accept" in text
    off_report = timeline_report(engines[0].recorder.records(), buckets=4)
    assert not off_report["spec_enabled"]
    assert "acceptance" not in render(off_report)


def test_spec_validation_fail_fasts(port, jax_params):
    from multiverso_tpu_torch.log import FatalError

    lm = _model(jax_params)
    srv = InferenceServer("t")
    kw = dict(max_prompt=16, max_new=8)
    with pytest.raises(FatalError, match="spec_k"):  # contiguous: no spec
        srv.register_decoder("bad_contig", lm, kv_block_size=0, spec_k=2,
                             **kw)
    with pytest.raises(FatalError, match="spec_k"):
        srv.register_decoder("bad_neg", lm, kv_block_size=4, spec_k=-1,
                             **kw)


def test_prompt_lookup_index_unit():
    """The JAX unit cases, then the port's drafter against JAX's on the
    same random sequences: identical proposals at every length."""
    from multiverso_tpu.serving.decode_engine import _PromptLookup as JLookup
    from multiverso_tpu_torch.serving.decode_engine import _PromptLookup

    d = _PromptLookup()
    d.extend([1, 2, 3, 4])
    assert d.propose(4) == []
    d.extend([1, 2, 9])
    d.extend([1, 2])
    assert d.propose(3) == [9, 1, 2]
    assert d.propose(1) == [9]
    d.extend([9, 1, 2])
    assert d.propose(2) == [9, 1]
    assert d.propose(0) == []
    d2 = _PromptLookup()
    d2.extend([7])
    assert d2.propose(4) == []
    d3 = _PromptLookup()
    d3.extend([5, 6, 5, 6, 5])
    assert d3.propose(4) == [6, 5, 6, 5]
    assert d3.propose(3) == [6, 5, 6]

    rng = np.random.default_rng(4)
    for _ in range(40):
        mine, theirs = _PromptLookup(), JLookup()
        seq = rng.integers(0, int(rng.integers(2, 9)), 40)
        for t in seq:
            mine.extend([int(t)])
            theirs.extend([int(t)])
            for limit in (0, 1, 3, 5):
                assert mine.propose(limit) == theirs.propose(limit)


def test_verify_step_paged_matches_jax(jax_params):
    """One window over random pools: out_tok identical, pools within 1e-5
    of the JAX values' largest magnitude (the scratch block, written in
    an undefined order on both sides, left out); a dead slot and a slot
    without drafts ride along."""
    jcfg = jtf.TransformerConfig(**DIMS)
    tcfg = ttf.TransformerConfig(**DIMS)
    tparams = ttf.params_from_jax(_host(jax_params), device="cpu")
    rng = np.random.default_rng(3)
    L, D, Bs, S, K1, T = DIMS["n_layers"], DIMS["d_model"], 4, 4, 4, 18
    M = -(-T // Bs)
    N = S * M + 1
    kp = rng.standard_normal((L, N, Bs, D)).astype(np.float32)
    vp = rng.standard_normal((L, N, Bs, D)).astype(np.float32)
    bt = np.zeros((S, M), np.int64)
    bt[:, :] = rng.permutation(np.arange(1, N))[: S * M].reshape(S, M)
    bt[2, 3:] = 0                      # a short reservation, scratch-padded
    toks = rng.integers(1, DIMS["vocab_size"], (S, K1))
    pos = np.array([5, 11, 7, 0])
    active = np.array([True, True, True, False])
    n_valid = np.array([4, 2, 1, 1])
    jk, jv, jout = jtf.verify_step_paged(
        jcfg, jax_params, jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(bt, jnp.int32), jnp.asarray(toks, jnp.int32),
        jnp.asarray(pos, jnp.int32), jnp.asarray(active),
        jnp.asarray(n_valid, jnp.int32), t_logical=T)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    _, _, tout = ttf.verify_step_paged(
        tcfg, tparams, tk, tv, torch.from_numpy(bt), torch.from_numpy(toks),
        torch.from_numpy(pos), torch.from_numpy(active),
        torch.from_numpy(n_valid), t_logical=T)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    for got, want in ((tk, jk), (tv, jv)):
        got = got.numpy()[:, 1:]
        want = np.asarray(want)[:, 1:]
        assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


def test_verify_writes_collide_only_in_scratch(port, jax_params):
    """Every verify call of a spec engine under churn (prefix hits, a
    full-hit copy, dead lanes, short windows): the (block, offset) pairs
    its window writes may repeat only in the scratch block."""
    lm = _model(jax_params)
    srv = InferenceServer("t")
    eng = srv.register_decoder("lm", lm, slots=4, max_prompt=12,
                               max_new=10, kv_block_size=4,
                               prefill_token_budget=4, spec_k=3)
    calls = []
    fn = eng._verify_fn.fn

    def recording(p, kc, vc, bt, toks, pos, active, nv):
        calls.append((bt.clone(), pos.clone(), active.clone(), nv.clone()))
        return fn(p, kc, vc, bt, toks, pos, active, nv)

    eng._verify_fn.fn = recording
    reqs = _spec_trace(np.random.default_rng(17), DIMS["vocab_size"],
                       max_prompt=12, max_new=10)
    for f in [srv.submit("lm", {"prompt": p, "max_new": n})
              for p, n in reqs]:
        f.result(timeout=120)
    assert len(calls) >= 3
    dead_or_short = 0
    for bt, pos, active, nv in calls:
        _, valid, blk, off = ttf._window_slots(bt, pos, active, nv, 4, 4)
        pairs = [(int(b), int(o)) for b, o in zip(blk.flatten(),
                                                  off.flatten())]
        seen = {}
        for b, o in pairs:
            seen[(b, o)] = seen.get((b, o), 0) + 1
        assert all(b == 0 for (b, _), n in seen.items() if n > 1), seen
        # valid writes never land in the scratch block
        assert not bool(((blk == 0) & valid).any())
        dead_or_short += int((~valid).sum())
    assert dead_or_short > 0


def test_spec_counts_equal_jax_engine(port, jax_params):
    """The JAX engine and the port's on one trace, from one
    initialization: the same tokens, and the same drafts proposed and
    accepted (a request's windows depend only on its own tokens), prefix
    hits and copies."""
    import multiverso_tpu as jmv
    from multiverso_tpu.dashboard import Dashboard as JDashboard
    from multiverso_tpu.runtime import Session as JSession
    from multiverso_tpu.serving import InferenceServer as JServer

    kw = dict(slots=4, max_prompt=12, max_new=10, kv_block_size=4,
              prefill_token_budget=4, prompt_buckets=(12,), spec_k=3)
    reqs = _spec_trace(np.random.default_rng(17), DIMS["vocab_size"],
                       max_prompt=12, max_new=10)
    keys = ("spec_proposed", "spec_accepted", "prefix_hits", "cow_copies",
            "tokens")
    JSession._instance = None
    JDashboard.reset()
    jmv.init()
    try:
        jlm = jtf.TransformerLM(jtf.TransformerConfig(**DIMS))
        jeng = JServer("j").register_decoder("lm", jlm, **kw)
        jeng.warmup()
        # one request at a time: the counts must not depend on timing
        jouts = [np.asarray(jeng.submit(p, n).result(timeout=120)["result"])
                 for p, n in reqs]
        jstats = jeng.stats()
    finally:
        jmv.shutdown()
        JDashboard.reset()
        JSession._instance = None
    eng = InferenceServer("t").register_decoder("lm", _model(jax_params),
                                                **kw)
    eng.warmup()
    outs = [np.asarray(eng.submit(p, n).result(timeout=120)["result"])
            for p, n in reqs]
    for i, (got, want) in enumerate(zip(outs, jouts)):
        np.testing.assert_array_equal(got, want, err_msg=f"request {i}")
    stats = eng.stats()
    assert {k: stats[k] for k in keys} == {k: jstats[k] for k in keys}
    assert stats["spec_accepted"] > 0 and stats["cow_copies"] >= 1
