"""The port's flight recorder against the JAX package's.

The same records go into a JAX ``FlightRecorder`` and the port's: the
rings, summaries and window digests agree. Then the JAX file's unit cases
on the port's class (ring wrap, summary, empty ring, JSONL round trip
through ``tools/engine_timeline.py``, the chrome counter merge with the
port's span export, and records without the tail columns), and one
engine run at the default flags.
"""

import time

import numpy as np
import pytest

from multiverso_tpu.serving import flight_recorder as jfr
from multiverso_tpu_torch import trace
from multiverso_tpu_torch.serving.flight_recorder import (FIELDS,
                                                          FlightRecorder,
                                                          window_digest)
from tools.engine_timeline import load_ring, main, render, timeline_report


def _rec(it, ts, busy=1.0, step=0.5, live=1, reserved=0, queue=0,
         queue_age=0.0, prefill=0, decode=1, pool_free=-1, pool_live=-1,
         pool_shared=-1, version=0, admitted=(), completed=(),
         spec_proposed=-1, spec_accepted=-1, kv_quant=-1,
         quant_scale_blocks=-1, kv_block_s=-1.0, tenants_live=-1,
         sp_chunks=-1):
    return (it, ts, busy, step, live, reserved, queue, queue_age,
            prefill, decode, pool_free, pool_live, pool_shared, version,
            admitted, completed, spec_proposed, spec_accepted, kv_quant,
            quant_scale_blocks, kv_block_s, tenants_live, sp_chunks)


def test_fields_and_digest_match_jax():
    assert FIELDS == jfr.FIELDS
    rng = np.random.default_rng(0)
    jr, tr = jfr.FlightRecorder(16, name="e"), FlightRecorder(16, name="e")
    for i in range(40):
        rec = _rec(i + 1, 100.0 + i * 0.01 + float(rng.random()) * 1e-3,
                   busy=float(rng.random() * 8), step=float(rng.random()),
                   live=int(rng.integers(0, 4)), prefill=int(i % 3),
                   decode=int(rng.integers(0, 5)), pool_free=7,
                   pool_live=2, pool_shared=0, admitted=(i,))
        # the port's engine writes the 16-column prefix
        rec = rec[:16] if i % 2 else rec
        jr.record(rec)
        tr.record(rec)
    assert tr.records() == jr.records()
    assert window_digest(tr.records()) == jfr.window_digest(jr.records())
    keep = ("iterations", "retained", "capacity", "wrapped", "busy_frac",
            "idle_frac", "prefill_tokens", "decode_tokens", "steps",
            "mean_step_ms", "max_idle_gap_ms")
    ts, js = tr.summary(), jr.summary()
    assert {k: ts[k] for k in keep} == {k: js[k] for k in keep}
    assert tr.stats() == jr.stats()


def test_ring_wrap_preserves_newest_records():
    fr = FlightRecorder(capacity=4, name="t")
    for i in range(10):
        fr.record(_rec(i + 1, i * 0.01))
    recs = fr.records()
    assert [r["it"] for r in recs] == [7, 8, 9, 10]
    assert list(recs[0]) == list(FIELDS)
    assert fr.total == 10
    s = fr.summary()
    assert s["wrapped"] and s["retained"] == 4 and s["iterations"] == 10


def test_summary_utilization_and_token_split():
    fr = FlightRecorder(capacity=64, name="t")
    for i in range(10):
        fr.record(_rec(i + 1, 1000.0 + i * 0.010, busy=5.0, step=4.0,
                       prefill=(8 if i < 2 else 0), decode=2))
    s = fr.summary()
    assert 0.40 < s["busy_frac"] < 0.65
    assert s["busy_frac"] + s["idle_frac"] == pytest.approx(1.0)
    assert s["prefill_tokens"] == 16 and s["decode_tokens"] == 20
    assert s["prefill_share"] == pytest.approx(16 / 36)
    assert s["steps"] == 10
    assert s["mean_step_ms"] == pytest.approx(4.0)
    assert 4.0 < s["max_idle_gap_ms"] < 6.5


def test_empty_ring_summary_is_zeroed():
    s = FlightRecorder(capacity=8, name="t").summary()
    assert s["iterations"] == 0 and s["idle_frac"] == 0.0
    assert not s["wrapped"]


def test_jsonl_dump_roundtrips_through_engine_timeline(tmp_path):
    fr = FlightRecorder(capacity=64, name="eng")
    for i in range(20):
        fr.record(_rec(i + 1, i * 0.010, busy=5.0, step=4.0, live=2,
                       queue=1, queue_age=3.0,
                       prefill=(16 if i < 5 else 0), decode=2,
                       admitted=(i + 1,) if i < 5 else ())[:16])
    path = str(tmp_path / "ring.jsonl")
    assert fr.export_jsonl(path) == 20
    meta, records = load_ring(path)
    assert meta["name"] == "eng" and meta["fields"] == list(FIELDS)
    assert len(records) == 20
    assert records[0]["admitted"] == [1]
    report = timeline_report(records, buckets=4)
    assert report["iterations"] == 20
    assert report["prefill_tokens"] == 80 and report["decode_tokens"] == 40
    assert report["peak_live"] == 2
    assert report["buckets"][0]["prefill_toks"] == 80
    assert report["buckets"][-1]["prefill_toks"] == 0
    text = render(report, meta["name"])
    assert "eng" in text and "utilization" in text
    assert main([path, "--buckets", "4"]) == 0


def test_chrome_counter_tracks_merge_with_span_export():
    fr = FlightRecorder(capacity=8, name="eng")
    fr.record(_rec(1, time.monotonic(), pool_free=3, pool_live=1))
    counters = fr.chrome_counter_events()
    assert all(e["ph"] == "C" for e in counters)
    assert {e["name"] for e in counters} == {
        "fr/eng/slots", "fr/eng/queue", "fr/eng/tokens",
        "fr/eng/kv_blocks"}
    trace.enable(64)
    try:
        with trace.span("serve.request", root=True, model="m"):
            pass
        doc = trace.export_chrome()
    finally:
        trace.disable()
        trace.collector().clear()
    merged = fr.merge_chrome(doc)
    trace.validate_chrome_events(merged["traceEvents"],
                                 root_name="serve.request")
    assert sum(e["ph"] == "C" for e in merged["traceEvents"]) == 4
    assert [e["ts"] for e in merged["traceEvents"]] == sorted(
        e["ts"] for e in merged["traceEvents"])


@pytest.mark.parametrize("cut", [16, 18, 20, 22])
def test_records_without_tail_columns_read_everywhere(cut):
    """A record cut after ``completed`` (this engine's), or after any
    later column group, reads through records, summary and the chrome
    export; the tail tracks appear only when their columns do."""
    fr = FlightRecorder(capacity=8, name="old")
    fr.record(_rec(1, time.monotonic(), spec_proposed=4, spec_accepted=3,
                   kv_block_s=0.125, tenants_live=3)[:cut])
    recs = fr.records()
    assert len(recs) == 1 and len(recs[0]) == cut
    assert fr.summary()["iterations"] == 1
    names = {e["name"] for e in fr.chrome_counter_events()}
    assert ("fr/old/spec" in names) == (cut > 17)
    assert ("fr/old/tenants" in names) == (cut > 21)


def test_engine_records_iterations(tmp_path):
    """One run at the default flags: a record per iteration, admitted and
    completed ids that match, pool columns live, and token sums that
    equal the engine's; the dump reads back through the tool."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.dashboard import Dashboard
    from multiverso_tpu_torch.models.transformer import (TransformerConfig,
                                                         TransformerLM)
    from multiverso_tpu_torch.runtime import Session
    from multiverso_tpu_torch.serving import InferenceServer

    Session._instance = None
    Dashboard.reset()
    mv.init(["test", "-device=cpu"])
    try:
        cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                                n_layers=2, d_ff=64, max_seq=48)
        srv = InferenceServer("t")
        eng = srv.register_decoder("lm", TransformerLM(cfg), slots=2,
                                   max_prompt=8, max_new=6)
        assert eng.recorder is not None
        futs = [srv.submit("lm", np.arange(1, 5)) for _ in range(3)]
        for f in futs:
            assert len(f.result(timeout=60)["result"]) == 6
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            stats = eng.stats()
            if (stats["live_seqs"] == 0
                    and sum(r["decode_toks"] for r in eng.recorder.records())
                    == stats["tokens"]):
                break
            time.sleep(0.01)
        assert stats["step_traces"] == stats["prefill_traces"] == 1
        assert stats["flight_records"] == eng.recorder.total \
            == stats["iters_total"] >= 5
        assert Dashboard.get_or_create_counter("ENGINE_ITERS[lm]").get() \
            == stats["iters_total"]
        recs = eng.recorder.records()
        admitted = [rid for r in recs for rid in r["admitted"]]
        completed = [rid for r in recs for rid in r["completed"]]
        assert len(admitted) == len(completed) == 3
        assert set(admitted) == set(completed)
        # the engine writes the columns up to quant_scale_blocks; a plain
        # engine's speculation and int8 columns say "off"
        assert all(len(r) == 20 for r in recs)
        assert all(r["spec_proposed"] == r["spec_accepted"] == -1
                   and r["kv_quant"] == 0 and r["quant_scale_blocks"] == -1
                   for r in recs)
        assert all(r["pool_free"] >= 0 and r["version"] >= 0 for r in recs)
        assert sum(r["decode_toks"] for r in recs) == stats["tokens"]
        assert sum(r["prefill_toks"] for r in recs) == 12
        assert [r["ts"] for r in recs] == sorted(r["ts"] for r in recs)
        path = str(tmp_path / "ring.jsonl")
        eng.recorder.export_jsonl(path)
        _, back = load_ring(path)
        assert timeline_report(back, buckets=4)["decode_tokens"] == \
            stats["tokens"]
    finally:
        mv.shutdown()
        Dashboard.reset()
        Session._instance = None
        mv.set_flag("device", "cuda")
