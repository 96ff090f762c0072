"""The port's KV-block transfer plane against the JAX package's.

``multiverso_tpu_torch.serving.kv_transfer`` (the payload schema) and the
port engine's disaggregated surface (``submit_prefill``, ``splice``), on
the CPU:

* the records: bf16 and int8 blocks pack to the JAX package's base64
  bytes, and the payload helpers keep its accounting;
* a payload from the port engine and one from the JAX engine on the same
  weights and prompt have equal headers and chain hashes, K/V within
  1e-5; a JAX payload spliced into a port engine gives the JAX unified
  engine's tokens;
* splice at arrival gives unified output (and JAX ``greedy_decode``'s),
  dedup at the source and at arrival, the degradation ladder (bad
  payloads skip, a chain gap stops the walk), int8 blocks shipped with
  their scales, and the surfaces an engine without the prefix cache
  refuses;
* a fleet of one prefill and one decode replica behind the router,
  against a unified fleet, with and without a dropped transfer.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.models import transformer as jtf
from multiverso_tpu.serving import kv_transfer as jkt
from multiverso_tpu_torch.models import transformer as ttf
from multiverso_tpu_torch.serving import kv_transfer as tkt

SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=48)
# paged + chunked + prefix cache: the transfer plane's gate
KW = dict(slots=2, max_prompt=16, max_new=8, kv_block_size=4,
          prefill_token_budget=4, prefix_cache=True, watchdog=False)


@pytest.fixture()
def port():
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.dashboard import Dashboard
    from multiverso_tpu_torch.runtime import Session

    Session._instance = None
    Dashboard.reset()
    mv.init(["test", "-device=cpu", "-log_level=error"])
    # one torch thread: under the suite's parallel workers a full pool
    # of threads per engine starves the replicas' heartbeat threads
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield mv
    torch.set_num_threads(threads)
    mv.shutdown()
    Dashboard.reset()
    Session._instance = None
    mv.set_flag("device", "cuda")


def _oracle(prompts, max_new):
    """JAX ``greedy_decode`` on ``init_params`` of the small config (the
    weights a port LM of that config holds), one right-padded batch."""
    cfg = jtf.TransformerConfig(**SMALL)
    P = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), P), np.int32)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    out = np.asarray(jtf.greedy_decode(
        cfg, jtf.init_params(cfg), jnp.asarray(toks),
        jnp.asarray([len(p) for p in prompts], np.int32), max_new, None))
    return list(out)


def _engines(*names, **kw):
    from multiverso_tpu_torch.serving import DecodeEngine, DecodeEngineConfig

    lm = ttf.TransformerLM(ttf.TransformerConfig(**SMALL))
    out = []
    for name in names:
        e = DecodeEngine(name, lm, DecodeEngineConfig(**{**KW, **kw}))
        e.warmup()
        out.append(e)
    return out


def _stop(*engines):
    for e in engines:
        e.stop()


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, SMALL["vocab_size"], n).astype(np.int32)
            for n in lens]


# -- the records --------------------------------------------------------------

def test_payload_roundtrip_and_accounting():
    shape = (2, 4, 8)
    rng = np.random.default_rng(0)
    payload = tkt.new_payload(prompt_len=9, block_size=4, snapshot_version=3,
                              shape=shape, dtype=torch.float32)
    assert payload == jkt.new_payload(9, 4, 3, shape, "float32")
    assert tkt.validate(payload) is None
    k0, v0 = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    tkt.add_block(payload, "aa" * 16, torch.from_numpy(k0), v0)
    tkt.add_block(payload, "bb" * 16)             # source dedup: hash only
    assert payload["hashes"] == ["aa" * 16, "bb" * 16]
    assert payload["dedup_blocks"] == 1
    assert tkt.shipped_hashes(payload) == {"aa" * 16}
    per = tkt.block_nbytes(shape, "float32")
    assert per == jkt.block_nbytes(shape, "float32") == 2 * 2 * 4 * 8 * 4
    assert tkt.payload_bytes(payload) == per
    k1, v1 = tkt.unpack_block(payload["blocks"]["aa" * 16], shape,
                              "float32")
    np.testing.assert_array_equal(k1.numpy(), k0)
    np.testing.assert_array_equal(v1.numpy(), v0)
    with pytest.raises(ValueError):
        tkt.unpack_block(payload["blocks"]["aa" * 16], (2, 4, 9), "float32")
    dropped = tkt.drop_blocks(payload)
    assert dropped["dropped"] and not dropped["blocks"]
    assert dropped["hashes"] == payload["hashes"]
    assert tkt.payload_bytes(dropped) == 0 and payload["blocks"]
    assert tkt.validate("nope") is not None
    assert tkt.validate({"v": 99}) is not None
    assert tkt.validate(dict(payload, shape=[1, 2])) is not None
    assert tkt.validate(dict(payload, hashes=[])) is not None


@pytest.mark.parametrize("shape", [(2, 4, 8), (12, 16, 768)])
def test_records_are_the_jax_bytes(shape):
    """bf16 blocks (raw 16-bit words) and int8 blocks with their f32
    scale columns give the JAX package's base64 records, and the header
    dtype names and byte counts agree."""
    rng = np.random.default_rng(len(shape) + shape[-1])
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    port_rec = tkt.pack_block(torch.from_numpy(k).to(torch.bfloat16),
                              torch.from_numpy(v).to(torch.bfloat16))
    jax_rec = jkt.pack_block(np.asarray(jnp.asarray(k, jnp.bfloat16)),
                             np.asarray(jnp.asarray(v, jnp.bfloat16)))
    assert port_rec == jax_rec
    kb, _ = tkt.unpack_block(port_rec, shape, "bfloat16")
    assert kb.dtype == torch.bfloat16
    assert torch.equal(kb, torch.from_numpy(k).to(torch.bfloat16))
    assert tkt.dtype_name(torch.bfloat16) == \
        jkt.new_payload(1, 4, 0, shape, jnp.bfloat16)["dtype"] == "bfloat16"
    assert tkt.block_nbytes(shape, torch.bfloat16) == \
        jkt.block_nbytes(shape, jnp.bfloat16)
    q = [rng.integers(-127, 128, size=shape).astype(np.int8)
         for _ in range(2)]
    s = [rng.random(shape[0]).astype(np.float32) for _ in range(2)]
    port_rec = tkt.pack_block(torch.from_numpy(q[0]), torch.from_numpy(q[1]),
                              torch.from_numpy(s[0]), torch.from_numpy(s[1]))
    assert port_rec == jkt.pack_block(q[0], q[1], s[0], s[1])
    assert tkt.block_nbytes(shape, torch.int8) == \
        jkt.block_nbytes(shape, np.int8)
    ks, vs = tkt.unpack_scales(port_rec, shape[0])
    np.testing.assert_array_equal(ks, s[0])
    np.testing.assert_array_equal(vs, s[1])


# -- the port engine against the JAX engine -----------------------------------

def _jax_engines(*names, **kw):
    from multiverso_tpu.serving import InferenceServer

    lm = jtf.TransformerLM(jtf.TransformerConfig(**SMALL))
    srv = InferenceServer("jx")
    out = [srv.register_decoder(n, lm, **{**KW, **kw}) for n in names]
    for e in out:
        e.warmup()
    return srv, out


def test_prefill_payload_equals_jax(port, mv_session):
    """The same weights and prompt on both engines: equal headers and
    chain hashes, K/V within 1e-5; then a JAX payload spliced into a port
    engine decodes the JAX unified engine's tokens."""
    prompts = _prompts(7, (12, 10, 3))
    srv, (jpf, juni) = _jax_engines("jpf", "juni")
    pf, dec = _engines("pf", "dec")
    try:
        for i, p in enumerate(prompts):
            jp = jpf.submit_prefill(p).result(timeout=120)["xfer"]
            tp = pf.submit_prefill(p).result(timeout=120)["xfer"]
            head = lambda d: {k: v for k, v in d.items() if k != "blocks"}
            assert head(tp) == head(jp), i
            assert list(tp["blocks"]) == list(jp["blocks"]), i
            for hx in jp["blocks"]:
                for kk in ("k", "v"):
                    a = tkt.unpack_block(tp["blocks"][hx], tp["shape"],
                                         tp["dtype"])["kv".index(kk)]
                    b = jkt.unpack_block(jp["blocks"][hx], jp["shape"],
                                         jp["dtype"])["kv".index(kk)]
                    np.testing.assert_allclose(a.numpy(), b, atol=1e-5,
                                               rtol=0)
            info = dec.splice(jp)
            assert "skipped" not in info and \
                info["xfer_blocks"] == len(p) // 4, info
            got = dec.submit(p, 6, xfer_info=info).result(
                timeout=120)["result"]
            want = juni.submit(p, 6).result(timeout=120)["result"]
            np.testing.assert_array_equal(got, want, err_msg=str(i))
    finally:
        srv.stop()
        _stop(pf, dec)


def test_int8_prefill_payload_equals_jax(port, mv_session):
    """int8 pools: the chain hashes are seeded with the encoding, as in
    the JAX engine, so headers and hashes are equal; each block's scale
    columns within 1e-5 relative and its int8 values within one step;
    a JAX int8 payload splices into a port int8 engine."""
    prompts = _prompts(31, (12, 9))
    srv, (jpf,) = _jax_engines("jpf8", kv_quant="int8")
    pf, dec = _engines("pf8", "dec8", kv_quant="int8")
    try:
        for i, p in enumerate(prompts):
            jp = jpf.submit_prefill(p).result(timeout=120)["xfer"]
            tp = pf.submit_prefill(p).result(timeout=120)["xfer"]
            head = lambda d: {k: v for k, v in d.items() if k != "blocks"}
            assert head(tp) == head(jp) and tp["dtype"] == "int8", i
            assert list(tp["blocks"]) == list(jp["blocks"]), i
            for hx in jp["blocks"]:
                a = tkt.unpack_block(tp["blocks"][hx], tp["shape"], "int8")
                b = jkt.unpack_block(jp["blocks"][hx], jp["shape"], np.int8)
                for x, y in zip(a, b):
                    assert np.abs(x.numpy().astype(np.int32)
                                  - y.astype(np.int32)).max() <= 1
                for x, y in zip(tkt.unpack_scales(tp["blocks"][hx], 2),
                                jkt.unpack_scales(jp["blocks"][hx], 2)):
                    np.testing.assert_allclose(x, y, rtol=1e-5, atol=0)
            info = dec.splice(jp)
            assert "skipped" not in info and \
                info["xfer_blocks"] == len(p) // 4, info
    finally:
        srv.stop()
        _stop(pf, dec)


# -- splice at arrival ---------------------------------------------------------

@pytest.mark.parametrize("unified_prefix", [True, False],
                         ids=["unified-cache-on", "unified-cache-off"])
def test_splice_equals_unified_and_jax(port, unified_prefix):
    prompts = _prompts(7, (8, 10, 3))
    want = _oracle(prompts, 6)
    pf, dec = _engines("pf", "dec")
    uni, = _engines("uni", prefix_cache=unified_prefix)
    try:
        assert pf.supports_transfer and dec.supports_transfer
        for i, p in enumerate(prompts):
            payload = pf.submit_prefill(p).result(timeout=120)["xfer"]
            n_full = len(p) // 4
            assert len(payload["hashes"]) == len(payload["blocks"]) == n_full
            info = dec.splice(payload)
            assert "skipped" not in info and info["xfer_blocks"] == n_full
            out = dec.submit(p, 6, xfer_info=info).result(
                timeout=120)["result"]
            np.testing.assert_array_equal(out, want[i], err_msg=str(i))
            np.testing.assert_array_equal(
                uni.submit(p, 6).result(timeout=120)["result"], want[i])
        pfs, decs = pf.stats(), dec.stats()
        assert pfs["xfer_blocks"] == decs["xfer_blocks"] == 4
        assert pfs["kv_bytes_moved"] == decs["kv_bytes_moved"] == \
            4 * tkt.block_nbytes((2, 4, 32), torch.float32)
        assert decs["prefill_tokens_saved"] >= 8 and decs["cow_copies"] >= 1
        for e in (pf, dec, uni):
            st = e.stats()
            assert st["step_traces"] == st["prefill_traces"] == 1
        for e in (pf, dec):
            e._pool.check()
            assert e.pool_drift() is None
    finally:
        _stop(pf, dec, uni)


def test_dedup_at_source_and_arrival(port):
    p, = _prompts(11, (8,))
    want = _oracle([p], 6)[0]
    pf, dec = _engines("pf", "dec")
    try:
        first = pf.submit_prefill(p).result(timeout=120)["xfer"]
        info = dec.splice(first)
        assert info["xfer_blocks"] == 2 and info["dedup_blocks"] == 0
        np.testing.assert_array_equal(
            dec.submit(p, 6, xfer_info=info).result(timeout=120)["result"],
            want)
        known = dec.health()["cached_chains"]
        assert known == [h.hex() for h in dec._pool.indexed_hashes()]
        second = pf.submit_prefill(p, known_hashes=known).result(
            timeout=120)["xfer"]
        assert second["dedup_blocks"] == 2 and not second["blocks"]
        assert tkt.payload_bytes(second) == 0
        info2 = dec.splice(second)
        assert info2["xfer_blocks"] == 0 and info2["dedup_blocks"] == 2
        np.testing.assert_array_equal(
            dec.submit(p, 6, xfer_info=info2).result(timeout=120)["result"],
            want)
        third = pf.submit_prefill(p).result(timeout=120)["xfer"]
        assert len(third["blocks"]) == 2
        info3 = dec.splice(third)
        assert info3["xfer_blocks"] == 0 and info3["dedup_blocks"] == 2
        s = dec.stats()
        assert s["xfer_dedup_blocks"] == 4
        assert 0.0 < s["xfer_dedup_hit_rate"] <= 1.0
        assert pf.stats()["xfer_dedup_blocks"] == 2
        dec._pool.check()
        assert dec.pool_drift() is None
    finally:
        _stop(pf, dec)


def test_splice_rejects_bad_payloads_and_chain_gaps(port):
    p, = _prompts(13, (12,))
    want = _oracle([p], 6)[0]
    pf, dec = _engines("pf", "dec")
    try:
        payload = pf.submit_prefill(p).result(timeout=120)["xfer"]
        info = dec.splice(dict(payload, snapshot_version=999))
        assert info["xfer_blocks"] == 0 and "skipped" in info
        assert "skipped" in dec.splice(dict(payload, block_size=8))
        assert "skipped" in dec.splice(dict(payload, shape=[2, 4, 16]))
        assert "skipped" in dec.splice(dict(payload, dtype="bfloat16"))
        assert "skipped" in dec.splice({"v": 99})
        info = dec.splice(tkt.drop_blocks(payload))
        assert info["xfer_blocks"] == 0 and info["dedup_blocks"] == 0
        gap = dict(payload, blocks={h: r for h, r in payload["blocks"].items()
                                    if h != payload["hashes"][1]})
        assert dec.splice(gap)["xfer_blocks"] == 1
        np.testing.assert_array_equal(
            dec.submit(p, 6).result(timeout=120)["result"], want)
        dec._pool.check()
        assert dec.pool_drift() is None
    finally:
        _stop(pf, dec)


def test_int8_blocks_ship_with_their_scales(port):
    """int8 prefill -> int8 decode: the payload carries the pool's int8
    bytes and each block's f32 scale columns, its bytes are blocks x
    ``block_nbytes`` with the scales counted, the spliced blocks equal
    the source's bit for bit, and the decode side's tokens equal the
    source engine serving the same prompt from its own cache. An int8
    payload into an fp engine is skipped (the seed is tagged)."""
    prompts = _prompts(17, (12, 9))
    pf, dec = _engines("pf8", "dec8", kv_quant="int8")
    fp, = _engines("fp")
    try:
        for p in prompts:
            payload = pf.submit_prefill(p).result(timeout=120)["xfer"]
            assert payload["dtype"] == "int8"
            n = len(p) // 4
            per = tkt.block_nbytes(payload["shape"], "int8")
            assert per == 2 * 2 * 4 * 32 + 2 * 2 * 4
            assert tkt.payload_bytes(payload) == n * per
            assert all("ks" in r and "vs" in r
                       for r in payload["blocks"].values())
            info = dec.splice(payload)
            assert info["xfer_blocks"] == n and info["xfer_bytes"] == n * per
            src = pf._pool.lookup([bytes.fromhex(x)
                                   for x in payload["hashes"]])
            dst = dec._pool.lookup([bytes.fromhex(x)
                                    for x in payload["hashes"]])
            assert len(src) == len(dst) == n
            for a, b in ((pf._k_cache, dec._k_cache),
                         (pf._v_cache, dec._v_cache),
                         (pf._k_scales, dec._k_scales),
                         (pf._v_scales, dec._v_scales)):
                assert torch.equal(a[:, src], b[:, dst])
            pf._pool.decref(src)
            dec._pool.decref(dst)
            got = dec.submit(p, 6, xfer_info=info).result(
                timeout=120)["result"]
            np.testing.assert_array_equal(
                got, pf.submit(p, 6).result(timeout=120)["result"])
            skipped = fp.splice(payload)
            assert skipped["xfer_blocks"] == 0 and "skipped" in skipped
        for e in (pf, dec):
            e._pool.check()
            assert e.pool_drift() is None
    finally:
        _stop(pf, dec, fp)


def test_transfer_unsupported_surfaces(port):
    plain, = _engines("plain", max_prompt=8, prefix_cache=False)
    try:
        assert not plain.supports_transfer
        with pytest.raises(RuntimeError):
            plain.submit_prefill(np.arange(1, 9, dtype=np.int32))
        info = plain.splice({"v": 1})
        assert info["xfer_blocks"] == 0 and info["skipped"] == "unsupported"
        st = plain.stats()
        assert "kv_bytes_moved" not in st and "xfer_blocks" not in st
        assert "cached_chains" not in plain.health()
    finally:
        _stop(plain)


# -- the fleet -----------------------------------------------------------------

class _KV:
    def __init__(self):
        self._d = {}
        self._cv = threading.Condition()

    def key_value_set(self, key, val, allow_overwrite=False):
        with self._cv:
            self._d[key] = val
            self._cv.notify_all()

    def blocking_key_value_get(self, key, timeout_ms):
        deadline = time.monotonic() + timeout_ms / 1000.0
        with self._cv:
            while key not in self._d:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"NOT_FOUND: {key}")
                self._cv.wait(left)
            return self._d[key]

    def key_value_try_get(self, key):
        with self._cv:
            if key not in self._d:
                raise KeyError(f"NOT_FOUND: {key}")
            return self._d[key]


def _fleet(label, roles, engines, chaos=None):
    from multiverso_tpu_torch.serving import (FaultPlan, FleetConfig,
                                              FleetRouter, ReplicaServer)

    kv = _KV()
    size = len(roles) + 1
    # DEAD after two silent beats: long enough that a loaded host's
    # stalls do not flag a healthy replica (the two-stage route needs both)
    router = FleetRouter(size, kv, label=label, name=label,
                         fleet_config=FleetConfig(heartbeat_ms=200,
                                                  deadline_s=120.0))
    replicas = [ReplicaServer(r + 1, size, kv, engines[r], label=label,
                              heartbeat_ms=200, role=role)
                for r, role in enumerate(roles)]
    if chaos is not None:
        replicas[0].chaos = FaultPlan(chaos, kill_fn=replicas[0].die)
    deadline = time.monotonic() + 20
    while not (router.stats()["up"] == len(roles) and [
            row["role"] for row in router.replica_rows()] == list(roles)):
        assert time.monotonic() < deadline, router.replica_rows()
        time.sleep(0.01)
    return router, replicas


def _serve(router, replicas, prompts):
    try:
        outs = [np.asarray(f.result(timeout=120)["result"]) for f in
                [router.submit(p, 6, tenant=f"t{i % 3}")
                 for i, p in enumerate(prompts)]]
        return outs, router.stats()
    finally:
        router.stop()
        for rep in replicas:
            rep.stop(stop_engine=False)


@pytest.mark.parametrize("chaos", [None, "kv_xfer_drop=2"])
def test_fleet_disaggregated_equals_unified(port, chaos):
    """One prefill and one decode replica against two unified ones on
    the same prompts (two share a prefix): equal outputs, equal to JAX
    ``greedy_decode``, ``kv_bytes_moved`` = shipped blocks x
    ``block_nbytes``, and a dropped transfer loses nothing."""
    rng = np.random.default_rng(19)
    shared = rng.integers(1, SMALL["vocab_size"], 8).astype(np.int32)
    prompts = [np.concatenate([shared, t]) for t in _prompts(23, (4, 6))]
    prompts += _prompts(29, (8, 12, 3))
    want = _oracle(prompts, 6)
    engines = _engines("f0", "f1", "f2", "f3", cost_ledger=True)
    try:
        outs_u, st_u = _serve(*_fleet("uni", ("unified", "unified"),
                                      engines[2:]), prompts)
        outs_d, st_d = _serve(*_fleet("dis", ("prefill", "decode"),
                                      engines[:2], chaos), prompts)
        for i, (a, b, w) in enumerate(zip(outs_u, outs_d, want)):
            np.testing.assert_array_equal(a, w, err_msg=str(i))
            np.testing.assert_array_equal(b, w, err_msg=str(i))
        assert st_u["kv_xfers"] == 0 and st_u["requests_lost"] == 0
        assert st_d["requests_lost"] == 0 and st_d["output_mismatches"] == 0
        assert st_d["kv_xfers"] == len(prompts)
        per = tkt.block_nbytes((2, 4, 32), torch.float32)
        assert st_d["kv_bytes_moved"] == st_d["xfer_blocks"] * per
        full = sum(len(p) // 4 for p in prompts)
        if chaos:
            assert st_d["xfer_blocks"] < full
        else:
            assert st_d["xfer_blocks"] + st_d["xfer_dedup_blocks"] == full
        # the ledgers balance on every engine, tenants included
        for e in engines:
            st = e.stats()
            assert st["accounting_drift"] == 0, e.name
        assert set(engines[1].ledger.tenants()) == {"t0", "t1", "t2"}
    finally:
        _stop(*engines)
