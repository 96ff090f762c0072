"""The serving engine over a tp group of processes, against the JAX engine.

The port's ``decode_tp`` engine (the group's rank 0 runs the loop and
broadcasts each program call; every rank runs it on its heads' shard of
the weights and the KV pools), its ``prefill_sp`` chunks (ring and
Ulysses), the sharded programs and the serving faces of ring and Ulysses
attention run in one group of 2 fresh interpreters on the CPU (gloo),
spawned once by a module-scoped fixture as ``tests/test_torch_mesh.py``
does: its processes run every case and save the results, and each case
is its own test that reads them. The JAX side runs meanwhile in this
process, on the conftest's virtual CPU devices, on the same weights
(``tests/test_sharded_decode.py::_tp_cfg``'s model in f32, carried
across with ``params_from_jax``) and the same requests made with numpy
from a seed.

Held as the JAX tests hold their own: the port's tp=2 tokens equal the
JAX engine's tp=2 and tp=1 tokens exactly on the shared traces
(``tests/test_sharded_decode.py``), and a seqpar engine's tokens equal
the single-lane engine's (``tests/test_seqpar_prefill.py``); KV export and
splice into and out of the group decode the JAX engines' tokens in each
direction (``tests/test_kv_transfer.py:290``'s traffic, and int8), a
tp=2 export is the tp=1 payload, and after skipped or shortened splices
the ranks' pools joined along D are a tp=1 engine's. The follower
is given zeroed weights: it serves the leader's pin or the tokens would
differ. Tolerances: the serving faces of ring and Ulysses attention and
the sharded programs' float outputs and pools within ``TOL`` of JAX's
(f32; the two packages' products sum in different orders); their tokens
exactly; an int8 pool's bytes within one step of JAX's where a value sits
at a rounding boundary (``Q8_TOL``) and its scales within ``TOL``.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest

from test_torch_multiprocess import _HEAD, _free_port

import multiverso_tpu as jmv
from multiverso_tpu import topology as jtopo
from multiverso_tpu.models import transformer as jtf
from multiverso_tpu.ops import (ring_prefill_attention as jax_ring_prefill,
                                ulysses_prefill_attention as
                                jax_ulysses_prefill)
from multiverso_tpu.serving import InferenceServer as JaxServer
from multiverso_tpu.serving import snapshot as jsnap

N = 2
TIMEOUT_S = 120
TOL = dict(rtol=1e-5, atol=1e-5)
Q8_TOL = 1
DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=48)
# tests/test_seqpar_prefill.py::_sp_cfg: max_prompt 24 + max_new 8
SP_DIMS = dict(DIMS, max_seq=32)
# the traces of tests/test_sharded_decode.py: (seed, knobs)
TRACES = {
    "prefix": (3, dict(slots=4, max_prompt=16, max_new=8, kv_block_size=4,
                       prefill_token_budget=5, prefix_cache=True)),
    "noprefix": (3, dict(slots=4, max_prompt=16, max_new=8,
                         kv_block_size=4, prefill_token_budget=5,
                         prefix_cache=False)),
    "mono": (7, dict(slots=4, max_prompt=8, max_new=6, kv_block_size=4,
                     prefill_token_budget=0, prompt_buckets=(8,))),
    "spec": (11, dict(slots=4, max_prompt=12, max_new=8, kv_block_size=4,
                      prefill_token_budget=5, spec_k=3)),
    "int8": (13, dict(slots=4, max_prompt=16, max_new=8, kv_block_size=4,
                      prefill_token_budget=5, kv_quant="int8",
                      decode_param_quant="int8")),
}
SEQPAR = [(backend, tp) for backend in ("ring", "ulysses") for tp in (1, 2)]
# tests/test_kv_transfer.py::test_disagg_decode_tp2_subprocess: its model,
# its knobs and its prompt
XDIMS = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=1, d_ff=32,
             max_seq=16)
XKNOBS = dict(slots=2, max_prompt=8, max_new=6, kv_block_size=2,
              prefill_token_budget=2, prefix_cache=True, watchdog=False)
X_PROMPT = [3, 5, 7, 2, 9, 4]
# the transfer flows: name -> (weights, dims, knobs); f32 on the model
# above, int8 on the int8 trace's model and knobs
XFER = {"f32": ("x", XDIMS, XKNOBS),
        "int8": ("p", {}, dict(TRACES["int8"][1], prefix_cache=True))}
# the skips: a 14-token prompt's 7 blocks from a source that holds it,
# into engines of 6 blocks whose command takes 5 (M = (8 + 2) / 2)
SKIP_SOURCE = dict(XKNOBS, max_prompt=14, max_new=2)
SKIP_KNOBS = dict(XKNOBS, max_prompt=8, max_new=2, kv_pool_blocks=6)
# the refusals: (knobs, the word the FatalError names)
REFUSALS = {
    "heads3": (dict(max_prompt=16, max_new=8, kv_block_size=4,
                    decode_tp=3), "n_heads"),
    "contiguous": (dict(max_prompt=16, max_new=8, kv_block_size=0,
                        decode_tp=2), "paged"),
    "above_group": (dict(max_prompt=16, max_new=8, kv_block_size=4,
                         decode_tp=4), "decode_tp 4"),
    "sp_int8": (dict(max_prompt=24, max_new=8, kv_block_size=4,
                     prefill_token_budget=4, kv_quant="int8",
                     prefill_sp=True), "kv_quant=int8"),
    "sp_backend": (dict(max_prompt=24, max_new=8, kv_block_size=4,
                        prefill_token_budget=4, prefill_sp=True,
                        prefill_sp_backend="tree"), "prefill_sp_backend"),
    "sp_threshold": (dict(max_prompt=24, max_new=8, kv_block_size=4,
                          prefill_token_budget=4, prefill_sp=True,
                          prefill_sp_threshold=-1), "prefill_sp_threshold"),
    "ring_t": (dict(max_prompt=15, max_new=8, kv_block_size=4,
                    prefill_token_budget=4, decode_tp=2, prefill_sp=True),
               "ring prefill_sp"),
}
# the sharded programs held against JAX's: name -> (kv_quant,
# param_quant, prefill_sp)
PROGRAMS = {"step": ("none", "none", "none"),
            "chunk": ("none", "none", "none"),
            "admit": ("none", "none", "none"),
            "cow": ("none", "none", "none"),
            "verify": ("none", "none", "none"),
            "step_q": ("int8", "int8", "none"),
            "chunk_q": ("int8", "int8", "none"),
            "admit_q": ("int8", "int8", "none"),
            "cow_q": ("int8", "int8", "none"),
            "verify_q": ("int8", "int8", "none"),
            "chunk_sp_ring": ("none", "none", "ring"),
            "chunk_sp_ulysses": ("none", "none", "ulysses")}
# the programs' geometry: slots, blocks (scratch block 0 besides), block
# size, blocks a slot, logical length, chunk, window
PS, PN, PBS, PM, PT, PC, PK1 = 4, 25, 4, 6, 24, 5, 4
LEADER_TIMEOUT_S = 2.0


def _tp_cfg(**kw):
    return jtf.TransformerConfig(**dict(DIMS, **kw))


def _requests(rng, n, vocab, max_prompt, max_new, shared_head=None):
    """tests/test_sharded_decode.py::_random_reqs."""
    reqs = []
    for i in range(n):
        plen = int(rng.integers(1, max_prompt - (len(shared_head)
                                                 if shared_head is not None
                                                 else 0) + 1))
        tail = rng.integers(1, vocab, plen).astype(np.int32)
        prompt = (np.concatenate([shared_head, tail])
                  if shared_head is not None and i % 2 == 0 else tail)
        reqs.append((prompt, int(rng.integers(1, max_new + 1))))
    return reqs


def _trace(name):
    seed, knobs = TRACES[name]
    rng = np.random.default_rng(seed)
    vocab = DIMS["vocab_size"]
    if name in ("prefix", "noprefix"):
        head = rng.integers(1, vocab, 8).astype(np.int32)
        return _requests(rng, 12, vocab, 14, 8,
                         head if name == "prefix" else None)
    if name == "mono":
        return _requests(rng, 10, vocab, 8, 6)
    if name == "spec":
        # tests/test_sharded_decode.py's repetitive prompts
        reqs = []
        for _ in range(8):
            motif = rng.integers(1, vocab, int(rng.integers(2, 5)))
            plen = int(rng.integers(4, 13))
            prompt = np.tile(motif, -(-plen // len(motif)))[:plen]
            reqs.append((prompt.astype(np.int32), int(rng.integers(4, 9))))
        return reqs
    return _requests(rng, 10, vocab, 14, 8)


def _xfer_reqs(name):
    """A transfer flow's requests: the JAX test's prompt, 5 new tokens;
    for int8 the int8 trace's first three prompts of two blocks or more."""
    if name == "f32":
        return [(np.array(X_PROMPT, np.int32), 5)]
    return [(p, n) for p, n in _trace("int8") if len(p) >= 8][:3]


def _skip_prompt():
    return np.random.default_rng(22).integers(
        1, XDIMS["vocab_size"], 14).astype(np.int32)


def _blocks(payload):
    """A payload's shipped blocks in chain order: K and V ``[n, L, Bs,
    D]`` and, for int8, their scales ``[n, L]``."""
    from multiverso_tpu_torch.serving import kv_transfer as tkt

    if isinstance(payload, (str, np.ndarray)):
        payload = json.loads(str(payload))
    out = {"k": [], "v": [], "ks": [], "vs": []}
    for h in payload["hashes"]:
        rec = payload["blocks"].get(h)
        if rec is None:
            continue
        k, v = tkt.unpack_block(rec, payload["shape"], payload["dtype"])
        out["k"].append(k.numpy())
        out["v"].append(v.numpy())
        scales = tkt.unpack_scales(rec, payload["shape"][0])
        if scales is not None:
            out["ks"].append(scales[0])
            out["vs"].append(scales[1])
    return {k: np.stack(v) for k, v in out.items() if v}


def _seqpar_trace():
    """tests/test_seqpar_prefill.py::_mixed_reqs at threshold 8."""
    rng = np.random.default_rng(5)
    reqs = []
    for i in range(12):
        lo, hi = (8, 24) if i % 2 == 0 else (1, 7)
        plen = int(rng.integers(lo, hi + 1))
        reqs.append((rng.integers(1, 64, plen).astype(np.int32),
                     int(rng.integers(1, 9))))
    return reqs


def _program_inputs():
    """The sharded programs' inputs, from seed 20: random fp and int8
    pools (scales > 0), one table of distinct blocks a slot, the step's
    and the window's tokens, positions and masks, a chunk at offset 4."""
    rng = np.random.default_rng(20)
    D, L = DIMS["d_model"], DIMS["n_layers"]
    shape = (L, PN + 1, PBS, D)
    x = {"kc": rng.standard_normal(shape).astype(np.float32),
         "vc": rng.standard_normal(shape).astype(np.float32),
         "kq": rng.integers(-127, 128, shape).astype(np.int8),
         "vq": rng.integers(-127, 128, shape).astype(np.int8),
         "ks": rng.uniform(0.01, 0.05, (L, PN + 1)).astype(np.float32),
         "vs": rng.uniform(0.01, 0.05, (L, PN + 1)).astype(np.float32)}
    x["bt"] = (1 + rng.permutation(PN)[:PS * PM]).reshape(PS, PM).astype(
        np.int32)
    x["tok"] = rng.integers(1, 64, PS).astype(np.int32)
    x["pos"] = np.array([3, 9, 17, 22], np.int32)
    x["active"] = np.array([True, True, False, True])
    x["toks"] = rng.integers(1, 64, (PS, PK1)).astype(np.int32)
    x["nv"] = np.array([4, 2, 1, 3], np.int32)
    x["wpos"] = np.array([2, 8, 0, 16], np.int32)
    x["chunk"] = rng.integers(1, 64, PC).astype(np.int32)
    x["chunk_sp"] = rng.integers(1, 64, PC * N - 2).astype(np.int32)
    x["prompt"] = rng.integers(1, 64, (1, 8)).astype(np.int32)
    return x


def _op_inputs():
    """The serving faces' inputs: tests/test_seqpar_prefill.py's shapes
    (C 8, T 16, H 2, D 16, offset 4)."""
    rng = np.random.default_rng(21)
    return {"q": rng.standard_normal((8, 16)).astype(np.float32),
            "k": rng.standard_normal((16, 16)).astype(np.float32),
            "v": rng.standard_normal((16, 16)).astype(np.float32)}


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}.")
        else:
            yield prefix + k, np.asarray(tree[k])


_CHILD = r"""
    os.nice(10)
    import faulthandler, json, traceback
    import torch
    # every thread's stack on stderr before the fixture gives up
    faulthandler.dump_traceback_later(
        float(os.environ["MV_TEST_TIMEOUT"]) - 10, exit=True)
    out_dir = os.environ["MV_TEST_OUT"]
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    cases = json.loads(open(os.path.join(out_dir, "cases.json")).read())
    from multiverso_tpu_torch.log import FatalError
    from multiverso_tpu_torch.models import transformer as tf
    from multiverso_tpu_torch.serving import InferenceServer
    from multiverso_tpu_torch.serving.snapshot import (
        quantize_decode_params, shard_for_decode)
    from multiverso_tpu_torch import topology as T
    res, errors = {}, {}

    def case(name, fn):
        try:
            for key, val in fn().items():
                res[f"{name}/{key}"] = np.asarray(val)
        except Exception:
            errors[name] = traceback.format_exc()

    mv.init(["dtp", "-device=cpu", "-log_level=error"])
    assert mv.size() == 2
    weights = {}
    for key in ("p", "x"):
        whole = {k[2:]: v for k, v in inp.items() if k.startswith(key + "/")}
        weights[key] = {"embed": whole["embed"], "pos": whole["pos"],
                        "ln_f_g": whole["ln_f_g"],
                        "layers": {k.split(".")[1]: v
                                   for k, v in whole.items()
                                   if k.startswith("layers.")}}
    params = weights["p"]

    def model(attention="reference", params_key="p", **over):
        cfg = tf.TransformerConfig(**dict(cases["dims"], **over),
                                   attention=attention)
        lm = tf.TransformerLM(cfg)
        p = tf.params_from_jax(weights[params_key], device="cpu")
        if rank:
            # a follower never reads its own model: zero weights show it
            p = tf._map(torch.zeros_like, p)
        lm.params = tf._map(lambda w: w.requires_grad_(), p)
        return lm

    def serve(name, lm, reqs, **knobs):
        srv = InferenceServer("dtp")
        eng = srv.register_decoder(name, lm, **knobs)
        eng.warmup()
        outs = []
        if rank == 0:
            futs = [srv.submit(name, {"prompt": p, "max_new": n})
                    for p, n in reqs]
            outs = [f.result(timeout=60)["result"].tolist() for f in futs]
        srv.stop()
        st = eng.stats()
        summ = eng.recorder.summary() if eng.recorder is not None else {}
        return outs, st, summ

    def reqs_of(name):
        return [(inp[f"{name}/{i}"], int(n))
                for i, n in enumerate(inp[f"{name}/max_new"])]

    def stats_out(st, summ):
        keys = ("step_traces", "prefill_traces", "decode_step_retraces",
                "prefix_hits", "pin_copies", "kv_bytes_per_device",
                "kv_pool_blocks", "decode_tp", "mesh_devices",
                "verify_traces", "spec_accepted", "seqpar_traces",
                "seqpar_chunks", "prefill_sp_chunk", "completed")
        out = {k: st[k] for k in keys if k in st}
        out["recorder"] = [summ.get("decode_tp", -1),
                           summ.get("mesh_devices", -1)]
        out["calls"] = json.dumps(st.get("follower_calls", {}))
        return out

    for name in cases["traces"]:
        def traced(name=name):
            knobs = dict(cases["knobs"][name])
            attention = "flash_force" if name == "mono" else "reference"
            outs, st, summ = serve(f"lm_{name}", model(attention),
                                   reqs_of(name), decode_tp=2, **knobs)
            out = stats_out(st, summ)
            out["outs"] = json.dumps(outs)
            return out
        case(f"trace_{name}", traced)

    for backend, tp in cases["seqpar"]:
        def seqpar(backend=backend, tp=tp):
            lm = model(**cases["sp_dims"])
            out = {}
            for sp in (False, True):
                outs, st, summ = serve(
                    f"lm_sp{int(sp)}_{backend}{tp}", lm,
                    reqs_of("seqpar"), slots=4, max_prompt=24, max_new=8,
                    kv_block_size=4, prefill_token_budget=4, decode_tp=tp,
                    prefill_sp=sp, prefill_sp_backend=backend,
                    prefill_sp_threshold=8)
                out[f"outs{int(sp)}"] = json.dumps(outs)
                out.update({f"{k}{int(sp)}": v for k, v in
                            stats_out(st, summ).items()})
            return out
        case(f"seqpar_{backend}{tp}", seqpar)

    for name, (knobs, _) in cases["refusals"].items():
        def refusal(knobs=knobs):
            srv = InferenceServer("dtp")
            try:
                srv.register_decoder("lm_bad", model(), **knobs)
            except FatalError as exc:
                return {"refused": str(exc)}
            return {"refused": ""}
        case(f"refuse_{name}", refusal)

    # disaggregated serving into and out of the group: each flow's tp=2
    # engines (collective) beside the leader's tp=1 engines, one lm each
    def result(fut):
        return fut.result(timeout=60)

    def xfer(name, params_key, reqs, knobs):
        lm = model(params_key=params_key, **cases["xfer_dims"][name])
        srv = InferenceServer("dtp")
        two = {k: srv.register_decoder(f"{name}_{k}2", lm, decode_tp=2,
                                       **knobs)
               for k in ("pf", "dec", "uni")}
        for eng in two.values():
            eng.warmup()
        out = {}
        if rank == 0:
            one = {k: srv.register_decoder(f"{name}_{k}1", lm, decode_tp=1,
                                           **knobs) for k in ("pf", "dec")}
            for eng in one.values():
                eng.warmup()
            for i, (p, n) in enumerate(reqs):
                pay1 = result(one["pf"].submit_prefill(p))["xfer"]
                pay2 = result(two["pf"].submit_prefill(p))["xfer"]
                info12 = two["dec"].splice(pay1)
                info21 = one["dec"].splice(pay2)
                out[f"pay1_{i}"] = json.dumps(pay1)
                out[f"pay2_{i}"] = json.dumps(pay2)
                out[f"info12_{i}"] = json.dumps(info12)
                out[f"info21_{i}"] = json.dumps(info21)
                for key, eng, info in (("out12", two["dec"], info12),
                                       ("out21", one["dec"], info21),
                                       ("uni2", two["uni"], None)):
                    out[f"{key}_{i}"] = result(eng.submit(
                        p, n, xfer_info=info))["result"]
            # source-side dedup: the first hash advertised, then all
            p = reqs[0][0]
            hashes = json.loads(out["pay1_0"])["hashes"]
            for key, eng, known in (("known1", one["pf"], hashes[:1]),
                                    ("known2", two["pf"], hashes[:1]),
                                    ("all2", two["pf"], hashes)):
                out[key] = json.dumps(result(eng.submit_prefill(
                    p, known_hashes=known))["xfer"])
        srv.stop()
        for k, eng in two.items():
            st = eng.stats()
            out[f"calls_{k}"] = json.dumps(st.get("follower_calls", {}))
            for key in ("prefill_tokens_saved", "decode_step_retraces",
                        "xfer_blocks", "kv_bytes_moved"):
                out[f"{key}_{k}"] = st[key]
        return out

    for name in cases["xfer"]:
        reqs = reqs_of(f"xfer_{name}")
        case(f"xfer_{name}", lambda name=name, reqs=reqs: xfer(
            name, cases["xfer_params"][name], reqs,
            cases["xfer_knobs"][name]))

    # payloads that skip whole or shorten, spliced into a tp=2 and a tp=1
    # engine alike; then each rank's pools
    def skips():
        lm = model(params_key="x", **cases["xfer_dims"]["f32"])
        srv = InferenceServer("dtp")
        knobs = cases["skip_knobs"]
        two = srv.register_decoder("skip2", lm, decode_tp=2, **knobs)
        two.warmup()
        out = {}
        if rank == 0:
            from multiverso_tpu_torch.serving import kv_transfer

            src = srv.register_decoder("skip_pf", lm, decode_tp=1,
                                       **cases["skip_source"])
            one = srv.register_decoder("skip1", lm, decode_tp=1, **knobs)
            src.warmup()
            one.warmup()
            pay = result(src.submit_prefill(inp["skip/0"]))["xfer"]
            payloads = [dict(pay, snapshot_version=pay["snapshot_version"]
                             + 1),
                        dict(pay, block_size=2 * pay["block_size"]),
                        kv_transfer.drop_blocks(pay), pay]
            for i, payload in enumerate(payloads):
                for tag, eng in (("2", two), ("1", one)):
                    out[f"info{tag}_{i}"] = json.dumps(eng.splice(payload))
            out["k1"], out["v1"] = one._k_cache.numpy(), one._v_cache.numpy()
        srv.stop()
        out["k"], out["v"] = two._k_cache.numpy(), two._v_cache.numpy()
        out["calls"] = json.dumps(two.stats().get("follower_calls", {}))
        return out
    case("skips", skips)

    # the sharded programs on this rank's shards
    mesh = T.make_mesh((2,), ("tp",))
    cfg = tf.TransformerConfig(**cases["dims"])
    # a copy: the programs write their pools and scales in place
    t = lambda k, dt=None: torch.tensor(inp[k], dtype=dt)
    i64 = torch.int64
    d = cfg.d_model // 2
    cut = lambda x: x[..., rank * d:(rank + 1) * d].clone()
    for name, (kvq, pq, sp) in cases["programs"].items():
        def program(name=name, kvq=kvq, pq=pq, sp=sp):
            progs = tf.make_sharded_decode_programs(
                cfg, mesh, cases["T"], kv_quant=kvq, param_quant=pq,
                prefill_sp=sp)
            whole_p = tf.params_from_jax(params, device="cpu")
            if pq == "int8":
                whole_p = quantize_decode_params(whole_p)
            mine = shard_for_decode(whole_p if rank == 0 else None, mesh,
                                    progs["param_shardings"])
            if kvq == "int8":
                pools = [cut(t("kq")), cut(t("vq")), t("ks"), t("vs")]
            else:
                pools = [cut(t("kc")), cut(t("vc"))]
            bt = t("bt", i64)
            kind = name.split("_")[0]
            if kind == "step":
                outs = progs["step"](mine, *pools, bt, t("tok", i64),
                                     t("pos", i64), t("active"))
                extra = {"nxt": outs[-2], "pos": outs[-1]}
            elif kind == "chunk" and sp == "none":
                outs = progs["chunk"](mine, *pools, bt, torch.tensor(1),
                                      t("chunk", i64), torch.tensor(4),
                                      torch.tensor(4))
                extra = {"logits": outs[-1]}
            elif kind == "chunk":
                toks = torch.zeros(cases["C"] * 2, dtype=i64)
                toks[:len(inp["chunk_sp"])] = t("chunk_sp", i64)
                outs = progs["chunk_sp"](mine, *pools, bt, torch.tensor(2),
                                         toks, torch.tensor(4),
                                         torch.tensor(len(inp["chunk_sp"])))
                extra = {"logits": outs[-1]}
            elif kind == "admit":
                outs = progs["admit"](mine, *pools, bt[1:2],
                                      t("prompt", i64), torch.tensor([7]))
                extra = {"first": outs[0]}
            elif kind == "cow":
                outs = progs["cow"](*pools, torch.tensor(int(inp["bt"][0, 1])),
                                    torch.tensor(int(inp["bt"][3, 2])))
                extra = {}
            else:
                outs = progs["verify"](mine, *pools, bt, t("toks", i64),
                                       t("wpos", i64), t("active"),
                                       t("nv", i64))
                extra = {"out": outs[-1]}
            out = {f"pool{i}": p.numpy() for i, p in enumerate(pools)}
            out.update({k: v.numpy() for k, v in extra.items()})
            return out
        case(f"program_{name}", program)

    # the serving faces on the rank's rows
    from multiverso_tpu_torch.ops import (ring_prefill_attention,
                                          ulysses_prefill_attention)
    from multiverso_tpu_torch.models.transformer import _chunk_attention
    q, k, v = (torch.from_numpy(inp[f"op_{x}"]) for x in "qkv")
    c, tt = q.shape[0] // 2, k.shape[0] // 2
    rows = slice(rank * c, (rank + 1) * c)
    group = mesh.group("tp")
    case("op_ring", lambda: {"out": ring_prefill_attention(
        q[rows], k[rank * tt:(rank + 1) * tt], v[rank * tt:(rank + 1) * tt],
        2, torch.tensor(4), group).numpy()})
    case("op_ulysses", lambda: {"out": ulysses_prefill_attention(
        q[rows], k[:, rank * 8:(rank + 1) * 8], v[:, rank * 8:(rank + 1) * 8],
        2, torch.tensor(4), group).numpy()})
    case("op_lane", lambda: {"out": _chunk_attention(
        q, k, v, 2, torch.tensor(4)).numpy()})

    # last: a leader that goes silent (its pings off); the follower must
    # raise FatalError within the group's timeout (shortened here)
    def silent():
        from multiverso_tpu_torch.serving import decode_engine

        decode_engine._TP_TIMEOUT_S = cases["leader_timeout"]
        srv = InferenceServer("dtp")
        eng = srv.register_decoder(
            "lm_silent", model(), slots=2, max_prompt=8, max_new=4,
            kv_block_size=4, decode_tp=2)
        out = {}
        if rank == 0:
            eng._ping = lambda: None
            time.sleep(3 * cases["leader_timeout"])
            eng.stop()
            return {"raised": ""}
        t0 = time.monotonic()
        try:
            eng.join(timeout=30)
            out["raised"] = ""
        except FatalError as exc:
            out["raised"] = str(exc)
        out["after_s"] = time.monotonic() - t0
        return out
    case("silent", silent)

    np.savez(os.path.join(out_dir, f"res_{rank}.npz"), **res)
    with open(os.path.join(out_dir, f"errors_{rank}.json"), "w") as f:
        json.dump(errors, f)
    print(f"RANK{rank}_DTP_OK", flush=True)
    sys.stdout.flush()
    mv.shutdown()
"""


class GroupResults:
    """The group's saved results: ``get(case)`` gives each rank's arrays
    by key, and fails the test with the group's traceback where the case
    raised."""

    def __init__(self, out_dir, procs, outs) -> None:
        for rank, (proc, out) in enumerate(zip(procs, outs)):
            assert f"RANK{rank}_DTP_OK" in out, \
                f"rank {rank} (exit {proc.returncode}):\n{out[-3000:]}"
        self.res, self.errors = [], []
        for rank in range(N):
            with np.load(out_dir / f"res_{rank}.npz") as f:
                self.res.append(dict(f))
            self.errors.append(json.loads(
                (out_dir / f"errors_{rank}.json").read_text()))

    def get(self, case: str) -> list:
        for rank, errors in enumerate(self.errors):
            assert case not in errors, f"rank {rank}: {errors[case]}"
        out = [{k.split("/", 1)[1]: v for k, v in r.items()
                if k.startswith(case + "/")} for r in self.res]
        assert out[0], f"case {case} left no result"
        return out


def _start_group(out_dir):
    """The group's processes, started (run_group's environment)."""
    script = out_dir / "worker.py"
    script.write_text(_HEAD + textwrap.dedent(_CHILD))
    port = _free_port()
    procs = []
    for rank in range(N):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("MV_") and k != "PYTHONPATH"}
        env.update({"MV_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                    "MV_NUM_PROCESSES": str(N), "MV_PROCESS_ID": str(rank),
                    "MV_TEST_OUT": str(out_dir), "OMP_NUM_THREADS": "1",
                    "MV_TEST_TIMEOUT": str(TIMEOUT_S)})
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, cwd=str(out_dir),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _wait_group(procs, deadline):
    outs = []
    for rank, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            tails = [p.communicate()[0][-6000:] for p in procs]
            pytest.fail(f"rank {rank} timed out:\n" + "\n".join(
                f"rank {r}:\n{t}" for r, t in enumerate(tails)))
        outs.append(out)
    return outs


# -- the JAX side -------------------------------------------------------------

def _jax_serve(lm, reqs, name, **knobs):
    srv = JaxServer("t")
    eng = srv.register_decoder(name, lm, **knobs)
    eng.warmup()
    futs = [srv.submit(name, {"prompt": p, "max_new": n}) for p, n in reqs]
    outs = [f.result(timeout=120)["result"].tolist() for f in futs]
    srv.stop()
    return outs


def _jax_programs(params, x):
    """Every program of ``PROGRAMS`` on JAX's 2-device decode mesh."""
    import jax.numpy as jnp

    cfg = _tp_cfg()
    mesh = jtopo.make_mesh((N,), axis_names=(jtf.DECODE_TP_AXIS,),
                           devices=jax.devices()[:N])
    out = {}
    for name, (kvq, pq, sp) in PROGRAMS.items():
        progs = jtf.make_sharded_decode_programs(
            cfg, mesh, PT, kv_quant=kvq, param_quant=pq, prefill_sp=sp)
        value = jsnap.quantize_decode_params(params) if pq == "int8" \
            else params
        mine = jsnap.shard_for_decode(value, mesh, progs["param_shardings"])
        pools = ([x["kq"], x["vq"], x["ks"], x["vs"]] if kvq == "int8"
                 else [x["kc"], x["vc"]])
        pools = [jnp.asarray(p) for p in pools]
        kind = name.split("_")[0]
        i32 = np.int32
        if kind == "step":
            r = progs["step"](mine, *pools, x["bt"], x["tok"], x["pos"],
                              x["active"])
            res = {"nxt": r[-2], "pos": r[-1]}
        elif kind == "chunk" and sp == "none":
            r = progs["chunk"](mine, *pools, x["bt"], i32(1), x["chunk"],
                               i32(4), i32(4))
            res = {"logits": r[-1]}
        elif kind == "chunk":
            toks = np.zeros(PC * N, i32)
            toks[:len(x["chunk_sp"])] = x["chunk_sp"]
            r = progs["chunk_sp"](mine, *pools, x["bt"], i32(2), toks,
                                  i32(4), i32(len(x["chunk_sp"])))
            res = {"logits": r[-1]}
        elif kind == "admit":
            r = progs["admit"](mine, *pools, x["bt"][1:2], x["prompt"],
                               np.array([7], i32))
            res = {"first": r[0]}
            r = r[1:]
        elif kind == "cow":
            r = progs["cow"](*pools, i32(x["bt"][0, 1]), i32(x["bt"][3, 2]))
            res = {}
        else:
            r = progs["verify"](mine, *pools, x["bt"], x["toks"], x["wpos"],
                                x["active"], x["nv"])
            res = {"out": r[-1]}
        n_pools = len(pools)
        res.update({f"pool{i}": r[i] for i in range(n_pools)})
        out[name] = {k: np.asarray(v) for k, v in res.items()}
    return out


def _jax_xfer(lm, knobs, reqs):
    """JAX's disaggregated flows on ``reqs``: payloads of tp=1 and tp=2
    prefill engines, and the tokens of a tp=1 payload spliced into tp=1
    and tp=2 engines and of a tp=2 payload spliced into a tp=1 engine."""
    srv = JaxServer("t")
    eng = {}
    for name, tp in (("pf1", 1), ("pf2", 2), ("dec11", 1), ("dec12", 2),
                     ("dec21", 1)):
        eng[name] = srv.register_decoder(f"x_{name}", lm, decode_tp=tp,
                                         **knobs)
        eng[name].warmup()
    out = {}
    for i, (p, n) in enumerate(reqs):
        pay = {tp: eng[f"pf{tp}"].submit_prefill(p).result(timeout=120)[
            "xfer"] for tp in (1, 2)}
        out[f"pay2_{i}"] = pay[2]
        for src, dst in ((1, 1), (1, 2), (2, 1)):
            dec = eng[f"dec{src}{dst}"]
            info = dec.splice(pay[src])
            out[f"out{src}{dst}_{i}"] = dec.submit(
                p, n, xfer_info=info).result(timeout=120)["result"].tolist()
    srv.stop()
    return out


def _jax_side(params, x, ops):
    """Every JAX reference: the traces at tp 1 and 2, the transfer flows,
    the programs and the serving faces."""
    jmv.shutdown()
    jmv.init()
    ref = {}
    try:
        for name, (_, dims, knobs) in XFER.items():
            ref_lm = jtf.TransformerLM(_tp_cfg(**dims))
            ref[f"xfer_{name}"] = _jax_xfer(ref_lm, knobs, _xfer_reqs(name))
        # the same init as the params the group was given
        lm = jtf.TransformerLM(_tp_cfg())
        for name in TRACES:
            knobs = TRACES[name][1]
            reqs = _trace(name)
            ref[name] = {tp: _jax_serve(lm, reqs, f"j_{name}{tp}",
                                        decode_tp=tp, **knobs)
                         for tp in (1, 2)}
            if name == "spec":
                plain = dict(knobs, spec_k=0)
                ref[name]["plain"] = _jax_serve(lm, reqs, "j_plain",
                                                decode_tp=1, **plain)
        ref["programs"] = _jax_programs(params, x)
        mesh = jtopo.make_mesh((N,), axis_names=(jtopo.SEQ_AXIS,),
                               devices=jax.devices()[:N])
        q, k, v = ops["q"], ops["k"], ops["v"]
        off = np.int32(4)
        ref["op_ring"] = np.asarray(jax_ring_prefill(q, k, v, 2, off, mesh))
        ref["op_ulysses"] = np.asarray(jax_ulysses_prefill(q, k, v, 2, off,
                                                           mesh))
    finally:
        jmv.shutdown()
    return ref


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The group of 2, spawned once (at first use), at most 120 s; the
    JAX references are computed while it runs."""
    out_dir = tmp_path_factory.mktemp("decode_tp")
    jmv.shutdown()
    jmv.init()
    try:
        params = jax.tree.map(np.asarray,
                              jtf.TransformerLM(_tp_cfg()).params)
        xparams = jax.tree.map(np.asarray,
                               jtf.TransformerLM(_tp_cfg(**XDIMS)).params)
    finally:
        jmv.shutdown()
    x, ops = _program_inputs(), _op_inputs()
    inputs = {f"p/{k}": v for k, v in _flat(params)}
    inputs.update({f"x/{k}": v for k, v in _flat(xparams)})
    inputs.update(x)
    inputs.update({f"op_{k}": v for k, v in ops.items()})
    traces = {name: _trace(name) for name in TRACES}
    traces["seqpar"] = _seqpar_trace()
    traces.update({f"xfer_{name}": _xfer_reqs(name) for name in XFER})
    traces["skip"] = [(_skip_prompt(), 1)]
    for name, reqs in traces.items():
        for i, (p, _) in enumerate(reqs):
            inputs[f"{name}/{i}"] = p.astype(np.int64)
        inputs[f"{name}/max_new"] = np.array([n for _, n in reqs])
    np.savez(out_dir / "inputs.npz", **inputs)
    (out_dir / "cases.json").write_text(json.dumps(dict(
        dims=DIMS, sp_dims={"max_seq": SP_DIMS["max_seq"]},
        traces=list(TRACES), knobs={k: v[1] for k, v in TRACES.items()},
        seqpar=SEQPAR, refusals=REFUSALS, programs=PROGRAMS, T=PT, C=PC,
        leader_timeout=LEADER_TIMEOUT_S, xfer=list(XFER),
        xfer_params={k: v[0] for k, v in XFER.items()},
        xfer_dims={k: v[1] for k, v in XFER.items()},
        xfer_knobs={k: v[2] for k, v in XFER.items()},
        skip_source=SKIP_SOURCE, skip_knobs=SKIP_KNOBS)))
    deadline = time.monotonic() + TIMEOUT_S
    procs = _start_group(out_dir)
    try:
        ref = _jax_side(params, x, ops)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    outs = _wait_group(procs, deadline)
    res = GroupResults(out_dir, procs, outs)
    res.ref = ref
    return res


# -- the engine ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["prefix", "noprefix"])
def test_trace_matches_jax(group, name):
    """tests/test_sharded_decode.py's randomized trace (seed 3), prefix
    cache on and off: the port's tp=2 tokens are the JAX engine's tp=2
    and tp=1 tokens, every program keeps one signature, and with the
    cache on the trace hits it."""
    lead, follow = group.get(f"trace_{name}")
    outs = json.loads(str(lead["outs"]))
    ref = group.ref[name]
    assert ref[2] == ref[1]
    assert outs == ref[2]
    for r in (lead, follow):
        assert int(r["step_traces"]) == 1 and int(r["prefill_traces"]) == 1
        assert int(r["decode_step_retraces"]) == 0
    if name == "prefix":
        assert int(lead["prefix_hits"]) > 0


def test_monolithic_admission_matches_jax(group):
    """The paged monolithic admission (budget 0, bucket 8; seed 7) with
    ``flash_force``, the kernel path on the card, on each rank's 2
    heads: tokens equal to the JAX engine's at tp 2 and 1."""
    lead, _ = group.get("trace_mono")
    assert json.loads(str(lead["outs"])) == group.ref["mono"][2] \
        == group.ref["mono"][1]
    assert int(lead["decode_step_retraces"]) == 0


def test_spec_decode_matches_jax(group):
    """spec_k 3 over the group: tokens equal to the JAX spec engines' at
    tp 2 and 1 and to the plain tp=1 engine's; the verify program keeps
    one signature and drafts are accepted."""
    lead, follow = group.get("trace_spec")
    ref = group.ref["spec"]
    assert json.loads(str(lead["outs"])) == ref[2] == ref[1] == ref["plain"]
    for r in (lead, follow):
        assert int(r["verify_traces"]) == 1
    assert int(lead["spec_accepted"]) > 0


def test_int8_kv_and_pins_match_jax(group):
    """int8 KV with int8 pins over the group: a block's scale is the amax
    over its whole D, reduced over the ranks, so the tokens are the JAX
    tp=2 engine's."""
    lead, _ = group.get("trace_int8")
    assert json.loads(str(lead["outs"])) == group.ref["int8"][2]


def test_stats_and_recorder(group):
    """Each rank holds half the pools, one pin (the follower's from the
    leader), no step retrace; the leader's recorder names the mesh."""
    from multiverso_tpu_torch.serving.block_pool import kv_bytes_per_block

    lead, follow = group.get("trace_prefix")
    total = (int(lead["kv_pool_blocks"]) + 1) * kv_bytes_per_block(
        DIMS["n_layers"], DIMS["d_model"], 4)
    for r in (lead, follow):
        assert int(r["kv_bytes_per_device"]) == total // 2
        assert int(r["pin_copies"]) == 1
        assert int(r["decode_step_retraces"]) == 0
        assert int(r["decode_tp"]) == 2 and int(r["mesh_devices"]) == 2
    assert list(lead["recorder"]) == [2, 2]
    calls = json.loads(str(follow["calls"]))
    assert calls["step"][0] > 0 and calls["chunk"][0] > 0


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_validation_refuses(group, name):
    """Refused with FatalError on every rank, before the group's mesh is
    made: 3 not dividing n_heads, contiguous strips, decode_tp above the
    group's 2 processes, prefill_sp with int8 KV, an unknown backend, a
    negative threshold, a ring whose T (23) does not divide over tp."""
    word = REFUSALS[name][1]
    for r in group.get(f"refuse_{name}"):
        assert word in str(r["refused"]), str(r["refused"])


# -- disaggregated serving into and out of the group ---------------------------

def _close_payloads(got, want, quant):
    """Two payloads of one prompt: the same header and chain, the same
    shipped hashes; f32 blocks within TOL, int8 bytes within Q8_TOL and
    their scales within TOL."""
    got, want = (json.loads(str(x)) if isinstance(x, (str, np.ndarray))
                 else x for x in (got, want))
    for key in ("prompt_len", "block_size", "snapshot_version", "shape",
                "dtype", "hashes", "dedup_blocks"):
        assert got[key] == want[key], key
    assert set(got["blocks"]) == set(want["blocks"])
    a, b = _blocks(got), _blocks(want)
    assert set(a) == set(b)
    for key in a:
        if quant and key in ("k", "v"):
            diff = np.abs(a[key].astype(np.int32) - b[key].astype(np.int32))
            assert diff.max() <= Q8_TOL, (key, diff.max())
        else:
            np.testing.assert_allclose(a[key], b[key], err_msg=key, **TOL)


def test_disagg_tp1_into_tp2_matches_jax(group):
    """tests/test_kv_transfer.py:290's traffic: a tp=1 engine's payload
    spliced into the decode_tp=2 engine ships 3 blocks, saves the
    prompt's 6 tokens, retraces no step, and its 5 tokens equal the tp=2
    unified engine's and the JAX engines' at tp 2 and 1."""
    lead, _ = group.get("xfer_f32")
    ref = group.ref["xfer_f32"]
    info = json.loads(str(lead["info12_0"]))
    assert info["xfer_blocks"] == 3 and "skipped" not in info, info
    out = lead["out12_0"].tolist()
    assert len(out) == 5
    assert out == lead["uni2_0"].tolist() == ref["out12_0"] \
        == ref["out11_0"]
    assert int(lead["prefill_tokens_saved_dec"]) >= 6
    assert int(lead["decode_step_retraces_dec"]) == 0


@pytest.mark.parametrize("name", sorted(XFER))
def test_tp2_export_is_the_tp1_payload(group, name):
    """The decode_tp=2 engine's export of each prompt is the tp=1
    engine's payload (the ranks' D slices gathered into logical blocks;
    f32 within TOL, int8 bytes within Q8_TOL and scales within TOL), and
    JAX's tp=2 export of it; spliced into a tp=1 engine it decodes JAX's
    tokens for that direction."""
    lead, follow = group.get(f"xfer_{name}")
    ref = group.ref[f"xfer_{name}"]
    quant = name == "int8"
    for i in range(len(_xfer_reqs(name))):
        _close_payloads(lead[f"pay2_{i}"], lead[f"pay1_{i}"], quant)
        _close_payloads(lead[f"pay2_{i}"], ref[f"pay2_{i}"], quant)
        info = json.loads(str(lead[f"info21_{i}"]))
        assert info["xfer_blocks"] > 0 and "skipped" not in info, info
        assert lead[f"out21_{i}"].tolist() == ref[f"out21_{i}"]
    # one export command a prompt, plus the partly advertised one
    calls = json.loads(str(follow["calls_pf"]))
    assert calls["export"][0] == len(_xfer_reqs(name)) + 1, calls


def test_int8_tp1_into_tp2_matches_jax(group):
    """int8 KV and pins: tp=1 payloads (blocks with their scales) spliced
    into the decode_tp=2 engine decode JAX's tp1-into-tp2 tokens, and the
    spliced scales reach both ranks (the follower runs one splice command
    a prompt)."""
    lead, follow = group.get("xfer_int8")
    ref = group.ref["xfer_int8"]
    n = len(_xfer_reqs("int8"))
    for i in range(n):
        info = json.loads(str(lead[f"info12_{i}"]))
        assert info["xfer_blocks"] > 0 and "skipped" not in info, info
        assert lead[f"out12_{i}"].tolist() == ref[f"out12_{i}"]
    calls = json.loads(str(follow["calls_dec"]))
    assert calls["splice"][0] == n, calls


def test_source_dedup_on_the_group(group):
    """known_hashes on the decode_tp=2 engine: an advertised block rides
    as its hash alone (the rest equal to the tp=1 engine's payload with
    the same advertisement), and a fully advertised prompt ships nothing
    and issues no export command."""
    lead, follow = group.get("xfer_f32")
    _close_payloads(lead["known2"], lead["known1"], False)
    known = json.loads(str(lead["known2"]))
    assert known["dedup_blocks"] == 1 and len(known["blocks"]) == 2
    every = json.loads(str(lead["all2"]))
    assert every["dedup_blocks"] == 3 and every["blocks"] == {}
    assert len(every["hashes"]) == 3
    calls = json.loads(str(follow["calls_pf"]))
    assert calls["export"][0] == 2, calls


def test_splice_skips_leave_the_ranks_alike(group):
    """Another snapshot version and another block size skip whole, a
    dropped payload splices nothing, and a 7-block payload into a pool
    of 6 splices 6 (in two commands: a command holds 5): the same answers
    as a tp=1 engine's, and afterwards the ranks' pools, joined along D,
    equal the tp=1 engine's pools."""
    lead, follow = group.get("skips")
    for i in range(4):
        two = json.loads(str(lead[f"info2_{i}"]))
        assert two == json.loads(str(lead[f"info1_{i}"]))
    assert "snapshot version" in json.loads(str(lead["info2_0"]))["skipped"]
    assert "block size" in json.loads(str(lead["info2_1"]))["skipped"]
    assert json.loads(str(lead["info2_2"]))["xfer_blocks"] == 0
    assert json.loads(str(lead["info2_3"]))["xfer_blocks"] == 6
    calls = json.loads(str(follow["calls"]))
    assert calls["splice"][0] == 2 and "export" not in calls, calls
    for pool in ("k", "v"):
        joined = np.concatenate([lead[pool], follow[pool]], axis=-1)
        np.testing.assert_array_equal(joined, lead[f"{pool}1"])
        assert np.count_nonzero(np.abs(joined).sum(axis=(0, 2, 3))) == 6


def test_follower_raises_when_its_leader_goes_silent(group):
    """A leader that stops pinging: its follower raises FatalError
    within the group's timeout (never hangs, never serves alone)."""
    _, follow = group.get("silent")
    assert "lost its leader" in str(follow["raised"])
    assert float(follow["after_s"]) < 4 * LEADER_TIMEOUT_S


# -- sequence-parallel prefill ------------------------------------------------

@pytest.mark.parametrize("backend,tp", SEQPAR)
def test_seqpar_matches_single_lane(group, backend, tp):
    """tests/test_seqpar_prefill.py's mixed trace (seed 5, threshold 8):
    the prefill_sp engine's tokens equal the single-lane engine's at the
    same tp, the seqpar chunk program keeps one signature and runs, its
    chunk is budget * tp."""
    lead, _ = group.get(f"seqpar_{backend}{tp}")
    assert json.loads(str(lead["outs1"])) == json.loads(str(lead["outs0"]))
    assert int(lead["seqpar_traces1"]) == 1
    assert int(lead["seqpar_chunks1"]) > 0
    assert int(lead["prefill_sp_chunk1"]) == 4 * tp
    assert int(lead["step_traces1"]) == 1
    assert int(lead["decode_step_retraces1"]) == 0
    assert "seqpar_traces0" not in lead


@pytest.mark.parametrize("backend", ["ring", "ulysses"])
def test_prefill_attention_matches_jax(group, backend):
    """ring_prefill_attention / ulysses_prefill_attention over the group
    (rows split; K/V by sequence for the ring, by heads for Ulysses)
    against JAX's on a 2-device mesh, and against the port's single-lane
    chunk attention, within TOL."""
    parts = group.get(f"op_{backend}")
    got = np.concatenate([p["out"] for p in parts])
    np.testing.assert_allclose(got, group.ref[f"op_{backend}"], **TOL)
    lane = group.get("op_lane")[0]["out"]
    np.testing.assert_allclose(got, lane, **TOL)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_sharded_program_matches_jax(group, name):
    """Each sharded program on the same inputs: its outputs, and the
    pools gathered back by their D slices, against JAX's
    make_sharded_decode_programs on a 2-device mesh (floats within TOL,
    tokens exactly, int8 bytes within Q8_TOL)."""
    parts = group.get(f"program_{name}")
    ref = group.ref["programs"][name]
    for key, want in ref.items():
        if key.startswith("pool") and want.ndim == 4:
            got = np.concatenate([p[key] for p in parts], axis=-1)
        else:
            got = parts[0][key]
            np.testing.assert_array_equal(got, parts[1][key])
        if want.dtype == np.int8:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= Q8_TOL, (key, diff.max())
        elif np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, err_msg=key, **TOL)
