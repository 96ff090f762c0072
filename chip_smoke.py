"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line:

1. device: the card's name and power limit (nvidia-smi), then the build of
   every CUDA kernel library of the port from the sources in this checkout
   (one nvcc per source, all started together), with its seconds;
2. kernels against their plain versions on the card, at the serving path's
   shapes, in bf16 (atol 2e-2) and f32 (atol 1e-4), causal and not, plus
   offset partial blocks; for each case the max error, the kernel's time,
   the plain version's time, torch's scaled_dot_product_attention time as
   a yardstick (the port never calls it) and the least time the card could
   take (max of FLOPs over 989 TFLOP/s and bytes over 3.35 TB/s);
3. the slice: the flagship LM (vocab 256, d_model 768, 12 layers, 12
   heads, d_ff 3072, max_seq 2048, bf16, random weights from seed 0)
   served by InferenceServer + DecodeEngine with monolithic contiguous
   admission and attention="flash_force"; 16 requests with prompt lengths
   across the buckets 128..1536. Every output must equal the port's
   greedy_decode on the same weights (prompt padded to the engine's
   bucket, the engine's slot count and cache length), and the flash
   kernel must have been launched by the serving run in both regimes
   (key length <= 1024 and > 1024).

The line before the last is a JSON object with one entry per kernel
regime; the last line is {"ok": true, "device": {...}}. Any failure exits
nonzero before either line is printed. Without a CUDA device, or without
the package beside this file, the script fails.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

TFLOPS_BF16 = 989e12      # H100 SXM dense bf16 tensor-core peak
TFLOPS_F32 = 67e12        # H100 SXM f32 peak outside the tensor cores
HBM_BYTES_S = 3.35e12     # H100 SXM HBM3 bandwidth
FLAGSHIP = dict(vocab_size=256, d_model=768, n_heads=12, n_layers=12,
                d_ff=3072, max_seq=2048)
BUCKETS = (128, 256, 512, 1024, 1536)
SLOTS, MAX_PROMPT, MAX_NEW = 8, 1536, 64
FA_SRC = "multiverso_tpu_torch/csrc/flash_fwd.cu"
FA_JAX = "multiverso_tpu/ops/flash_attention.py"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def live_pairs(sq: int, sk: int, causal: bool, q_base: int,
               k_base: int) -> int:
    """(query, key) pairs the mask leaves live: the work this data needs."""
    if not causal:
        return sq * sk
    rows = q_base + np.arange(sq) - k_base + 1
    return int(np.clip(rows, 0, sk).sum())


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    say(f"card: {card}")
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import kernels

    if not os.path.abspath(mv.__file__).startswith(HERE + os.sep):
        fail(f"multiverso_tpu_torch imported from {mv.__file__}, not from "
             f"this checkout")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    t0 = time.perf_counter()
    secs = kernels.build()
    say(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
        f"total {time.perf_counter() - t0:.2f} s")
    for name, log in kernels.BUILD_LOG.items():
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        say(f"ptxas {name}: " + " | ".join(regs[:8]))
    return card


def phase_kernels():
    import torch.nn.functional as F

    fa = importlib.import_module("multiverso_tpu_torch.ops.flash_attention")

    dev = torch.device("cuda")
    H, D = FLAGSHIP["n_heads"], FLAGSHIP["d_model"] // FLAGSHIP["n_heads"]
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for sk in (1024, 1536):
            for causal in (True, False):
                cases.append(dict(B=8, sq=sk, sk=sk, dtype=dtype,
                                  causal=causal, q_base=0, k_base=0,
                                  normalize=True))
    for sk in (1024, 1536):   # one admission's prefill: batch 1
        cases.append(dict(B=1, sq=sk, sk=sk, dtype=torch.bfloat16,
                          causal=True, q_base=0, k_base=0, normalize=True))
    # ring-step partials: a later q shard against an earlier k shard, and
    # an offset that leaves the first 512 rows fully masked
    cases.append(dict(B=8, sq=768, sk=768, dtype=torch.bfloat16, causal=True,
                      q_base=768, k_base=0, normalize=False))
    cases.append(dict(B=8, sq=768, sk=768, dtype=torch.float32, causal=True,
                      q_base=0, k_base=512, normalize=False))
    gen = torch.Generator(device="cpu").manual_seed(0)
    results = {}
    for c in cases:
        B, sq, sk, dt = c["B"], c["sq"], c["sk"], c["dtype"]
        q = torch.randn((B, sq, H, D), generator=gen).to(dev, dt)
        k = torch.randn((B, sk, H, D), generator=gen).to(dev, dt)
        v = torch.randn((B, sk, H, D), generator=gen).to(dev, dt)
        scale = 1.0 / D ** 0.5
        kw = dict(causal=c["causal"], scale=scale, normalize=c["normalize"])
        out, m, l = fa._fa_cuda(q, k, v, c["q_base"], c["k_base"], **kw)
        torch.cuda.synchronize()
        ref_out, ref_m, ref_l = fa._fa_plain(q, k, v, c["q_base"],
                                             c["k_base"], **kw)
        diff = (out.float() - ref_out.float()).abs()
        if not c["normalize"]:
            # an unnormalized accumulator grows with the row sum l: hold
            # its error relative to the row (the normalized output's error)
            diff = diff / ref_l.clamp(min=1.0).transpose(1, 2)[..., None]
        err = diff.max().item()
        m_err = (m - ref_m).abs().max().item()
        l_rel = ((l - ref_l).abs() / ref_l.abs().clamp(min=1.0)).max().item()
        atol = 2e-2 if dt == torch.bfloat16 else 1e-4
        tag = (f"B={B} sq={sq} sk={sk} {str(dt).split('.')[-1]} "
               f"causal={int(c['causal'])} offs=({c['q_base']},"
               f"{c['k_base']}) norm={int(c['normalize'])}")
        if not (np.isfinite(err) and err <= atol and m_err <= 1e-3
                and l_rel <= 1e-3):
            fail(f"flash kernel vs plain {tag}: max_abs_err {err} "
                 f"(atol {atol}), m err {m_err}, l rel err {l_rel}")
        ms = time_ms(lambda: fa._fa_cuda(q, k, v, c["q_base"], c["k_base"],
                                         **kw))
        plain_ms = time_ms(lambda: fa._fa_plain(q, k, v, c["q_base"],
                                                c["k_base"], **kw))
        lib_ms = None
        if c["normalize"]:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=c["causal"], scale=scale))
        item = q.element_size()
        pairs = live_pairs(sq, sk, c["causal"], c["q_base"], c["k_base"])
        flops = 4.0 * B * H * D * pairs
        out_bytes = B * sq * H * D * (item if c["normalize"] else 4)
        nbytes = (B * sq * H * D + 2 * B * sk * H * D) * item + out_bytes \
            + 2 * B * H * sq * 4
        peak = TFLOPS_BF16 if dt == torch.bfloat16 else TFLOPS_F32
        bound_ms = max(flops / peak, nbytes / HBM_BYTES_S) * 1e3
        bound_by = "operations" if flops / peak >= nbytes / HBM_BYTES_S \
            else "bytes"
        say(f"kernel flash_fwd {tag}: max_abs_err {err:.3e} m_err "
            f"{m_err:.3e} l_rel {l_rel:.3e} ms {ms:.4f} plain_ms "
            f"{plain_ms:.4f} library_ms "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} bound_ms "
            f"{bound_ms:.4f} ({bound_by})")
        results[(B, sk, str(dt), c["causal"], c["q_base"], c["k_base"])] = \
            dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=lib_ms)
        del q, k, v, out, m, l, ref_out, ref_m, ref_l
    torch.cuda.empty_cache()
    return results


def phase_slice(card: str):
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models import transformer as tf
    from multiverso_tpu_torch.serving import InferenceServer

    fa = importlib.import_module("multiverso_tpu_torch.ops.flash_attention")

    mv.init(["chip_smoke", "-device=cuda"])
    cfg = tf.TransformerConfig(**FLAGSHIP, dtype=torch.bfloat16,
                               attention="flash_force")
    lm = tf.TransformerLM(cfg)
    dev = lm.device
    rng = np.random.default_rng(1)
    lengths = []
    lo = 1
    for b, n in zip(BUCKETS, (3, 3, 3, 3, 4)):
        lengths += [int(x) for x in rng.integers(lo, b + 1, n)]
        lo = b + 1
    rng.shuffle(lengths)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lengths]

    # a short input against the plain reference attention: the flash path
    # and the reference path must give close logits
    probe = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, 128))).to(dev)
    params, _ = lm.snapshot_params()
    with torch.no_grad():
        lg_flash = tf.prefill(cfg, params, probe)[0]
        ref_cfg = tf.TransformerConfig(**FLAGSHIP, dtype=torch.bfloat16,
                                       attention="reference")
        lg_ref = tf.prefill(ref_cfg, params, probe)[0]
    probe_err = (lg_flash - lg_ref).abs().max().item()
    if not (lg_flash.shape == (1, 128, cfg.vocab_size)
            and torch.isfinite(lg_flash).all() and probe_err < 0.25):
        fail(f"flash_force prefill vs reference prefill: max |dlogit| "
             f"{probe_err} (limit 0.25) shape {tuple(lg_flash.shape)}")
    say(f"slice probe: prefill logits flash_force vs reference, 128 "
        f"tokens, max_abs_diff {probe_err:.4f} (limit 0.25)")

    srv = InferenceServer("chip_smoke")
    eng = srv.register_decoder(
        "lm", lm, slots=SLOTS, max_prompt=MAX_PROMPT, max_new=MAX_NEW,
        prompt_buckets=BUCKETS, prefill_token_budget=0, kv_block_size=0,
        decode_tp=1, prefix_cache=False, spec_k=0, kv_quant="none",
        decode_param_quant="none", prefill_sp=False, preempt=False,
        flight_recorder=False, watchdog=False, cost_ledger=False)
    # the served run: counts to 0 just before, read just after
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    futs = [srv.submit("lm", {"prompt": p, "max_new": MAX_NEW})
            for p in prompts]
    replies = [f.result(timeout=600) for f in futs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.LAUNCHES
    by_len = dict(fa.LAUNCHES_BY_KEY_LEN)
    stats = eng.stats()
    short = sum(n for sk, n in by_len.items() if sk <= 1024)
    long_ = sum(n for sk, n in by_len.items() if sk > 1024)
    say(f"slice served: {len(replies)} requests, {stats['tokens']} tokens "
        f"in {wall:.3f} s = {stats['tokens'] / wall:.1f} tok/s, TTFT p50 "
        f"{stats['ttft_p50_ms']:.2f} ms p99 {stats['ttft_p99_ms']:.2f} ms, "
        f"ITL p50 {stats['itl_p50_ms']:.2f} ms, prefill share "
        f"{stats['prefill_share']:.3f} (prefill {stats['prefill_s']:.3f} s, "
        f"decode {stats['decode_s']:.3f} s), peak live "
        f"{stats['peak_live_seqs']}, card {card}")
    say(f"slice flash launches: {launches} (key len <= 1024: {short}, "
        f"> 1024: {long_}; by key len {json.dumps(by_len, sort_keys=True)})")
    if len(replies) != len(prompts) or stats["completed"] != len(prompts):
        fail(f"served {stats['completed']} of {len(prompts)} requests")
    if short <= 0 or long_ <= 0:
        fail(f"flash kernel not launched in both regimes while serving: "
             f"{by_len}")

    mismatches = 0
    for p, rep in zip(prompts, replies):
        got = np.asarray(rep["result"])
        if got.shape != (MAX_NEW,) or got.min() < 0 \
                or got.max() >= cfg.vocab_size:
            fail(f"bad output shape/range {got.shape} for prompt {len(p)}")
        pb = next(b for b in BUCKETS if b >= len(p))
        toks = torch.zeros((1, pb), dtype=torch.int64, device=dev)
        toks[0, : len(p)] = torch.from_numpy(p).to(dev)
        with torch.no_grad():
            want = tf.greedy_decode(
                cfg, params, toks, torch.tensor([len(p)], device=dev),
                MAX_NEW, slots=SLOTS, cache_len=MAX_PROMPT + MAX_NEW)
        want = want[0].cpu().numpy()
        if not np.array_equal(got, want):
            mismatches += 1
            first = int(np.argmax(got != want))
            say(f"mismatch: prompt len {len(p)} first differing token "
                f"{first}: engine {got[first]} oracle {want[first]}")
    say(f"slice oracle: {len(prompts) - mismatches}/{len(prompts)} outputs "
        f"token-identical to greedy_decode")
    if mismatches:
        fail(f"{mismatches} outputs differ from greedy_decode")
    mv.shutdown()
    return {"short": short, "long": long_}


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_device()
    results = phase_kernels()
    counts = phase_slice(card)
    bf16 = str(torch.bfloat16)
    kernels_line = []
    for name, sk, regime, line in (
            ("flash_fwd[key_len<=1024]", 1024, "short", 165),
            ("flash_fwd[key_len>1024]", 1536, "long", 83)):
        r = results[(1, sk, bf16, True, 0, 0)]
        kernels_line.append({
            "name": name, "route": "cuda", "source": FA_SRC,
            "replaces": f"{FA_JAX}:{line}", "launches": counts[regime],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
