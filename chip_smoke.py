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
   (key length <= 1024 and > 1024);
4. the word2vec kernels against their plain versions on the card, at the
   slice's shapes (65,536 and 5,120 zipf ids into a [71291, 200] table,
   bf16 and f32), the Pallas probe's shape (V 71296, D 256, N 204800, f32)
   and K1b's (8 ids into [64, 256] f32), plus wrapped and out-of-range
   ids. The row gather must be bitwise equal. The row scatter-add is held
   twice: (a) exact data (table and deltas on a 2^-16 grid, each element
   of a row taking at most 100 nonzero +-2^-16 adds, every update nonzero
   somewhere), where every summation order gives the same bits, so the
   kernel must be bitwise equal even on the zipf head rows and a lost or
   dropped add shows; (b) data at the path's scale (a table like the
   random init, +-0.5/D, and N(0, 1e-4) deltas, each add large enough to
   move a bf16 value), bitwise on rows hit once and, on rows hit h > 1
   times, each element within h x ulp(A') in bf16 or 1e-5 x A in f32, A
   = |x0| + the sum of |delta| the largest magnitude its exact running
   sum can reach and A' = A + h x ulp(A) (the rounding it can gather); a
   scatter that leaves the table unchanged must fail both.
   Each case prints its time, the plain version's, the PyTorch call's
   (index_select / index_add_, a yardstick the port never calls) and the
   least time the card could take (bytes over 3.35 TB/s);
5. one full-width word2vec step of the bench configuration on the card
   and on CPU copies of the same tables with the same draws, held on the
   CHANGE of each table (after - before): each element within h x
   ulp(A') (the two summation orders, A' as in phase 4) + 1e-4 x the sum
   over the row's updates of each one's largest |delta| (the card's and
   the CPU's f32 arithmetic round a delta's terms in another order), plus
   in bf16 2^-7 x sum |delta| (a delta may round to the other bf16
   neighbour), with h and the sums recorded from the CPU step's scatters;
   a card step that changed nothing must fail it;
6. the slice: the bench configuration (multiverso_tpu_torch/bench.py:
   text8 shape, 4M-word zipf corpus, bf16 tables, batch 65,536, G = 64,
   static capped row-mean) trained through the port's entry points, one
   warm call and 20 timed calls of 25 steps; the loss must be finite and
   fall, and both kernels must have been launched by the run; one more
   call runs with torch.cuda.set_sync_debug_mode("error") (no host sync
   inside a call); then a torch.profiler top-10 of one call by device
   time.

The line before the last is a JSON object with one entry per kernel
regime; the last line is {"ok": true, "device": {...}}. Any failure exits
nonzero before either line is printed. Without a CUDA device, or without
the package beside this file, the script fails. To debug one phase, call
it directly, e.g. ``python3 -c "import chip_smoke as c;
c.phase_device(); c.phase_w2v_kernels()"``.
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
# word2vec: the bench configuration (bench.py:148-154), text8 shape
W2V_VOCAB, W2V_DIM, W2V_BATCH, W2V_G = 71291, 200, 65536, 64
W2V_WORDS, W2V_STEPS, W2V_ITERS = 4_000_000, 25, 20
W2V_PATH = f"path n={W2V_BATCH} bfloat16"
W2V_SRC = {"row_gather": "multiverso_tpu_torch/csrc/row_gather.cu",
           "row_scatter_add": "multiverso_tpu_torch/csrc/row_scatter_add.cu"}
PROBE = "tools/w2v_kernel_probe.py"
DEV = torch.device("cuda")


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


def zipf_ids(rng, vocab: int, n: int) -> np.ndarray:
    """zipf(1.0) ids over ``vocab`` words, the corpus law (and the kernel
    probe's, tools/w2v_kernel_probe.py:69-82)."""
    p = 1.0 / np.arange(1, vocab + 1)
    return rng.choice(vocab, size=n, p=p / p.sum()).astype(np.int32)


def ulp(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Elementwise: the spacing of ``dtype`` at |x|."""
    mag = x.float().abs().clamp(min=torch.finfo(torch.float32).tiny)
    mant = 7 if dtype == torch.bfloat16 else 23
    return torch.exp2(torch.floor(torch.log2(mag)) - mant)


def in_range(ids: torch.Tensor, rows: int) -> bool:
    return bool(((ids >= 0) & (ids < rows)).all())


def fmt(ms) -> str:
    return "null" if ms is None else f"{ms:.4f}"


def _emb():
    return importlib.import_module("multiverso_tpu_torch.ops.embedding")


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def scatter_stats(table: torch.Tensor, ids: torch.Tensor,
                  deltas: torch.Tensor):
    """What a scatter-add of ``deltas`` at ``ids`` into ``table`` does to
    each row: its hits ``[V]``; per element, the sum of |delta| after the
    rounding to the table dtype ``[V, D]``; and per row the sum over its
    updates of each update's largest |delta| ``[V]``."""
    V = table.shape[0]
    D = table.numel() // V
    w, ok = _emb()._wrapped(ids, V)
    d = deltas.reshape(w.shape[0], D).to(table.dtype).float().abs()
    hits = torch.zeros(V, device=table.device)
    hits.index_add_(0, w[ok], torch.ones(int(ok.sum()), device=table.device))
    absum = torch.zeros((V, D), device=table.device)
    absum.index_add_(0, w[ok], d[ok])
    rowscale = torch.zeros(V, device=table.device)
    rowscale.index_add_(0, w[ok], d[ok].amax(dim=1))
    return hits, absum, rowscale


def sum_ulp(before, hits, absum, dtype) -> torch.Tensor:
    """Per element, h x ulp(A'): one summation order of h adds is within
    h x 1/2 ulp of the exact sum when no running sum exceeds A' in
    magnitude, so two orders are within h x ulp(A'). A = |x0| + sum
    |delta| bounds the exact running sums; A' = A + h x ulp(A) adds the
    rounding they can gather (a sum just under a power of two may round
    over it, where the ulp doubles)."""
    V = before.shape[0]
    A = before.float().abs().reshape(V, -1) + absum
    h = hits[:, None]
    return h * ulp(A + h * ulp(A, dtype), dtype)


def excess(diff: torch.Tensor, tol: torch.Tensor) -> float:
    """max of diff / tol; where tol is 0 any difference is infinite."""
    over = torch.where(tol > 0, diff / tol.clamp(min=1e-38),
                       torch.where(diff > 0, float("inf"), 0.0))
    return over.max().item()


def scatter_tolerance(before, hits, absum, dtype) -> torch.Tensor:
    """Kernel vs plain scatter-add, per element: 0 on a row hit at most
    once (one add, one rounding: bitwise); on a row hit h > 1 times, bf16
    within h x ulp(A') (:func:`sum_ulp`) and f32 within 1e-5 x A, A =
    |x0| + sum |delta| the largest magnitude the exact sum can reach."""
    V = before.shape[0]
    if dtype == torch.bfloat16:
        tol = sum_ulp(before, hits, absum, dtype)
    else:
        tol = 1e-5 * (before.float().abs().reshape(V, -1) + absum)
    return torch.where(hits[:, None] > 1, tol, torch.zeros_like(tol))


def exact_case(V: int, D: int, ids: torch.Tensor, dtype, delta_dtype,
               seed: int):
    """A table and deltas on the 2^-16 grid whose every running sum is
    exact in bf16 and f32, in any order: x0 in [-128, 128] units, and each
    element of a row takes at most 100 nonzero +-1-unit adds (update k of
    a row with h hits is nonzero at elements e with (k + e) % ceil(h/100)
    == 0), so |sum| <= 228 units < 2^8. Every update is nonzero at some
    element while ceil(h/100) <= D."""
    dev = ids.device
    unit = 2.0 ** -16
    g = torch.Generator(device=dev).manual_seed(seed)
    w, ok = _emb()._wrapped(ids, V)
    key = torch.where(ok, w, torch.full_like(w, V))   # dropped ids last
    n = key.numel()
    order = torch.argsort(key, stable=True)
    sk = key[order]
    rank = torch.empty_like(key)
    rank[order] = torch.arange(n, device=dev) - torch.searchsorted(sk, sk)
    hits = torch.bincount(key, minlength=V + 1)[key]
    stride = torch.clamp((hits + 99) // 100, min=1)
    if int(stride.max()) > D:
        fail(f"exact scatter case: {int(hits.max())} hits on a row of {D}")
    e = torch.arange(D, device=dev)
    nz = (rank[:, None] + e[None, :]) % stride[:, None] == 0
    sign = torch.randint(0, 2, (n, D), generator=g, device=dev) * 2 - 1
    deltas = (nz * sign).float().mul_(unit).to(delta_dtype)
    x0 = torch.randint(-128, 129, (V, D), generator=g, device=dev).float()
    return x0.mul_(unit).to(dtype), deltas


def phase_w2v_kernels():
    """Row gather and row scatter-add against their plain versions on the
    card (module docstring, phase 4)."""
    emb = _emb()
    dev = DEV
    rng = np.random.default_rng(7)
    results = {}

    def gather_case(tag, V, D, dtype, ids_np):
        table = torch.from_numpy(
            rng.standard_normal((V, D)).astype(np.float32)).to(dev, dtype)
        ids = torch.from_numpy(ids_np).to(dev)
        out = emb._gather_cuda(table, ids)
        torch.cuda.synchronize()
        ref = emb._gather_plain(table, ids)
        if not torch.equal(bits(out), bits(ref)):
            fail(f"row_gather {tag}: differs from the plain version")
        uniq = int(torch.unique(ids).numel())
        row = D * table.element_size()
        nbytes = uniq * row + ids.numel() * (row + 4)
        ms = time_ms(lambda: emb._gather_cuda(table, ids), iters=20)
        plain_ms = time_ms(lambda: emb._gather_plain(table, ids), iters=20)
        # the library call has no wrap/NaN rule (a bad id is a device
        # assert): timed on in-range ids only
        lib_ms = (time_ms(lambda: torch.index_select(table, 0, ids),
                          iters=20) if in_range(ids, V) else None)
        r = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                 bound_ms=nbytes / HBM_BYTES_S * 1e3, bound_by="bytes",
                 library_ms=lib_ms)
        say(f"kernel row_gather {tag}: bitwise equal, unique rows {uniq}, "
            f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {fmt(lib_ms)} "
            f"bound_ms {r['bound_ms']:.4f} (bytes)")
        results[("gather", tag)] = r

    def scatter_exact(tag, V, D, dtype, ids_np, delta_dtype=torch.float32):
        ids = torch.from_numpy(ids_np).to(dev)
        table, deltas = exact_case(V, D, ids, dtype, delta_dtype, seed=11)
        got = emb._scatter_add_cuda(table.clone(), ids, deltas)
        torch.cuda.synchronize()
        want = emb._scatter_add_plain(table.clone(), ids, deltas)
        if not torch.equal(bits(got), bits(want)):
            n_bad = int((bits(got) != bits(want)).sum())
            fail(f"row_scatter_add exact {tag}: {n_bad} elements differ "
                 f"from the plain version")
        if torch.equal(bits(table), bits(want)):
            fail(f"row_scatter_add exact {tag}: negative control: the "
                 f"plain version left the table unchanged")
        w, ok = emb._wrapped(ids, V)
        hits = torch.bincount(w[ok], minlength=V)
        say(f"kernel row_scatter_add exact {tag}: bitwise equal, max hits "
            f"{int(hits.max())}")

    def scatter_real(tag, V, D, dtype, ids_np, delta_dtype=torch.float32,
                     timed=True):
        table = torch.from_numpy(((rng.random((V, D)) - 0.5) / D)
                                 .astype(np.float32)).to(dev, dtype)
        deltas = torch.from_numpy(
            (rng.standard_normal((ids_np.shape[0], D)) * 1e-4)
            .astype(np.float32)).to(dev, delta_dtype)
        ids = torch.from_numpy(ids_np).to(dev)
        got = emb._scatter_add_cuda(table.clone(), ids, deltas)
        torch.cuda.synchronize()
        want = emb._scatter_add_plain(table.clone(), ids, deltas)
        hits, absum, _ = scatter_stats(table, ids, deltas)
        tol = scatter_tolerance(table, hits, absum, dtype)
        flat = (V, D)
        diff = (got.float() - want.float()).abs().reshape(flat)
        ex = excess(diff, tol)
        control = excess((table.float() - want.float()).abs().reshape(flat),
                         tol)
        err = diff.max().item()
        if not (np.isfinite(err) and ex <= 1.0):
            fail(f"row_scatter_add {tag}: max_abs_err {err}, {ex:.3f} x the "
                 f"tolerance")
        if not control > 1.0:
            fail(f"row_scatter_add {tag}: negative control: an unchanged "
                 f"table is within the tolerance ({control:.3f})")
        uniq = int((hits > 0).sum())
        line = (f"kernel row_scatter_add {tag}: max_abs_err {err:.3e} "
                f"({ex:.3f} of the tolerance; unchanged table "
                f"{control:.3g}), max hits {int(hits.max())}, unique rows "
                f"{uniq}")
        if timed:
            row = D * table.element_size()
            nbytes = 2 * uniq * row + ids.numel() * (
                D * deltas.element_size() + 4)
            work = table.clone()
            ms = time_ms(lambda: emb._scatter_add_cuda(work, ids, deltas),
                         iters=20)
            plain_ms = time_ms(
                lambda: emb._scatter_add_plain(work, ids, deltas), iters=20)
            cast = deltas.to(dtype)
            lib_ms = (time_ms(lambda: work.index_add_(0, ids, cast),
                              iters=20) if in_range(ids, V) else None)
            r = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=nbytes / HBM_BYTES_S * 1e3, bound_by="bytes",
                     library_ms=lib_ms)
            results[("scatter", tag)] = r
            line += (f", ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
                     f"{fmt(lib_ms)} bound_ms {r['bound_ms']:.4f} (bytes)")
        say(line)

    V, D = W2V_VOCAB, W2V_DIM
    # centers/targets, and the B/G x K negatives
    for n in (W2V_BATCH, W2V_BATCH // W2V_G * 5):
        ids = zipf_ids(rng, V, n)
        for dt in (torch.bfloat16, torch.float32):
            name = f"path n={n} {str(dt).split('.')[-1]}"
            gather_case(name, V, D, dt, ids)
            scatter_real(name, V, D, dt, ids)
            scatter_exact(name, V, D, dt, ids)
    # duplicate-free: every row hit once, so the tolerance is 0 (bitwise)
    for dt in (torch.bfloat16, torch.float32):
        uniq_ids = rng.permutation(V)[:5120].astype(np.int32)
        scatter_real(f"unique n=5120 {str(dt).split('.')[-1]}", V, D, dt,
                     uniq_ids, timed=False)
    # bf16 deltas into a bf16 table, ids with wrap and drop
    odd = zipf_ids(rng, V, 4096)
    odd[:64] = -1 - odd[:64]           # negative: wraps
    odd[64:96] = V + 5                 # out of range: dropped / NaN row
    gather_case("wrap+oob n=4096 bfloat16", V, D, torch.bfloat16, odd)
    scatter_real("wrap+drop n=4096 bf16 deltas", V, D, torch.bfloat16, odd,
                 delta_dtype=torch.bfloat16, timed=False)
    scatter_exact("wrap+drop n=4096 bf16 deltas", V, D, torch.bfloat16, odd,
                  delta_dtype=torch.bfloat16)
    # the probe's shape (w2v_kernel_probe.py:61-82) and K1b's (:231-252)
    probe_ids = zipf_ids(np.random.default_rng(7), 71296, 204800)
    probe = "probe V=71296 D=256 N=204800 float32"
    gather_case(probe, 71296, 256, torch.float32, probe_ids)
    scatter_real(probe, 71296, 256, torch.float32, probe_ids)
    scatter_exact(probe, 71296, 256, torch.float32, probe_ids)
    gather_case("k1b V=64 D=256 N=8 float32", 64, 256, torch.float32,
                rng.integers(0, 64, 8).astype(np.int32))
    torch.cuda.empty_cache()
    return results


def _bench_corpus_model(dtype):
    from multiverso_tpu_torch import bench

    return bench.build_model(W2V_WORDS, W2V_VOCAB, W2V_DIM, W2V_BATCH,
                             W2V_G, dtype)


def phase_w2v_step():
    """One full-width step of the bench configuration on the card (the
    kernels) and on CPU copies of the same tables (the plain versions),
    with the same draws, held on the change of each table (module
    docstring, phase 5)."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models.word2vec import Word2Vec, tables_from_jax

    emb = _emb()
    V, D = W2V_VOCAB, W2V_DIM
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        model, _ = _bench_corpus_model(dtype)
        cfg = model.config
        # an output table like the random init (+-0.5/D), so the first
        # step moves the input table
        model.output_table.set_array(torch.from_numpy(
            ((np.random.default_rng(3).random((V, D)) - 0.5) / D)
            .astype(np.float32)))
        w_in0, w_out0 = model.input_table.get(), model.output_table.get()
        c_in, c_out = tables_from_jax(w_in0, w_out0, device="cpu",
                                      dtype=dtype)
        cpu = Word2Vec(cfg, c_in, c_out, counts=model._host_counts)
        cpu.total_words = model.total_words
        ext = [b.cpu() for b in model._ext_bufs]
        cpu._ext_bufs, cpu._corpus_len = tuple(ext), model._corpus_len
        cpu._static_scale_in = model._static_scale_in.cpu()
        cpu._static_scale_out = model._static_scale_out.cpu()
        draws = model.draw(1)
        t0 = time.perf_counter()
        loss, count = model.train_device_steps(1, draws=draws)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        # the CPU step, recording each table's hits and sum of |delta|
        stats = {c_in._data.data_ptr(): None, c_out._data.data_ptr(): None}
        plain = emb._scatter_add_plain

        def recording(table, ids, deltas):
            got = scatter_stats(table, ids, deltas)
            seen = stats[table.data_ptr()]
            stats[table.data_ptr()] = got if seen is None else tuple(
                a + b for a, b in zip(seen, got))
            return plain(table, ids, deltas)

        emb._scatter_add_plain = recording
        try:
            t0 = time.perf_counter()
            closs, ccount = cpu.train_device_steps(
                1, draws={k: v.cpu() for k, v in draws.items()})
            cpu_s = time.perf_counter() - t0
        finally:
            emb._scatter_add_plain = plain
        tag = str(dtype).split(".")[-1]
        flip = 0.0 if dtype == torch.float32 else 2.0 ** -7
        worst, controls = {}, {}
        for name, card_t, cpu_t, before in (
                ("w_in", model.input_table, c_in, w_in0),
                ("w_out", model.output_table, c_out, w_out0)):
            hits, absum, rowscale = stats[cpu_t._data.data_ptr()]
            b = torch.from_numpy(before)
            d_card = torch.from_numpy(card_t.get()) - b
            d_cpu = torch.from_numpy(cpu_t.get()) - b
            tol = (sum_ulp(b, hits, absum, dtype) + flip * absum
                   + 1e-4 * rowscale[:, None])
            diff = (d_card - d_cpu).abs()
            worst[name] = excess(diff, tol)
            controls[name] = excess(d_cpu.abs(), tol)
            if not (worst[name] <= 1.0 and torch.isfinite(d_card).all()):
                i = int(torch.argmax(torch.where(
                    tol > 0, diff / tol.clamp(min=1e-38),
                    diff * float("inf"))))
                v, e = divmod(i, D)
                fail(f"w2v step card vs cpu {tag} {name}: change "
                     f"{worst[name]} x the tolerance; worst at row {v} col "
                     f"{e}: before {b[v, e].item():.6e} change card "
                     f"{d_card[v, e].item():.6e} cpu {d_cpu[v, e].item():.6e}"
                     f" hits {hits[v].item():.0f} sum|delta| "
                     f"{absum[v, e].item():.6e} row scale "
                     f"{rowscale[v].item():.6e} tol {tol[v, e].item():.6e}")
            if not controls[name] > 1.0:
                fail(f"w2v step card vs cpu {tag} {name}: negative control:"
                     f" no change is within the tolerance "
                     f"({controls[name]:.3f})")
        lerr = abs(float(loss) - float(closs))
        if float(count) != float(ccount) or lerr > 1e-4:
            fail(f"w2v step card vs cpu {tag}: count {float(count)} vs "
                 f"{float(ccount)}, loss {float(loss)} vs {float(closs)}")
        say(f"w2v step card vs cpu {tag}: pairs {float(count):.0f}, loss "
            f"{float(loss):.6f} vs {float(closs):.6f}; change of the table, "
            f"share of the tolerance: w_in {worst['w_in']:.3e} w_out "
            f"{worst['w_out']:.3e} (no change: {controls['w_in']:.3g} / "
            f"{controls['w_out']:.3g}); host clock card {card_s:.3f} s "
            f"(first step, cold), cpu {cpu_s:.3f} s")
        out[tag] = worst
        del model, cpu
        mv.session().tables.clear()
        torch.cuda.empty_cache()
    return out


def phase_w2v_slice(card: str):
    """bench.py's configuration end to end through the port's entry points
    on the card, with the kernels' launch counts read around the run."""
    from multiverso_tpu_torch import bench

    emb = _emb()
    torch.cuda.synchronize()
    emb.reset_launches()
    t0 = time.perf_counter()
    model, dictionary = _bench_corpus_model(torch.bfloat16)
    setup_s = time.perf_counter() - t0
    res = bench.timed_window(model, W2V_STEPS, W2V_ITERS)
    torch.cuda.synchronize()
    launches = dict(emb.LAUNCHES)
    losses = [res["warm_loss"]] + res["losses"]
    say(f"w2v slice: vocab {dictionary.vocab_size}, {W2V_ITERS} x "
        f"{W2V_STEPS}-step calls after one warm call: "
        f"{res['pairs']:.0f} pairs in {res['elapsed_s']:.3f} s = "
        f"{res['pairs_per_sec']:.1f} pairs/s, {res['dispatch_ms']:.3f} ms "
        f"per call; setup {setup_s:.1f} s; loss first call "
        f"{losses[0]:.5f} -> last {losses[-1]:.5f}; launches "
        f"{json.dumps(launches)}; card {card}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"w2v loss not finite and falling: {losses}")
    if res["pairs"] <= 0:
        fail("w2v slice trained no pairs")
    if launches["row_gather"] <= 0 or launches["row_scatter_add"] <= 0:
        fail(f"w2v slice did not run both kernels: {launches}")
    # no host sync inside a call: any synchronizing CUDA call raises
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.train_device_steps(W2V_STEPS)
    except RuntimeError as exc:
        fail(f"w2v train_device_steps synchronized with the host: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    say(f"w2v sync check: one {W2V_STEPS}-step call ran with "
        f"set_sync_debug_mode('error'), no host sync")
    # where one call's device time goes
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss, _ = model.train_device_steps(W2V_STEPS)
        float(loss)
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(avg[0], "self_device_time_total")
           else "self_cuda_time_total")
    # device busy time: the device-side events (kernels, copies) only; the
    # ops that launch them carry the same time again
    busy_us = sum(getattr(e, key) for e in avg
                  if str(getattr(e, "device_type", "")).endswith("CUDA"))
    table = avg.table(sort_by=key, row_limit=10)
    say(f"w2v profile of one {W2V_STEPS}-step call: wall {wall * 1e3:.3f} "
        f"ms (profiler on), device busy {busy_us / 1e3:.3f} ms "
        f"({busy_us / 1e3 / (wall * 1e3):.3f} of wall); top 10 by device "
        f"time:\n{table}")
    return {"launches": launches, "pairs_per_sec": res["pairs_per_sec"]}


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_device()
    kernels_line = lm_phases(card)
    wk = phase_w2v_kernels()
    import multiverso_tpu_torch as mv

    mv.init(["chip_smoke", "-device=cuda"])
    phase_w2v_step()
    w2v = phase_w2v_slice(card)
    mv.shutdown()
    n_g = w2v["launches"]["row_gather"]
    n_s = w2v["launches"]["row_scatter_add"]
    for name, r, line, n in (
            ("row_gather", wk[("gather", W2V_PATH)], 95, n_g),
            ("row_gather[k1b]",
             wk[("gather", "k1b V=64 D=256 N=8 float32")], 231, n_g),
            ("row_scatter_add", wk[("scatter", W2V_PATH)], 157, n_s)):
        entry = {"name": name, "route": "cuda",
                 "source": W2V_SRC[name.split("[")[0]],
                 "replaces": f"{PROBE}:{line}", "launches": n, **r}
        if name == "row_gather[k1b]":
            # K1b is K1's function at an 8-row shape that the path never
            # gives it: its launches are the row_gather kernel's, all at
            # the path's shapes
            entry["launches_of"] = "row_gather"
        kernels_line.append(entry)
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def lm_phases(card: str):
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
    return kernels_line


if __name__ == "__main__":
    main()
