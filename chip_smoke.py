"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line:

1. device: the card's name and power limit (nvidia-smi), then the build of
   every CUDA kernel library of the port from the sources in this checkout
   (one nvcc per source, all started together), with its seconds, each
   kernel's ptxas report, and the reduction opcodes in the SASS of the
   scatter-add kernels (the 16-byte vector forms must be there);
2. the flash forward kernels against their plain version on the card
   (bf16 on the tensor-core kernel, f32 on the CUDA-core one): the serving
   path's shapes (B 1 and 8 x S 1024 and 1536), the training path's
   (B 8 x S 1024, B 4 x S 2048) and phase 11's micro-batched prefill
   (B 8 x S 128), causal and not, offset partial blocks,
   and bf16 cases for what the tensor-core tiling can get wrong: head_dim
   128 and 40 (zero-filled columns), sq = sk = 7 (below one tile), B x H
   = 1, q, k, v as strided views into one [B, S, 3, H, D] tensor, cross
   lengths, q_base > k_base with the diagonal across tile edges, and
   unnormalized partials whose first rows see no key (those rows must be
   exactly m = -1e30, l = 0, out = 0). Each case holds out within 2e-2
   (bf16) / 1e-4 (f32), an unnormalized accumulator relative to its row
   sum, m within 1e-3 and l within 1e-3 relative; an all-zero out and the
   plain output with keys 64-127 masked out must each fail that check.
   Each case prints the kernel's time with its achieved TFLOP/s (4 D
   flops per live (row, key) pair over the time), the plain version's,
   torch's scaled_dot_product_attention time as a yardstick (the port
   never calls it) and the least time the card could take (max of those
   flops over 989 TFLOP/s, or 67 in f32, and q, k, v read and out, m, l
   written once over 3.35 TB/s). A profiled bf16 call and f32 call must
   each run their own route's kernel alone. Then the crossover:
   flash_attention against reference_attention, bf16 causal, 12 heads of
   64, B x H = 96 and 12, forward and forward + backward, at seq 128 to
   2048, and the shortest length from which the kernel wins;
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
   The routes the word2vec step runs are held the same way: the gather of
   a bf16 table widened to f32 (bitwise, at the path's shapes and with
   wrapped and out-of-range ids), and the fused scatter with alpha and a
   per-row scale table, on the exact grid (alpha -1/2 and scales 2^-k, the
   deltas divided by their product, so every landing delta is on the grid:
   bitwise, wrapped and dropped ids included) and at the path's scale
   (alpha -0.025, scales in [1/2, 1], within the tolerance above); each
   with a negative control that must fail (the gather: the rows of the ids
   rolled by one; the fused scatter: the update without alpha and scale,
   and an unchanged table). Phase 12's shapes the same way, f32 out and
   fused at the path's scale (rule (b)): the Huffman path nodes of 65,536
   zipf targets (the bench counts' codes, 40 slots each, pads included)
   and the 10 context slots of 65,536 CBOW examples. Rule (b) allows h x
   ulp(A') on a row hit h times, more than the row's whole change once h
   passes ~256, so the long chains there (the root node's 65,536 adds a
   call) are held bitwise on the exact grid as well: an f32 table whose
   every update is nonzero at every element (sums exact to 2^24 units in
   any order), and the fused bf16 route with at most 100 nonzero adds an
   element (a row hit more often takes all-zero updates between them);
   the plain update without the adds of the rows hit over 256 times, and
   without one nonzero add of the hottest row, must fail the same check.
   Each timed case prints its time (ms: calls back to back under CUDA
   events, host included), its device time (device_ms: the CUPTI
   durations of the kernels its calls ran, under torch.profiler), the
   plain version's time, the PyTorch call's (index_select / index_add_,
   a yardstick the port never calls; for the f32-out gather, index_select
   and the cast as two calls) with its device time, and the least time
   the card could take (bytes over 3.35 TB/s). Then: one f32-out gather
   and one fused scatter captured in a CUDA graph, whose replays must
   equal the eager calls bit for bit; and the gather of a contiguous
   [1, D] table whose size-1 dim has stride 1 (a [D, 1] tensor
   transposed), bitwise against its plain version;
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
   time, with the device kernels it ran per step.

Phases 7-9 run after phase 3:

7. the flash backward kernels against their plain version on the card
   (bf16 on the tensor-core kernels, f32 on the CUDA-core ones): bf16
   causal at the training path's shapes (B 8 x S 1024, the one-pass
   kernel; B 4 x S 2048, the dq and dk/dv passes), f32, non-causal,
   ragged, cross lengths and offset partials (flash_attention_partial_bwd
   with rows the causal mask leaves with no key, whose dq must be 0), and
   bf16 cases for what the tensor-core tiling can get wrong: head_dim 128
   and 40 (zero-filled columns), sq = sk = 7 (below one mma tile),
   B x H = 1, q, k, v as strided views into one [B, S, 3, H, D] tensor,
   and q_base > k_base with the diagonal across tile edges; dq, dk and dv
   each within 2e-3 (bf16) / 2e-5 (f32) of max |plain|, and each one
   zeroed must fail that check. Each case prints the kernel's time with
   its achieved TFLOP/s (5 products x 2 D flops per live (row, key) pair
   over the time), the plain version's, the backward of torch's
   scaled_dot_product_attention at the same shapes (a yardstick the port
   never calls) and the least time the card could take (max of those
   flops over 989 TFLOP/s, or 67 in f32, and q, k, v, g, lse, delta read
   and dq, dk, dv written once over 3.35 TB/s); the path cases also time
   each pass alone. Phase 1 prints each kernel's ptxas registers, spills
   and shared memory, and the dynamic shared memory each launch takes,
   forward and backward;
8. one full-width f32 loss_fn gradient of the flagship through the
   kernels (attention="flash_force", seq 1024 x 2 and 2048 x 1) against
   the same gradient through reference attention: each parameter's
   relative error norm within 1e-3; the gradient with the attention
   gradient zeroed must fail it;
9. the training slice at lr 0.003 (the app's default 0.1 diverges at
   this width, see LM_LR): apps.lm.main (f32, its default dtype) for 3
   steps at each configuration, then the flagship in bf16
   (attention="flash", momentum 0.9, max_seq = seq as the app sets it)
   for 2 warm and 10
   timed train_batch steps on the app's batches of the checkout's own
   multiverso_tpu/**/*.py and *.md bytes, at seq 1024 x batch 8 and seq
   2048 x batch 4; the loss must be finite and its mean over the last 3
   steps 0.1 below the first step's; every backward kernel and both
   forward regimes on both routes (bf16 steps, the f32 app) must have
   been launched by the run; one step runs
   with torch.cuda.set_sync_debug_mode("error") (no host sync); prints ms
   per step, tokens/s, the share of 989 TFLOP/s by tools/lm_mfu.py's FLOP
   count and a torch.profiler top-10 of one step with the device busy
   share.

Phase 10 runs right after phase 3:

10. the serving engine at the JAX package's default flags: the flagship
   of phase 3 served with no feature flag passed (chunked prefill of 32
   tokens, paged KV of 16-position blocks, a pool of 8 x 100 blocks,
   prefix cache, preemption, flight recorder and watchdog on) over phase
   3's 16 prompts, six prompts sharing a 512-token prefix, one full-hit
   resubmission, priorities 0-3 and one request that must expire in the
   queue. Run A at the defaults, B with a 150-block pool (it must
   preempt), C with the prefix cache and preemption off, D in phase 3's
   monolithic contiguous layout. Each run must complete every request
   but the expired one, keep one signature per program, balance its
   pool, never trip the watchdog and record every iteration; A and B
   must equal C token for token, except full hits and preempted
   requests, which may differ only from a near-tie (the bound is in
   ``phase_defaults``'s docstring, with a negative control). Prints each
   run's tokens/s, TTFT and ITL p50/p99, the recorder's median chunk and
   step times, prefix hits, copies and preemptions, and each run's
   agreement with phase 3's oracle (each mismatch's position and top-2
   logit gap).

Phase 11 runs right after phase 10:

11. the single-card serving surface on the same flagship
   (``phase_serving_surface``): (a) speculative decoding, spec_k 4
   against 0 on the serving bench's repetitive-tail trace, the tokens
   held to the spec_k=0 run under phase 10's near-tie rule (with its
   negative control); (b) int8 KV against bf16 at equal pool bytes on
   the bench's shared-prefix trace, and the int8 pool's layer-0 rows
   held to the write path's bound (a perturbed scale must fail it); (c)
   int8 parameter pins, each int8 engine's argmax match against its
   bf16 control at least 0.7; (d) the micro-batcher serving
   EmbeddingNeighbors (against an independent matmul + topk, the query
   rows through the row gather kernel) and LMGreedyDecode (through the
   flash prefill, each reply held to greedy_decode through plain
   attention on its flush's padded batch under the near-tie rule); (e)
   train-while-serving, each reply held to greedy_decode on the snapshot
   of the version it reports, through the one-pass backward kernel; (f)
   the SLO rows of the dashboard. Each prints its numbers with the card.

Phase 13 runs right after phase 11:

13. the serving fleet on one card (``phase_fleet``): a FleetRouter over
   ReplicaServers on the real mvserve TCP wire (loopback, in-process KV),
   each replica its own copy of the flagship, every engine's cost ledger
   on, requests tagged t0-t2. (a) 3 unified replicas in phase 3's layout
   serve 24 requests fault-free and then with replica 1 killed at its
   3rd request: nothing lost, no output mismatch, exactly one death in
   the chaos leg and none in the fault-free one, the chaos leg equal to
   the fault-free leg (a replayed request within phase 10's near-tie
   rule, whose negative control must fail), the fault-free leg held to
   phase 3's oracle under that rule; replica 1 restarted, readmitted
   through the half-open probe, serving again; the flash kernel launched
   in both regimes. (b) at the JAX defaults, one prefill + one decode
   replica against two unified ones on phase 10's trace: equal outputs
   (near-tie rule where the decode side's admission computed other
   shapes), bytes moved = shipped blocks x block_nbytes, dedup of the
   shared prefix; again with kv_xfer_drop=2; an int8-KV pair shipping
   int8 blocks with their scales. (c) every ledger's residual 0 and the
   heartbeat tenant rows in router.replica_rows(). Prints tokens/s,
   TTFT and ITL p50 per leg, recovery_time_s and the bytes moved.

Phase 14 runs right after phase 13:

14. the fleet's two planes (``phase_planes``). (a) observability: phase
   3's flagship and layout serve phase 3's 16 prompts with the plane off
   and then under -obs_plane (loopback, reports every 250 ms), -trace
   and -metrics_jsonl (every 0.5 s): outputs equal token for token, the
   collector's counters equal the Dashboard's exactly, the engine's last
   shipped stats equal eng.stats()'s counts, the merged TTFT/ITL p50 and
   p99 within BUCKET_REL_ERROR of the engine's exact percentiles, no
   dropped report, the Prometheus text parses back with a node label,
   every JSON line parses (the last one's counters equal the
   Dashboard's after shutdown), the merged Chrome document validates;
   then a rank-1 agent ships over the real mvobs TCP wire to a rank-0
   collector, its reports ingested and its window released by the acks.
   (b) parameters, at the text8 width ([71291, 200] bf16 tables on the
   card): a ParamPublisher (epoch 1 by claim_epoch) and two
   ParamSubscribers over the real mvparam TCP wire; a STATE rebase, 8
   keyed records (the unique ids of a 65,536-id zipf draw, rows x 1e-3,
   applied by the trainer through the scatter-add kernel) and 1 dense
   record, each replica bitwise equal to the trainer (raw bf16 words,
   read through the row gather kernel) at its version after every
   record; EmbeddingNeighbors (k 8) on 32 ids through the micro-batcher
   on every table after delta records 4 and 9, ids and scores equal to
   the trainer's; a restarted publisher (epoch 2, zombie_epoch=4:1)
   rebases, each replica switches streams and holds epoch 2 in its table
   and snapshot; 0.75 s of silence makes every replica stale under
   -params_stale_after_s=0.5 and a publish clears it; publishes 4 and 5,
   stamped epoch 1, are rejected by every replica's fence. (c) the
   engine's staleness health on a train-while-serving flagship engine:
   after 0.75 s without a train step health() reads params_stale with
   params_age_s > 0.5 and SERVE_PARAMS_AGE >= 0.5, and one train_batch
   (the one-pass flash backward) clears it.

Phase 12 runs after phase 6:

12. word2vec completion: every single-process option of the JAX config
   on the bench corpus and width (text8 V 71,291, D 200, the 4M-word zipf
   corpus, bf16 tables, batch 65,536, G 64, row-mean by the JAX trainer's
   auto rule, static where JAX allows it): (a) CBOW + NS, (b) HS alone,
   (c) HS + NS, (d) skip-gram AdaGrad, (e) update_impl "segsum", (f)
   "split8", (g) CBOW with compact_impl "gather", (h) the host-stream
   trainer (iter_pair_batches on the loader thread, train_batches),
   skip-gram and CBOW. Each: one step on the card and on CPU copies of the
   same tables with the same draws, always at batch 65,536 (the slowest
   CPU step, HS's, takes ~22 s), the change of every table (and of
   AdaGrad's accumulators) held by phase 5's rule (segsum and split8,
   whose f32 sums round once, within one ulp of the table dtype more),
   each with a change of nothing as the failing control; for (g) the
   packed batch bitwise equal to the scatter compaction's on the same
   draws (the next slab's packing as the control). For (a) and (d), a
   witness: 4 more single steps on the card and on the CPU twin with the
   same draws, each loss within 1e-2 relative. Then one warm and 5 timed
   calls of 25 steps (host batches: the stream runs epoch after epoch),
   every loss finite and moving as the configuration's rule asks: HS,
   segsum and split8 fall by at least 1e-3 relative from the held step;
   AdaGrad (whose first updates move every touched element by ~lr, so its
   loss rises) by 1e-3 from its highest; CBOW and the host stream, under
   realized row-mean, must not rise 1e-3 over the held step (their loss
   stays at its init for hundreds of steps in the JAX package too,
   tools/w2v_loss_witness.py, and (a)'s witness shows the plain route's
   staying there as well). The row-gather kernel launched, and the
   scatter-add kernel launched exactly where the configuration's updates
   use it (not by segsum and split8); one call under
   torch.cuda.set_sync_debug_mode("error"); a profiled call's busy share
   and top 5 device ops. Prints pairs/s (examples/s for CBOW) and ms a
   call.

The line before the last is a JSON object with one entry per kernel
regime (the forward's also with the training shape's time, bound and
library time, and the training run's bf16 launches beside the serving
run's, and phase 11's beside them as ``launches_surface`` with that
path's shape's error and times as ``surface_*``, and phase 13's fleet
launches, all replicas, as ``launches_fleet``, and phase 14's as
``launches_planes``; phase 12's launches
by configuration as ``launches_completion``, and phase 4's HS-node and
CBOW-window shapes as ``hs_nodes_*`` and ``cbow_ctx_*``); the last
line is {"ok": true, "device": {...}}. Any failure exits
nonzero before either line is printed. Without a CUDA device, or without
the package beside this file, the script fails. To debug one phase, call
it directly, e.g. ``python3 -c "import chip_smoke as c;
c.phase_device(); c.phase_w2v_kernels()"``.
"""

from __future__ import annotations

import collections
import importlib
import json
import os
import re
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
W2V_ALPHA = -0.025         # the bench's -lr at the start of training
W2V_HS = f"hs nodes n={W2V_BATCH}x40"
W2V_CBOW = f"cbow ctx n={W2V_BATCH}x10"
W2V_SRC = {"row_gather": "multiverso_tpu_torch/csrc/row_gather.cu",
           "row_scatter_add": "multiverso_tpu_torch/csrc/row_scatter_add.cu"}
PROBE = "tools/w2v_kernel_probe.py"
DEV = torch.device("cuda")
FB_SRC = "multiverso_tpu_torch/csrc/flash_bwd.cu"
# the Pallas backward kernels (multiverso_tpu/ops/flash_attention.py)
FB_JAX_LINES = {"fused": 469, "dq": 350, "dkv": 409}
# products of 2 * D flops per live (row, key) pair that each function needs
FB_PRODUCTS = {"fused": 5, "dq": 3, "dkv": 4}
# kernel vs plain, per output: max |diff| <= tol x max |plain|. The two sum
# in other orders, which flips the bf16 rounding of a few p / ds values:
# ~1e-4 of the largest gradient in bf16 and ~1e-6 in f32 (two summation
# orders on the CPU, B 1 x H 2 x S 1024); the tolerances leave 20x.
FB_TOL = {torch.bfloat16: 2e-3, torch.float32: 2e-5}
_BF, _F32 = torch.bfloat16, torch.float32
FB_CASES = (  # B, sq, sk, dtype, causal, q_base, k_base
    (8, 1024, 1024, _BF, True, 0, 0),     # the path: one pass
    (4, 2048, 2048, _BF, True, 0, 0),     # the path: dq + dk/dv passes
    (8, 1024, 1024, _F32, True, 0, 0),
    (4, 2048, 2048, _F32, True, 0, 0),
    (8, 1024, 1024, _BF, False, 0, 0),
    (2, 2048, 2048, _F32, False, 0, 0),
    (2, 1000, 1000, _BF, True, 0, 0),     # ragged
    (2, 1500, 1500, _BF, True, 0, 0),
    (2, 512, 1536, _BF, True, 0, 0),      # cross lengths
    (2, 300, 700, _F32, False, 0, 0),
    # offset partials: rows 0..511 (and 0..1023) see no key
    (8, 768, 768, _BF, True, 0, 512),
    (8, 768, 768, _BF, True, 768, 0),
    (2, 1536, 1536, _F32, True, 0, 1024),
)
# bf16 cases for what the tensor-core tiling can get wrong:
# B, H, D, sq, sk, causal, q_base, k_base, packed (q, k, v strided views
# into one [B, S, 3, H, D] tensor)
FB_TILE_CASES = (
    (2, 4, 128, 1024, 1024, True, 0, 0, False),    # D 128
    (2, 4, 128, 2048, 2048, True, 0, 0, False),
    (2, 6, 40, 1024, 1024, True, 0, 0, False),     # D 40: zero-filled cols
    (2, 6, 40, 1500, 1500, True, 0, 0, False),
    (3, 2, 64, 7, 7, True, 0, 0, False),           # below one mma tile
    (3, 2, 64, 7, 7, False, 0, 0, False),
    (1, 1, 64, 1000, 1000, True, 0, 0, False),     # B * H = 1
    (1, 1, 64, 1500, 1500, True, 0, 0, False),
    (2, 12, 64, 1024, 1024, True, 0, 0, True),     # packed qkv views
    (2, 12, 64, 2048, 2048, True, 0, 0, True),
    # q_base > k_base, the diagonal across tile edges
    (2, 4, 64, 300, 260, True, 70, 5, False),
    (2, 4, 64, 1300, 1200, True, 100, 37, False),
)
# the design of each route's kernels, forward and backward (the kernels
# line's "design")
FB_DESIGN = {torch.bfloat16: "mma.sync bf16", torch.float32: "fmaf f32"}
# the training slice: (seq, batch) of tools/lm_mfu.py:97-103, ~8k tokens
LM_TRAIN = ((1024, 8), (2048, 4))
# the full-width f32 gradient check: (seq, batch), one per regime
GRAD_CASES = ((1024, 2), (2048, 1))
LM_APP_STEPS, LM_WARM, LM_TIMED = 3, 2, 10
# the app's default lr 0.1 (momentum 0.9) diverges at this width: on an
# H100 80GB HBM3 (700 W) this phase went 6.12 -> 48.39 in 12 bf16 steps
# and the f32 app 6.12 -> 13.60 in 3, and the JAX reference rises step
# for step with the port at d_model 768 (tests/test_torch_lm_training.py);
# the slice trains at a lower lr, momentum 0.9 as the app's
LM_LR = 0.003
# the loss must fall: the mean of the last 3 timed steps below the first
# step's loss by at least this much (nats), set before the first run
LM_LOSS_DROP = 0.1
# full-width f32 gradient, flash kernels vs reference attention: each
# parameter's ||g_flash - g_ref|| / ||g_ref||. The two attentions sum in
# other orders in f32 (~1e-6 relative); twelve layers of backward carry
# that into every gradient; 1e-3 leaves a wide margin and is far below
# the ~1 that a lost attention gradient gives
GRAD_TOL = 1e-3
T_START = time.perf_counter()


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
        say(f"ptxas {name}: " + " | ".join(ptxas_report(log)))
    smem = kernels.load("flash_fwd").mv_flash_fwd_smem_bytes
    say("flash_fwd dynamic shared memory (bytes): " + ", ".join(
        f"{route} D{d} {smem(dtype, d)}"
        for route, dtype in (("bf16", 1), ("f32", 0)) for d in (64, 128)))
    smem = kernels.load("flash_bwd").mv_flash_bwd_smem_bytes
    say("flash_bwd dynamic shared memory (bytes): " + ", ".join(
        f"{kind} {route} D{d} {smem(code, dtype, d)}"
        for route, dtype in (("bf16", 1), ("f32", 0)) for d in (64, 128)
        for kind, code in (("fused", 0), ("dq", 1), ("dkv", 2))))
    reds = sass_reductions(
        kernels.library_path("row_scatter_add"),
        os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump"))
    say("row_scatter_add SASS reductions: " + " | ".join(
        f"{name} {' '.join(sorted(ops))}" for name, ops in reds.items()))
    ops = set().union(*reds.values())
    for want in ("REDG.E.ADD.BF16x8", "REDG.E.ADD.F32x4"):
        if not any(op.startswith(want) for op in ops):
            fail(f"row_scatter_add: no {want} (16-byte vector reduction) "
                 f"in its SASS: {sorted(ops)}")
    return card


def sass_reductions(lib, cuobjdump: str) -> dict:
    """Each kernel of a built library and the reduction and atomic
    opcodes (RED*, ATOM*) that ``cuobjdump -sass`` shows in it."""
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = kernel_label(m.group(1))
            out[name] = set()
            continue
        m = re.search(r"\b((?:RED|ATOM)[A-Z0-9.x]*)", ln)
        if m and name:
            out[name].add(m.group(1))
    return out


def kernel_label(mangled: str) -> str:
    """``name<template args>`` of a kernel in a namespace (``_ZN<len><ns>
    <len><name>I<args>EEv...``), else the mangled name as it is."""
    m = re.match(r"_ZN(\d+)", mangled)
    k = m and re.match(r"\d+", mangled[m.end() + int(m.group(1)):])
    if not k:
        return mangled
    start = m.end() + int(m.group(1)) + k.end()
    end = start + int(k.group(0))
    args = re.match(r"I(.*?)EEv", mangled[end:])
    if not args:
        return mangled[start:end]
    return (f"{mangled[start:end]}<"
            + re.sub(r"L[a-z](\d+)E", r"\1,", args.group(1)).rstrip(",")
            .replace("13__nv_bfloat16", "bf16") + ">")


def ptxas_report(log: str):
    """One entry per kernel of a ``ptxas -v`` log: its name and template
    arguments, registers, spill bytes (stores + loads) and static shared
    memory."""
    out, name, spill = [], None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = kernel_label(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            sm = re.search(r"(\d+) bytes smem", ln)
            out.append(f"{name} {m.group(1)} regs, {spill} B spill, "
                       f"{sm.group(1) if sm else 0} B static smem")
            name, spill = None, 0
    return out


# the forward's check, kernel vs plain: out within FA_ATOL (an
# unnormalized accumulator relative to its row sum l, i.e. as the
# normalized output), m within FA_M_TOL and l within FA_L_REL relative
FA_ATOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
FA_M_TOL, FA_L_REL = 1e-3, 1e-3


def fa_case(B, sq, sk, dtype, causal=True, q_base=0, k_base=0,
            normalize=True, H=12, D=64, packed=False, name=None):
    return dict(B=B, sq=sq, sk=sk, dtype=dtype, causal=causal,
                q_base=q_base, k_base=k_base, normalize=normalize, H=H, D=D,
                packed=packed, name=name)


# forward cases; "name" marks the main paths' shapes for the kernels line
FA_CASES = [fa_case(8, sk, sk, dt, causal)
            for dt in (_BF, _F32) for sk in (1024, 1536)
            for causal in (True, False)
            if (dt, sk, causal) != (_BF, 1024, True)]
FA_CASES += [
    # the training path: K3's regime (key length <= 1024) and K4's
    fa_case(8, 1024, 1024, _BF, name="train_short"),
    fa_case(4, 2048, 2048, _BF, name="train_long"),
    fa_case(4, 2048, 2048, _F32),
    # one admission's prefill: batch 1
    fa_case(1, 1024, 1024, _BF, name="serve_short"),
    fa_case(1, 1536, 1536, _BF, name="serve_long"),
    # phase 11's LMGreedyDecode prefill: a full bucket of 8 at max_prompt
    fa_case(8, 128, 128, _BF, name="surface_lmg"),
    # ring-step partials: a later q shard against an earlier k shard, and
    # an offset that leaves the first 512 rows fully masked
    fa_case(8, 768, 768, _BF, q_base=768, normalize=False),
    fa_case(8, 768, 768, _F32, k_base=512, normalize=False),
]
# bf16 cases for what the tensor-core tiling can get wrong
FA_CASES += [
    fa_case(2, 1024, 1024, _BF, H=4, D=128),           # D 128
    fa_case(2, 1500, 1500, _BF, False, H=4, D=128),
    fa_case(2, 1024, 1024, _BF, H=6, D=40),            # zero-filled cols
    fa_case(2, 1500, 1500, _BF, H=6, D=40),
    fa_case(3, 7, 7, _BF, H=2),                        # below one tile
    fa_case(3, 7, 7, _BF, False, H=2),
    fa_case(1, 1000, 1000, _BF, H=1),                  # B x H = 1, ragged
    fa_case(1, 1500, 1500, _BF, H=1),
    fa_case(2, 1024, 1024, _BF, packed=True),          # packed qkv views
    fa_case(2, 2048, 2048, _BF, packed=True),
    fa_case(2, 512, 1536, _BF, H=4),                   # cross lengths
    fa_case(2, 1536, 512, _BF, H=4),
    fa_case(2, 300, 700, _BF, False, H=4),
    # q_base > k_base, the diagonal across tile edges
    fa_case(2, 300, 260, _BF, q_base=70, k_base=5, H=4),
    fa_case(2, 1300, 1200, _BF, q_base=100, k_base=37, normalize=False,
            H=4),
    # unnormalized partials whose first rows see no key
    fa_case(2, 300, 400, _BF, k_base=100, normalize=False, H=4),
    fa_case(2, 300, 400, _BF, q_base=37, k_base=101, normalize=False, H=4,
            D=128),
]
# keys left out by the wrong-mask negative control
FA_CONTROL_KEYS = (64, 128)


def fa_errors(got, ref, normalize: bool):
    """(max out error, max m error, max l relative error) of ``got``
    against ``ref``, both ``(out, m, l)``."""
    out, m, l = got
    ref_out, ref_m, ref_l = ref
    diff = (out.float() - ref_out.float()).abs()
    if not normalize:
        # an unnormalized accumulator grows with the row sum l: hold its
        # error relative to the row (the normalized output's error)
        diff = diff / ref_l.clamp(min=1.0).transpose(1, 2)[..., None]
    return (diff.max().item(), (m - ref_m).abs().max().item(),
            ((l - ref_l).abs() / ref_l.abs().clamp(min=1.0)).max().item())


def fa_passes(errs, atol: float) -> bool:
    err, m_err, l_rel = errs
    return bool(np.isfinite(err) and err <= atol and m_err <= FA_M_TOL
                and l_rel <= FA_L_REL)


def plain_without_keys(fa, q, k, v, q_base, k_base, lo, hi, *, causal,
                       scale, normalize):
    """The plain version with keys [lo, hi) left out, a wrong mask: the
    plain partials of the keys before and after them, merged."""
    (acc_a, m_a, l_a), (acc_b, m_b, l_b) = (
        fa._fa_plain(q, k[:, a:b], v[:, a:b], q_base, k_base + a,
                     causal=causal, scale=scale, normalize=False)
        for a, b in ((0, lo), (hi, k.shape[1])))
    m, l, acc = fa.merge_partials(m_a, l_a, acc_a, m_b, l_b, acc_b)
    if normalize:
        acc = (acc / torch.clamp(l, min=1e-20).transpose(1, 2)[..., None]
               ).to(q.dtype)
    return acc, m, l


def fa_bound_ms(B, H, D, sq, sk, causal, q_base, k_base, item, normalize,
                dtype):
    """The least time of one forward call (module docstring) and what
    bounds it, with the flops it needs."""
    pairs = live_pairs(sq, sk, causal, q_base, k_base)
    flops = 4.0 * B * H * D * pairs
    out_bytes = B * sq * H * D * (item if normalize else 4)
    nbytes = (B * sq * H * D + 2 * B * sk * H * D) * item + out_bytes \
        + 2 * B * H * sq * 4
    peak = TFLOPS_BF16 if dtype == torch.bfloat16 else TFLOPS_F32
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops)


def device_kernels(fn):
    """Names of the device kernels that one call of ``fn`` runs."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")}


def fa_case_run(fa, c, gen):
    """One forward case on the card (module docstring, phase 2): the
    kernel against the plain version, its two negative controls, dead
    rows, times; prints one line and returns the result."""
    import torch.nn.functional as F

    B, H, D, sq, sk, dt = (c[x] for x in ("B", "H", "D", "sq", "sk",
                                          "dtype"))
    qb, kb, causal, norm = c["q_base"], c["k_base"], c["causal"], \
        c["normalize"]
    if c["packed"]:   # q, k, v: strided views into one [B, S, 3, H, D]
        q, k, v = torch.randn((B, sq, 3, H, D), generator=gen).to(
            DEV, dt).unbind(2)
    else:
        q = torch.randn((B, sq, H, D), generator=gen).to(DEV, dt)
        k, v = (torch.randn((B, sk, H, D), generator=gen).to(DEV, dt)
                for _ in range(2))
    scale = 1.0 / D ** 0.5
    kw = dict(causal=causal, scale=scale, normalize=norm)
    got = fa._fa_cuda(q, k, v, qb, kb, **kw)
    torch.cuda.synchronize()
    ref = fa._fa_plain(q, k, v, qb, kb, **kw)
    errs = fa_errors(got, ref, norm)
    atol = FA_ATOL[dt]
    tag = (f"B={B} H={H} D={D} sq={sq} sk={sk} {str(dt).split('.')[-1]} "
           f"causal={int(causal)} offs=({qb},{kb}) norm={int(norm)}"
           f"{' packed' if c['packed'] else ''}")
    if not fa_passes(errs, atol):
        fail(f"flash kernel vs plain {tag}: max_abs_err {errs[0]} (atol "
             f"{atol}), m err {errs[1]} (tol {FA_M_TOL}), l rel err "
             f"{errs[2]} (tol {FA_L_REL})")
    dead = max(0, min(sq, kb - qb)) if causal else 0
    out, m, l = got
    if dead and not (bool((m[:, :, :dead] == -1e30).all())
                     and bool((l[:, :, :dead] == 0).all())
                     and bool((out[:, :dead] == 0).all())):
        fail(f"flash kernel {tag}: rows with no live key are not m = "
             f"-1e30, l = 0, out = 0")
    # negative controls: each must fail the same check
    controls = {"zero out": (torch.zeros_like(out), m, l)}
    lo, hi = FA_CONTROL_KEYS
    if sk > lo and (not causal or qb + sq - 1 >= kb + lo):
        controls[f"keys {lo}-{hi - 1} masked"] = plain_without_keys(
            fa, q, k, v, qb, kb, lo, hi, **kw)
    for name, ctl in controls.items():
        if fa_passes(fa_errors(ctl, ref, norm), atol):
            fail(f"flash kernel {tag}: negative control: the {name} "
                 f"passes the check")
    failing = ", ".join(controls)
    del ref, controls
    ms = time_ms(lambda: fa._fa_cuda(q, k, v, qb, kb, **kw))
    plain_ms = time_ms(lambda: fa._fa_plain(q, k, v, qb, kb, **kw))
    lib_ms = None
    if norm and qb == kb == 0:
        # the library call (the port never calls it), top-left causal
        # mask as the kernel's at equal offsets
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale))
        del qt, kt, vt
    bound, by, flops = fa_bound_ms(B, H, D, sq, sk, causal, qb, kb,
                                   q.element_size(), norm, dt)
    tflops = flops / (ms * 1e-3) / 1e12
    say(f"kernel flash_fwd {tag} [{FB_DESIGN[dt]}]: max_abs_err "
        f"{errs[0]:.3e} m_err {errs[1]:.3e} l_rel {errs[2]:.3e} (failing "
        f"controls: {failing}{f'; {dead} dead rows exact' if dead else ''})"
        f" ms {ms:.4f} ({tflops:.1f} TFLOP/s) plain_ms {plain_ms:.4f} "
        f"library_ms {fmt(lib_ms)} bound_ms {bound:.4f} ({by})")
    return dict(max_abs_err=errs[0], ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=lib_ms,
                tflops=tflops)


def phase_kernels():
    """The forward kernels against their plain version on the card
    (module docstring, phase 2). Returns the named cases' results."""
    fa = _fa()
    gen = torch.Generator(device="cpu").manual_seed(0)
    results = {}
    for c in FA_CASES:
        r = fa_case_run(fa, c, gen)
        if c["name"]:
            results[c["name"]] = r
        torch.cuda.empty_cache()
    # each route launches its own kernel and only it
    q = torch.randn((2, 256, 4, 64), generator=gen).to(DEV)
    for dt, want, other in ((_BF, "mma_fwd_kernel", "flash_fwd_kernel"),
                            (_F32, "flash_fwd_kernel", "mma_fwd_kernel")):
        x = q.to(dt)
        names = [n for n in device_kernels(lambda: fa._fa_cuda(
            x, x, x, 0, 0, causal=True, scale=0.125, normalize=True))
            if "fwd" in n]
        say(f"flash_fwd {str(dt).split('.')[-1]} call ran: {names}")
        if not names or not all(want in n and other not in n
                                for n in names):
            fail(f"a {dt} forward call ran {names}, not {want} alone")
    return results


# the crossover sweep: sequence lengths, and batches giving B x H = 96
# (the seq 1024 x 8 training step's programs) and 12 (one prefill)
CROSS_SEQS = (128, 256, 512, 1024, 1536, 2048)
CROSS_BATCHES = (8, 1)


def phase_crossover():
    """flash_attention against reference_attention on the card, bf16
    causal at the flagship's 12 heads of 64: the forward alone (a prefill)
    and forward + backward (a training step's attention) at each length of
    CROSS_SEQS. The crossover is the shortest length from which the kernel
    is faster at every longer one (FLASH_CROSSOVER_SEQ and the in-model
    min_flash_seq mirror the JAX package's TPU values)."""
    from multiverso_tpu_torch.ops.ring_attention import reference_attention

    fa = _fa()
    H, D = FLAGSHIP["n_heads"], FLAGSHIP["d_model"] // FLAGSHIP["n_heads"]
    gen = torch.Generator(device="cpu").manual_seed(5)
    for B in CROSS_BATCHES:
        wins = {"forward": [], "forward+backward": []}
        for S in CROSS_SEQS:
            q, k, v, g = (torch.randn((B, S, H, D), generator=gen).to(
                DEV, torch.bfloat16) for _ in range(4))
            ms = {}
            for name, fn in (("flash", fa.flash_attention),
                             ("reference", reference_attention)):
                ms[name, "forward"] = time_ms(
                    lambda: fn(q, k, v, causal=True))
                leaves = [x.clone().requires_grad_() for x in (q, k, v)]

                def step():
                    out = fn(*leaves, causal=True)
                    torch.autograd.grad(out, leaves, g)

                ms[name, "forward+backward"] = time_ms(step)
                del leaves
            for what in wins:
                wins[what].append(ms["flash", what] < ms["reference", what])
            say(f"crossover B={B} H={H} D={D} S={S} bf16 causal: forward "
                f"flash {ms['flash', 'forward']:.4f} ms reference "
                f"{ms['reference', 'forward']:.4f} ms; forward+backward "
                f"flash {ms['flash', 'forward+backward']:.4f} ms reference "
                f"{ms['reference', 'forward+backward']:.4f} ms")
            del q, k, v, g
            torch.cuda.empty_cache()
        for what, won in wins.items():
            # the shortest length from which flash wins at every longer one
            i = len(won)
            while i > 0 and won[i - 1]:
                i -= 1
            at = f"S >= {CROSS_SEQS[i]}" if i < len(won) else "none measured"
            say(f"crossover B x H = {B * H}, {what}: the kernel is faster "
                f"from {at} (seqs {list(CROSS_SEQS)})")


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
    oracle = []
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
        oracle.append(want)
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
    return {"short": short, "long": long_, "prompts": prompts,
            "oracle": oracle}


# phase 10: the serving engine at the JAX package's default flags
DEF_SHARED = 512          # shared prefix: 32 blocks of 16, 16 chunks of 32
DEF_SUFFIX = (16, 200)    # the shared-prefix prompts' distinct suffixes
DEF_N_SHARED = 6
# run B's pool: 1.5 sequences' worst case (100 blocks). Chunked admission
# brings one ~96-block prompt in at a time, so larger pools rarely fill:
# on this traffic at d_model 32 on a CPU (the schedule depends on neither
# the width nor the device), pools of 300 and 250 blocks never preempted,
# 200 once, 150 six times
DEF_POOL_B = 150
DEF_DEADLINE_S = 0.001    # expires while queued behind the burst
BF16_U = 2.0 ** -8        # bf16 unit roundoff (8-bit significand)


def default_traffic(base, vocab: int):
    """Phase 3's prompts, then six prompts sharing one 512-token prefix
    with distinct 16-200-token suffixes (the first rounded up to whole
    blocks: it is resubmitted after its reply, a full prefix hit), and
    priorities 0-3. Returns (prompts, priorities, index of the
    resubmitted prompt)."""
    rng = np.random.default_rng(2)
    shared = rng.integers(0, vocab, DEF_SHARED)
    lens = rng.integers(DEF_SUFFIX[0], DEF_SUFFIX[1] + 1, DEF_N_SHARED)
    lens[0] = -(-lens[0] // 16) * 16
    prompts = list(base) + [
        np.concatenate([shared, rng.integers(0, vocab, int(n))])
        for n in lens]
    return prompts, rng.integers(0, 4, len(prompts)), len(base)


@torch.no_grad()
def top2_gaps(cfg, params, prompt, out):
    """For each generated position j of ``prompt + out``: the top-2 logit
    gap of the logits that predict ``out[j]``, and the bound
    2 u sum_d |h_d| (|e_1d| + |e_2d|) (phase 10's docstring), from one
    forward through reference attention."""
    from multiverso_tpu_torch.models import transformer as tf

    toks = torch.from_numpy(np.concatenate([prompt, out[:-1]])).to(DEV)
    h = params["embed"][toks[None]] + params["pos"][:toks.shape[0]]
    for layer in tf._layers(params):
        h, _, _ = tf._block(cfg, layer, h)
    h = tf._rmsnorm(h, params["ln_f_g"])[0, len(prompt) - 1:].float()
    e = params["embed"].float()
    top = (h @ e.t()).topk(2, dim=-1)
    ea = e.abs()
    bound = 2 * BF16_U * (h.abs() * (ea[top.indices[:, 0]]
                                     + ea[top.indices[:, 1]])).sum(-1)
    gap = top.values[:, 0] - top.values[:, 1]
    return gap.cpu().numpy(), bound.cpu().numpy()


def first_mismatch(a, b):
    diff = np.nonzero(np.asarray(a) != np.asarray(b))[0]
    return int(diff[0]) if diff.size else None


def divergence_allowed(cfg, params, prompt, got, ref):
    """``(ok, (j, gap, bound))``: ``got`` may differ from the reference
    run's ``ref`` only from a position where ref's top-2 gap is under the
    bf16 bound."""
    j = first_mismatch(got, ref)
    if j is None:
        return True, None
    gap, bound = top2_gaps(cfg, params, prompt, ref)
    return bool(gap[j] < bound[j]), (j, float(gap[j]), float(bound[j]))


def serve_defaults(srv, lm, label, prompts, prios, repeat, **knobs):
    """One run of the default-flag engine: the burst, the expiring
    request, then the resubmission once the first reply is in. Fails
    unless every request but the expired one completes, that one raises
    DeadlineExceededError unadmitted, each program keeps one signature,
    the books balance after the drain, the watchdog never tripped and
    the recorder holds a record per iteration."""
    from multiverso_tpu_torch.serving import DeadlineExceededError

    name = f"lm_{label}"
    eng = srv.register_decoder(name, lm, slots=SLOTS, max_prompt=MAX_PROMPT,
                               max_new=MAX_NEW, **knobs)
    admitted, full_hits, preempted = set(), set(), set()
    begin, preempt = eng._begin_prefill, eng._preempt

    def begin_seen(req, slot):
        begin(req, slot)
        admitted.add(id(req.future))
        if req.full_hit:
            full_hits.add(id(req.future))

    def preempt_seen(req, why=""):
        preempted.add(id(req.future))
        preempt(req, why)

    eng._begin_prefill, eng._preempt = begin_seen, preempt_seen
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [srv.submit(name, {"prompt": p, "max_new": MAX_NEW,
                              "priority": int(pr)})
            for p, pr in zip(prompts, prios)]
    late = srv.submit(name, {"prompt": prompts[0], "max_new": MAX_NEW,
                             "priority": 0, "deadline_s": DEF_DEADLINE_S})
    futs[repeat].result(timeout=600)
    futs.append(srv.submit(name, {"prompt": prompts[repeat],
                                  "max_new": MAX_NEW,
                                  "priority": int(prios[repeat])}))
    outs = [np.asarray(f.result(timeout=600)["result"]) for f in futs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    try:
        late.result(timeout=600)
        fail(f"run {label}: the {DEF_DEADLINE_S} s deadline request was "
             f"served")
    except DeadlineExceededError:
        pass
    if id(late) in admitted:
        fail(f"run {label}: the expired request was admitted")
    deadline = time.monotonic() + 30
    while (eng.health()["live_seqs"] or eng.queue_depth()
           or eng.recorder.total < eng.iters_total):
        if time.monotonic() > deadline:
            fail(f"run {label}: the engine did not drain")
        time.sleep(0.01)
    st = eng.stats()
    recs = eng.recorder.records()
    chunk_ms = [r["busy_ms"] - r["step_ms"] for r in recs
                if r["prefill_toks"] > 0]
    step_ms = [r["step_ms"] for r in recs if r["step_ms"] > 0]
    paged = st["kv_block_size"] > 0
    drift = eng.pool_drift() or (eng._pool.drift() if paged else None)
    # a monolithic engine has one admission signature per prompt bucket
    prefill_sigs = 1 if st["prefill_token_budget"] else len(BUCKETS)
    problems = []
    if st["completed"] != len(futs) or st["deadline_drops"] != 1:
        problems.append(f"completed {st['completed']} of {len(futs)}, "
                        f"deadline drops {st['deadline_drops']}")
    if st["step_traces"] != 1 or st["prefill_traces"] > prefill_sigs:
        problems.append(f"signatures: step {st['step_traces']}, prefill "
                        f"{st['prefill_traces']}")
    if drift is not None or st.get("kv_blocks_live", 0):
        problems.append(f"pool after the drain: {drift}, "
                        f"{st.get('kv_blocks_live')} live blocks")
    if st["watchdog_trips"] or eng.recorder.total < st["iters_total"]:
        problems.append(f"watchdog trips {st['watchdog_trips']}, "
                        f"{eng.recorder.total} records for "
                        f"{st['iters_total']} iterations")
    vocab = lm.config.vocab_size
    if any(o.shape != (MAX_NEW,) or o.min() < 0 or o.max() >= vocab
           for o in outs):
        problems.append("an output of the wrong shape or range")
    if problems:
        fail(f"run {label}: " + "; ".join(problems))
    flags = ", ".join(f"{k}={v}" for k, v in knobs.items())
    pass_name = "chunk" if st["prefill_token_budget"] else "admission"
    say(f"defaults run {label} ({flags or 'no feature flags'}): "
        f"{len(outs)} requests, {st['tokens']} tokens in {wall:.3f} s = "
        f"{st['tokens'] / wall:.1f} tok/s, TTFT p50 {st['ttft_p50_ms']:.2f} "
        f"p99 {st['ttft_p99_ms']:.2f} ms, ITL p50 {st['itl_p50_ms']:.2f} "
        f"p99 {st['itl_p99_ms']:.2f} ms, median {pass_name} "
        f"{float(np.median(chunk_ms)):.3f} ms ({len(chunk_ms)} "
        f"iterations with one, the step left out), median step "
        f"{float(np.median(step_ms)):.3f} ms ({len(step_ms)} steps), "
        f"prefix hits {st.get('prefix_hits', 0)} misses "
        f"{st.get('prefix_misses', 0)} tokens saved "
        f"{st.get('prefill_tokens_saved', 0)}, copy-on-write "
        f"{st.get('cow_copies', 0)}, preemptions {st['preemptions']} "
        f"({st['preempted']} requests), iterations {st['iters_total']}, "
        f"block-table uploads {st.get('block_table_uploads', 0)}, peak "
        f"live {st['peak_live_seqs']}, card {card_line()}")
    eng.stop()
    index = {id(f): i for i, f in enumerate(futs)}
    return {"outs": outs, "stats": st,
            "full_hits": {index[k] for k in full_hits if k in index},
            "preempted": {index[k] for k in preempted if k in index}}


_CARD = []


def card_line() -> str:
    return _CARD[0] if _CARD else "?"


def phase_defaults(card: str, base_prompts, oracle):
    """10. the serving engine at the JAX package's default flags (runs
    right after phase 3, on its configuration): the flagship in bf16 from
    seed 0, 8 slots, max_prompt 1536, max_new 64, and no feature flag
    passed, so budget 32, block 16, a pool of 8 x 100 blocks, prefix
    cache, preemption, flight recorder and watchdog on. The traffic is
    phase 3's 16 prompts, six prompts sharing a 512-token prefix, one
    resubmission of a whole-block prompt after its reply (a full hit, so
    a copy-on-write), priorities 0-3 and one request whose 1 ms deadline
    expires in the queue. Three runs: A at the defaults, B with a pool of
    150 blocks (so the optimistic admission must preempt), C with the
    prefix cache and preemption off (the control). A fourth run, D, is
    phase 3's layout (monolithic flash prefill, contiguous KV) on the
    same traffic, the baseline for chunked admission's TTFT and ITL; it
    is held to the same run checks and to phase 3's oracle, not to C.

    Every request of A and B must equal C's wherever the two computed the
    same shapes: every request that was neither a full hit nor preempted
    (the shared prefix ends on a chunk boundary, so the suffix chunks are
    C's row for row). A full hit recomputes position P - 1 through the
    decode step and a preempted request re-prefills its emitted tokens
    through chunks, so their bf16 roundings differ from C's and an argmax
    may flip at a near-tie. The bound: if the layers below agree to
    rounding, the last hidden state h (bf16) of the two programs differs
    by at most one rounding of each element on each side, |dh_d| <= 2 u
    |h_d| with u = 2^-8, and the logit gap of the top two candidates
    moves by at most 2 u sum_d |h_d| (|e_1d| + |e_2d|) (e the tied
    embedding rows). The absolute sum leaves room, sqrt(768)-fold for
    random signs, for differences carried up from the layers below. A
    full hit's or a preempted request's first mismatch with C must sit
    where C's top-2 gap (recomputed by one reference-attention forward)
    is under this bound. Negative control: C's own output with the token
    at its largest gap-to-bound position swapped for the runner-up must
    fail the same check."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models import transformer as tf
    from multiverso_tpu_torch.serving import InferenceServer

    _CARD[:] = [card]
    mv.init(["chip_smoke", "-device=cuda"])
    cfg = tf.TransformerConfig(**FLAGSHIP, dtype=torch.bfloat16,
                               attention="flash_force")
    lm = tf.TransformerLM(cfg)
    params, _ = lm.snapshot_params()
    ref_cfg = tf.TransformerConfig(**FLAGSHIP, dtype=torch.bfloat16,
                                   attention="reference")
    prompts, prios, repeat = default_traffic(base_prompts, cfg.vocab_size)
    all_prompts = prompts + [prompts[repeat]]
    srv = InferenceServer("chip_smoke_defaults")
    runs = {"A": serve_defaults(srv, lm, "A", prompts, prios, repeat),
            "B": serve_defaults(srv, lm, "B", prompts, prios, repeat,
                                kv_pool_blocks=DEF_POOL_B),
            "C": serve_defaults(srv, lm, "C", prompts, prios, repeat,
                                prefix_cache=False, preempt=False),
            # phase 3's layout on this traffic: chunked against monolithic
            "D": serve_defaults(srv, lm, "D", prompts, prios, repeat,
                                prompt_buckets=BUCKETS,
                                prefill_token_budget=0, kv_block_size=0)}
    a, b, c = runs["A"]["stats"], runs["B"]["stats"], runs["C"]["stats"]
    if not (a["prefix_hits"] > 0 and a["cow_copies"] >= 1):
        fail(f"run A: prefix hits {a['prefix_hits']}, copy-on-write "
             f"{a['cow_copies']}")
    if b["preemptions"] <= 0:
        fail(f"run B: no preemption with a {DEF_POOL_B}-block pool")
    if c["prefix_hits"] or c["preemptions"]:
        fail("run C: the control hit the prefix cache or preempted")

    ref = runs["C"]["outs"]
    for label in ("A", "B"):
        run = runs[label]
        exact = others = 0
        for i, got in enumerate(run["outs"]):
            excused = i in run["full_hits"] or i in run["preempted"]
            if np.array_equal(got, ref[i]):
                exact += 1
                continue
            if not excused:
                fail(f"run {label}: request {i} ("
                     f"{len(all_prompts[i])}-token prompt), neither a full "
                     f"hit nor preempted, differs from run C at token "
                     f"{first_mismatch(got, ref[i])}")
            ok, (j, gap, bound) = divergence_allowed(
                ref_cfg, params, all_prompts[i], got, ref[i])
            others += 1
            say(f"defaults run {label}: request {i} ("
                f"{'full hit' if i in run['full_hits'] else 'preempted'}) "
                f"first differs from C at token {j}: C's top-2 gap "
                f"{gap:.5f}, bound {bound:.5f}")
            if not ok:
                fail(f"run {label}: request {i} diverges from C at token {j}"
                     f" where C's top-2 gap {gap:.5f} >= bound {bound:.5f}")
        say(f"defaults run {label} vs C: {exact}/{len(ref)} token-identical, "
            f"{others} within the bf16 bound; full hits "
            f"{sorted(run['full_hits'])}, preempted "
            f"{sorted(run['preempted'])}")

    # negative control: a divergence at C's widest margin must fail
    gap, bound = top2_gaps(ref_cfg, params, all_prompts[repeat], ref[repeat])
    j = int(np.argmax(gap / bound))
    if gap[j] < bound[j]:
        fail(f"negative control: the bound exceeds every gap of C's "
             f"request {repeat} (largest gap/bound {gap[j] / bound[j]:.3f})")
    fake = ref[repeat].copy()
    fake[j] = (fake[j] + 1) % cfg.vocab_size
    ok, _ = divergence_allowed(ref_cfg, params, all_prompts[repeat], fake,
                               ref[repeat])
    if ok:
        fail("negative control: a divergence at a wide gap passed")
    say(f"defaults negative control: a divergence at token {j} of request "
        f"{repeat}, C's top-2 gap {gap[j]:.5f} against bound "
        f"{bound[j]:.5f}, fails the check; median bound over its tokens "
        f"{float(np.median(bound)):.5f}, median gap "
        f"{float(np.median(gap)):.5f}")

    # phase 3's oracle: monolithic flash prefill, contiguous decode
    for label in ("A", "B", "C", "D"):
        outs = runs[label]["outs"]
        same, notes = 0, []
        for i, want in enumerate(oracle):
            j = first_mismatch(outs[i], want)
            if j is None:
                same += 1
                continue
            g, _ = top2_gaps(ref_cfg, params, all_prompts[i], want)
            notes.append(f"request {i} at token {j} (gap {g[j]:.5f})")
        say(f"defaults run {label} vs phase 3's greedy_decode oracle: "
            f"{same}/{len(oracle)} token-identical"
            + (f"; mismatches: {', '.join(notes)}" if notes else ""))
    srv.stop()
    mv.shutdown()


# phase 11: the single-card serving surface
SPEC_K, SPEC_SLOTS, SPEC_PROMPT, SPEC_CAP, SPEC_MIN_NEW = 4, 2, 12, 64, 48
SPEC_N, SPEC_BLOCK = 24, 8
QKV_BLOCK, QKV_PREFIX, QKV_TAIL, QKV_CAP, QKV_MIN_NEW = 8, 64, 8, 24, 12
QKV_N, QKV_SLOTS, QKV_FP_BLOCKS = 48, 24, 23
# the int8 engines' argmax-match floor against their bf16 control, the
# JAX package's (tests/test_quant_serving.py)
QUANT_MATCH_FLOOR = 0.7
EMB_K, EMB_IDS, EMB_THREADS, EMB_BATCH, EMB_TOL = 8, 256, 8, 32, 1e-3
LMG_PROMPT, LMG_NEW, LMG_N, LMG_BATCH = 128, 32, 16, 8
# train-while-serving: 1024-token windows (the forward at 1024 keys, so
# the one-pass backward), 5 steps taken while 4 waves of requests are
# served (two during the first wave, one during each later one)
TWS_SEQ, TWS_BATCH, TWS_STEPS, TWS_WAVES = 1024, 8, 5, 4
SLO_TTFT_MS, SLO_ITL_MS = 2000.0, 50.0


def dev_sync() -> None:
    if DEV.type == "cuda":
        torch.cuda.synchronize()


def spec_trace(vocab: int):
    """tools/serving_bench.py:832-900's trace: motifs of 2-5 tokens tiled
    to 6-12, 48 + zipf(1.6) new tokens capped at 64, arrival offsets."""
    rng = np.random.default_rng(37)
    trace, t = [], 0.0
    for _ in range(SPEC_N):
        t += float(rng.exponential(0.002))
        motif = rng.integers(1, vocab, int(rng.integers(2, 6)))
        plen = int(rng.integers(6, SPEC_PROMPT + 1))
        prompt = np.tile(motif, -(-plen // len(motif)))[:plen]
        trace.append((t, prompt, int(min(SPEC_CAP, SPEC_MIN_NEW
                                         + rng.zipf(1.6)))))
    return trace


def quant_trace(vocab: int):
    """tools/serving_bench.py:721-800's trace: 4 zipf-chosen 64-token
    prefixes plus 1-8-token tails, 12 + zipf(1.6) new tokens capped at
    24, arrival offsets."""
    rng = np.random.default_rng(23)
    prefixes = [rng.integers(1, vocab, QKV_PREFIX) for _ in range(4)]
    trace, t = [], 0.0
    for _ in range(QKV_N):
        t += float(rng.exponential(0.002))
        head = prefixes[min(int(rng.zipf(1.8)) - 1, len(prefixes) - 1)]
        tail = rng.integers(1, vocab, int(rng.integers(1, QKV_TAIL + 1)))
        trace.append((t, np.concatenate([head, tail]),
                      int(min(QKV_CAP, QKV_MIN_NEW + rng.zipf(1.6)))))
    return trace


def play(srv, name, trace):
    """Submit a trace at its arrival offsets; (outputs, wall seconds)."""
    dev_sync()
    t0 = time.perf_counter()
    futs = []
    for t, prompt, n_new in trace:
        lag = t - (time.perf_counter() - t0)
        if lag > 0:
            time.sleep(lag)
        futs.append(srv.submit(name, {"prompt": prompt, "max_new": n_new}))
    outs = [np.asarray(f.result(timeout=600)["result"]) for f in futs]
    dev_sync()
    return outs, time.perf_counter() - t0


def argmax_match(a, b) -> float:
    """Token agreement over the longer length (the JAX quant metric)."""
    n, m = min(a.size, b.size), max(a.size, b.size)
    return float((a[:n] == b[:n]).sum()) / m if m else 1.0


def median_step_ms(eng, verify=None) -> float:
    """Median fused-step ms of an engine's recorded iterations; with
    ``verify`` True/False only those that ran (did not run) a window."""
    recs = [r for r in eng.recorder.records() if r["step_ms"] > 0
            and (verify is None or (r["spec_proposed"] > 0) == verify)]
    return float(np.median([r["step_ms"] for r in recs])) if recs else 0.0


def near_tie_check(ref_cfg, params, label, prompts, got, ref):
    """Every output of ``got`` equals ``ref`` or first differs where
    ref's top-2 gap is under phase 10's bf16 bound; returns the count of
    exact outputs and prints each divergence."""
    exact = 0
    for i, (g, r) in enumerate(zip(got, ref)):
        if np.array_equal(g, r):
            exact += 1
            continue
        ok, (j, gap, bound) = divergence_allowed(ref_cfg, params,
                                                 prompts[i], g, r)
        say(f"{label}: request {i} first differs at token {j}: top-2 gap "
            f"{gap:.5f}, bound {bound:.5f}")
        if not ok:
            fail(f"{label}: request {i} diverges at token {j} where the "
                 f"top-2 gap {gap:.5f} >= bound {bound:.5f}")
    return exact


def write_path_check(eng, cfg, params, blocks, seq, n_prompt,
                     perturb=None):
    """Layer 0's K/V rows depend only on tokens and positions. For every
    position ``p`` the request wrote (``seq[p]``, its blocks ``blocks``),
    the row from the engine's own bf16 layer-0 inputs as an f32 product,
    against the int8 pool's dequantized row: each element within
    ``s (1 + n) / 2 + 2^-8 |row| + 2 D 2^-24 (|x| |w|)``, where ``s`` is
    the block's final scale, ``n`` the writes into the block after the
    row's (each may grow the scale and re-round the row once; prompt rows
    of a block come in one chunk, every later position in its own step),
    ``2^-8 |row|`` the engine's bf16 rounding of its product and the last
    term the two f32 sums' order. ``perturb`` (block, factor) scales one
    block's layer-0 scales first: the negative control. Returns (worst
    excess over the bound, elements checked)."""
    from multiverso_tpu_torch.models import transformer as tf

    Bs = eng._block_size
    P = len(seq)
    toks = torch.from_numpy(np.asarray(seq, np.int64)).to(DEV)
    pos = torch.arange(P, device=DEV)
    layer = tf._layers(params)[0]
    h = params["embed"][toks] + params["pos"][pos]
    x = tf._rmsnorm(h, layer["ln1_g"])
    D = x.shape[-1]
    blk = torch.tensor([blocks[p // Bs] for p in range(P)], device=DEV)
    off = pos % Bs
    # writes into a row's block after the row: decode positions only
    later = np.zeros(P)
    for p in range(P):
        end = min(P, (p // Bs + 1) * Bs)
        later[p] = max(0, end - max(p + 1, n_prompt))
    later = torch.from_numpy(later).to(DEV, torch.float32)[:, None]
    worst, n = -float("inf"), 0
    for name, pool, scales in (("w_k", eng._k_cache, eng._k_scales),
                               ("w_v", eng._v_cache, eng._v_scales)):
        w = layer[name]
        row = x.float() @ w.float()
        order = 2 * D * 2.0 ** -24 * (x.float().abs() @ w.float().abs())
        s = scales[0, blk].clone()
        if perturb is not None:
            s = torch.where(blk == perturb[0], s * perturb[1], s)
        deq = pool[0, blk, off].float() * s[:, None]
        bound = (s[:, None] * (1 + later) / 2 + BF16_U * row.abs()
                 + order)
        worst = max(worst, float(((deq - row).abs() - bound).max()))
        n += row.numel()
    return worst, n


def phase_serving_surface(card: str, base_prompts):
    """11. The single-card serving surface on the flagship of phase 3
    (bf16, seed 0, attention="flash_force"), each sub-phase's numbers
    on lines of their own with the card's name and power limit:

    a. speculation A/B on tools/serving_bench.py's repetitive-tail trace
       (24 requests, 2 slots, max_prompt 12, max_new 64, block 8, chunks
       of 12): spec_k 4 against 0; tokens must equal the spec_k=0 run's
       under phase 10's near-tie rule (with its negative control), and
       the verify program keeps one signature;
    b. int8 KV against bf16 at equal pool bytes (23 bf16 blocks of 8) on
       the bench's shared-prefix trace (48 requests, 24 slots): blocks,
       peak live sequences, tokens/s, the argmax-match rate (at least
       QUANT_MATCH_FLOOR, the JAX package's 0.7); then one
       more request whose layer-0 K/V rows in the int8 pool are held to
       the write path's bound (``write_path_check``), and the same check
       with one block's scales perturbed must fail;
    c. int8 parameter pins on (a)'s trace (spec_k 0): one pin copy, the
       resident bytes, the per-call dequantization ms, the match rate
       (at least the floor); then spec_k 4, int8 KV, int8 pins and both
       SLOs on one engine, its match rate held to the same floor;
    d. the micro-batcher: EmbeddingNeighbors (k 8) over a [71291, 200]
       bf16 table, 256 ids from 8 threads at max_batch 32, each reply
       against an independent f32 matmul + topk on the card (scores
       within 1e-3, ids equal wherever the neighbouring scores differ by
       more), the query rows through the row gather kernel; then
       LMGreedyDecode (max_prompt 128, max_new 32, 16 requests, batches
       of up to 8) through the flash kernel, each flush's replies held
       to greedy_decode through plain attention on the same padded batch
       under the near-tie rule (phase 2 holds the kernel itself against
       plain at this prefill's shape, B 8 x S 128);
    e. train-while-serving: train_batch on phase 9's corpus (8 windows
       of 1024 tokens, lr 0.003, 5 steps) while phase 10's configuration
       A serves its prompts in 4 waves, the steps taken while a wave is
       served (two in the first, one in each later one) and each wave
       submitted once the steps before it are done (max_staleness_s 0,
       so the pin moves at each drain and every later wave serves a new
       version); each reply
       within the near-tie rule of greedy_decode on the snapshot of the
       version it reports, through the one-pass backward kernel;
    f. the SLO rows of Dashboard.snapshot() for (e)'s engine
       (slo_ttft_ms 2000, slo_itl_ms 50).

    Returns the launches of the kernels this phase ran, by kernel."""
    import threading

    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.apps import lm as app
    from multiverso_tpu_torch.dashboard import Dashboard
    from multiverso_tpu_torch.models import transformer as tf
    from multiverso_tpu_torch.ops import embedding as emb_ops
    from multiverso_tpu_torch.serving import (EmbeddingNeighbors,
                                              InferenceServer,
                                              LMGreedyDecode)
    from multiverso_tpu_torch.serving.block_pool import (blocks_for_bytes,
                                                         kv_bytes_per_block)

    fa = _fa()
    _CARD[:] = [card]
    mv.init(["chip_smoke", f"-device={DEV.type}"])
    cfg = tf.TransformerConfig(**FLAGSHIP, dtype=torch.bfloat16,
                               attention="flash_force",
                               learning_rate=LM_LR, momentum=0.9)
    ref_cfg = tf.TransformerConfig(**FLAGSHIP, dtype=torch.bfloat16,
                                   attention="reference")
    lm = tf.TransformerLM(cfg)
    params, _ = lm.snapshot_params()
    vocab = cfg.vocab_size
    srv = InferenceServer("chip_smoke_surface")
    launches = {}

    # -- a. speculation -----------------------------------------------------
    trace = spec_trace(vocab)
    prompts = [p for _, p, _ in trace]
    useful = sum(n for _, _, n in trace)
    spec = {}
    for label, k in (("spec", SPEC_K), ("base", 0)):
        eng = srv.register_decoder(
            f"lm_spec_{label}", lm, slots=SPEC_SLOTS, max_prompt=SPEC_PROMPT,
            max_new=SPEC_CAP, prompt_buckets=(SPEC_PROMPT,),
            kv_block_size=SPEC_BLOCK, prefill_token_budget=SPEC_PROMPT,
            spec_k=k, max_queue=64)
        eng.warmup()
        eng.reset_stats()
        outs, wall = play(srv, f"lm_spec_{label}", trace)
        spec[label] = dict(eng=eng, outs=outs, wall=wall, st=eng.stats())
    s_st, b_st = spec["spec"]["st"], spec["base"]["st"]
    tps = {k: useful / v["wall"] for k, v in spec.items()}
    verify_ms = median_step_ms(spec["spec"]["eng"], verify=True)
    step_ms = median_step_ms(spec["base"]["eng"])
    say(f"surface a (speculation, spec_k {SPEC_K} vs 0, {SPEC_N} requests, "
        f"{useful} tokens, {SPEC_SLOTS} slots): {tps['spec']:.1f} vs "
        f"{tps['base']:.1f} tok/s = {tps['spec'] / tps['base']:.3f}x; "
        f"acceptance {s_st['acceptance_rate']:.3f}, accepted per step "
        f"{s_st['accepted_per_step']:.3f}, verify steps "
        f"{s_st['spec_steps']}; median verify {verify_ms:.3f} ms vs "
        f"median plain step {step_ms:.3f} ms; verify_traces "
        f"{s_st['verify_traces']}, step_traces {s_st['step_traces']}/"
        f"{b_st['step_traces']}; ITL p50 {s_st['itl_p50_ms']:.2f} vs "
        f"{b_st['itl_p50_ms']:.2f} ms; card {card_line()}")
    if s_st["verify_traces"] != 1 or s_st["step_traces"] > 1 \
            or b_st["step_traces"] != 1 or s_st["spec_accepted"] <= 0:
        fail(f"surface a: verify_traces {s_st['verify_traces']}, "
             f"step_traces {s_st['step_traces']}/{b_st['step_traces']}, "
             f"accepted {s_st['spec_accepted']}")
    for out, (_, p, n) in zip(spec["spec"]["outs"], trace):
        if out.shape != (n,) or out.min() < 0 or out.max() >= vocab:
            fail(f"surface a: an output of the wrong shape or range")
    exact = near_tie_check(ref_cfg, params, "surface a", prompts,
                           spec["spec"]["outs"], spec["base"]["outs"])
    say(f"surface a: {exact}/{SPEC_N} spec outputs token-identical to "
        f"spec_k=0, the rest within the near-tie bound")
    # negative control: a divergence at the baseline's widest margin
    ref0 = spec["base"]["outs"][0]
    gap, bound = top2_gaps(ref_cfg, params, prompts[0], ref0)
    j = int(np.argmax(gap / bound))
    fake = ref0.copy()
    fake[j] = (fake[j] + 1) % vocab
    if gap[j] < bound[j] or divergence_allowed(ref_cfg, params, prompts[0],
                                               fake, ref0)[0]:
        fail("surface a: the near-tie negative control passed")
    say(f"surface a negative control: a divergence at token {j}, gap "
        f"{gap[j]:.5f} against bound {bound[j]:.5f}, fails the check")
    base_outs = spec["base"]["outs"]

    # -- b. int8 KV at equal bytes ---------------------------------------------
    qtrace = quant_trace(vocab)
    qprompts = [p for _, p, _ in qtrace]
    q_useful = sum(n for _, _, n in qtrace)
    L, D = cfg.n_layers, cfg.d_model
    budget = QKV_FP_BLOCKS * kv_bytes_per_block(L, D, QKV_BLOCK, cfg.dtype)
    qmax_prompt = QKV_PREFIX + QKV_TAIL
    qkv = {}
    for label, quant in (("bf16", "none"), ("int8", "int8")):
        blocks = blocks_for_bytes(budget, L, D, QKV_BLOCK, cfg.dtype,
                                  quant=quant)
        eng = srv.register_decoder(
            f"lm_qkv_{label}", lm, slots=QKV_SLOTS, max_prompt=qmax_prompt,
            max_new=QKV_CAP, prompt_buckets=(qmax_prompt,),
            kv_block_size=QKV_BLOCK, kv_pool_blocks=blocks,
            prefill_token_budget=32, kv_quant=quant, max_queue=64)
        eng.warmup()
        eng.reset_stats()
        outs, wall = play(srv, f"lm_qkv_{label}", qtrace)
        qkv[label] = dict(eng=eng, outs=outs, wall=wall, st=eng.stats(),
                          blocks=blocks)
    rate = float(np.mean([argmax_match(a, b) for a, b in
                          zip(qkv["bf16"]["outs"], qkv["int8"]["outs"])]))
    qkv["int8"]["eng"].record_argmax_match(rate)
    q_st, f_st = qkv["int8"]["eng"].stats(), qkv["bf16"]["st"]
    say(f"surface b (int8 KV at {budget} pool bytes, {QKV_N} requests, "
        f"{q_useful} tokens): blocks {qkv['int8']['blocks']} vs "
        f"{qkv['bf16']['blocks']}, peak live {q_st['peak_live_seqs']} vs "
        f"{f_st['peak_live_seqs']}, {q_useful / qkv['int8']['wall']:.1f} vs "
        f"{q_useful / qkv['bf16']['wall']:.1f} tok/s, argmax match "
        f"{rate:.4f}, median step {median_step_ms(qkv['int8']['eng']):.3f} "
        f"vs {median_step_ms(qkv['bf16']['eng']):.3f} ms, "
        f"preemptions {q_st['preemptions']} vs {f_st['preemptions']}, "
        f"written blocks {q_st['quant_scale_blocks']}, step_traces "
        f"{q_st['step_traces']}, prefill_traces {q_st['prefill_traces']}; "
        f"card {card_line()}")
    if rate < QUANT_MATCH_FLOOR:
        fail(f"surface b: int8 KV argmax match {rate:.4f} under the "
             f"{QUANT_MATCH_FLOOR} floor")
    if q_st["step_traces"] != 1 or q_st["prefill_traces"] != 1 \
            or q_st["quant_scale_blocks"] <= 0 \
            or any(o.min() < 0 or o.max() >= vocab
                   for o in qkv["int8"]["outs"]):
        fail(f"surface b: {q_st}")
    # the write path: one more request, alone, its blocks kept in view
    eng = qkv["int8"]["eng"]
    seen = {}
    release = eng._release_seq

    def keep_blocks(req):
        seen.setdefault("blocks", list(req.blocks))
        release(req)

    eng._release_seq = keep_blocks
    rng = np.random.default_rng(41)
    probe = rng.integers(1, vocab, qmax_prompt)
    out = np.asarray(srv.submit(f"lm_qkv_int8", {
        "prompt": probe, "max_new": QKV_CAP}).result(timeout=600)["result"])
    eng._release_seq = release
    dev_sync()
    seq = np.concatenate([probe, out[:-1]])
    worst, n = write_path_check(eng, cfg, params, seen["blocks"], seq,
                                len(probe))
    if worst > 0:
        fail(f"surface b: an int8 K/V row exceeds the write-path bound by "
             f"{worst:.6g}")
    bad, _ = write_path_check(eng, cfg, params, seen["blocks"], seq,
                              len(probe),
                              perturb=(seen["blocks"][1], 1.5))
    if bad <= 0:
        fail("surface b: the write-path check passed a perturbed scale")
    say(f"surface b write path: {n} layer-0 K/V elements of "
        f"{len(seq)} positions within the bound (worst excess "
        f"{worst:.6g}); block {seen['blocks'][1]}'s scales x 1.5 exceeds "
        f"it by {bad:.6g}")

    # -- c. int8 parameter pins --------------------------------------------------
    eng = srv.register_decoder(
        "lm_pq", lm, slots=SPEC_SLOTS, max_prompt=SPEC_PROMPT,
        max_new=SPEC_CAP, prompt_buckets=(SPEC_PROMPT,),
        kv_block_size=SPEC_BLOCK, prefill_token_budget=SPEC_PROMPT,
        decode_param_quant="int8", max_queue=64)
    eng.warmup()
    eng.reset_stats()
    pq_outs, pq_wall = play(srv, "lm_pq", trace)
    pq_st = eng.stats()
    pinned = eng._pinned
    leaves = [t for v in pinned.values()
              for t in ((v,) if "q" in v else v.values())]
    q_bytes = sum(t["q"].nbytes + t["s"].nbytes for t in leaves)
    p_bytes = sum(t.nbytes for t in tf._leaves(params))
    deq_ms = time_ms(lambda: tf.dequantize_decode_params(pinned, cfg.dtype)) \
        if DEV.type == "cuda" else 0.0
    pq_rate = float(np.mean([argmax_match(a, b)
                             for a, b in zip(pq_outs, base_outs)]))
    say(f"surface c (int8 parameter pins on a's trace, spec_k 0): "
        f"pin_copies {pq_st['pin_copies']}, resident parameters {q_bytes} "
        f"bytes int8 + scales vs {p_bytes} bf16, dequantization "
        f"{deq_ms:.4f} ms a call, median step "
        f"{median_step_ms(eng):.3f} ms vs {step_ms:.3f} bf16, "
        f"{useful / pq_wall:.1f} tok/s, argmax match vs a's spec_k=0 run "
        f"{pq_rate:.4f}; card {card_line()}")
    if pq_st["pin_copies"] != 1 or pq_st["step_traces"] != 1 \
            or q_bytes >= p_bytes or pq_rate < QUANT_MATCH_FLOOR:
        fail(f"surface c: {pq_st}")
    # all of slice 8's engine features on one engine, on (a)'s trace
    eng = srv.register_decoder(
        "lm_all", lm, slots=SPEC_SLOTS, max_prompt=SPEC_PROMPT,
        max_new=SPEC_CAP, prompt_buckets=(SPEC_PROMPT,),
        kv_block_size=SPEC_BLOCK, prefill_token_budget=SPEC_PROMPT,
        spec_k=SPEC_K, kv_quant="int8", decode_param_quant="int8",
        slo_ttft_ms=SLO_TTFT_MS, slo_itl_ms=SLO_ITL_MS, max_queue=64)
    eng.warmup()
    eng.reset_stats()
    all_outs, all_wall = play(srv, "lm_all", trace)
    all_st = eng.stats()
    all_rate = float(np.mean([argmax_match(a, b)
                              for a, b in zip(all_outs, base_outs)]))
    say(f"surface c (spec_k {SPEC_K}, int8 KV, int8 pins and both SLOs on "
        f"one engine, a's trace): {useful / all_wall:.1f} tok/s, "
        f"acceptance {all_st['acceptance_rate']:.3f}, accepted per step "
        f"{all_st['accepted_per_step']:.3f}, median verify "
        f"{median_step_ms(eng, verify=True):.3f} ms, argmax match vs a's "
        f"spec_k=0 run {all_rate:.4f}, verify_traces "
        f"{all_st['verify_traces']}, step_traces {all_st['step_traces']}, "
        f"pin_copies {all_st['pin_copies']}; card {card_line()}")
    if all_st["verify_traces"] != 1 or all_st["step_traces"] > 1 \
            or all_st["spec_steps"] <= 0 or all_st["pin_copies"] != 1 \
            or all_rate < QUANT_MATCH_FLOOR \
            or any(o.min() < 0 or o.max() >= vocab for o in all_outs):
        fail(f"surface c, all features: {all_st}")

    # -- d. the micro-batcher --------------------------------------------------
    table = mv.create_table("matrix", W2V_VOCAB, W2V_DIM,
                            init_value="random", dtype=torch.bfloat16,
                            seed=0)
    work = EmbeddingNeighbors(table, k=EMB_K)
    srv.register("w2v", work, max_batch=EMB_BATCH)
    ids = np.random.default_rng(43).integers(0, W2V_VOCAB, EMB_IDS)
    replies = [None] * EMB_IDS
    srv.predict("w2v", 0, timeout_s=600)   # warm: the normalized table
    n_warm = len(srv._entry("w2v").batcher.flushes)
    dev_sync()
    emb_ops.reset_launches()

    def client(lo):
        futs = [(i, srv.submit("w2v", int(ids[i])))
                for i in range(lo, EMB_IDS, EMB_THREADS)]
        for i, f in futs:
            replies[i] = f.result(timeout=600)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(EMB_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    emb_wall = time.perf_counter() - t0
    gathers = emb_ops.LAUNCHES["row_gather"]
    e = table.array.float()
    normed = e / e.norm(dim=1, keepdim=True).clamp(min=1e-12)
    q_ids = torch.from_numpy(ids).to(DEV)
    sims = normed[q_ids] @ normed.t()
    sims[torch.arange(EMB_IDS, device=DEV), q_ids] = -float("inf")
    ref = sims.topk(EMB_K + 1, dim=-1)
    ref_s, ref_i = ref.values.cpu().numpy(), ref.indices.cpu().numpy()
    worst_s, checked = 0.0, 0
    for i, rep in enumerate(replies):
        got_i, got_s = rep["result"]
        worst_s = max(worst_s, float(np.abs(got_s - ref_s[i, :EMB_K]).max()))
        for j in range(EMB_K):
            lo_gap = ref_s[i, j] - ref_s[i, j + 1]
            hi_gap = ref_s[i, j - 1] - ref_s[i, j] if j else np.inf
            if min(lo_gap, hi_gap) > EMB_TOL:
                checked += 1
                if got_i[j] != ref_i[i, j]:
                    fail(f"surface d: id {ids[i]} neighbour {j} is "
                         f"{got_i[j]}, the reference's {ref_i[i, j]}")
    flushes = list(srv._entry("w2v").batcher.flushes)[n_warm:]
    say(f"surface d (EmbeddingNeighbors k {EMB_K}, [{W2V_VOCAB}, "
        f"{W2V_DIM}] bf16 table, {EMB_IDS} ids from {EMB_THREADS} threads, "
        f"max_batch {EMB_BATCH}): {len(flushes)} flushes (sizes "
        f"{sorted(n for n, _, _ in flushes)}), signatures "
        f"{work.jit_cache_size()} (the warm call's bucket 1 included), "
        f"{EMB_IDS / emb_wall:.1f} replies/s, "
        f"max |score - reference| {worst_s:.3g} (limit {EMB_TOL}), "
        f"{checked} separated ids equal, row_gather launches {gathers}; "
        f"card {card_line()}")
    # on the CPU (a rehearsal) the wrappers take their plain versions,
    # which count no launch
    on_card = DEV.type == "cuda"
    if worst_s > EMB_TOL or (on_card and gathers <= 0):
        fail(f"surface d: score error {worst_s}, row_gather launches "
             f"{gathers}")
    launches["row_gather"] = gathers

    lmg = LMGreedyDecode(lm, max_prompt=LMG_PROMPT, max_new=LMG_NEW)
    batches = []
    run = lmg.run

    def run_seen(payloads, bucket, snap):
        out = run(payloads, bucket, snap)
        batches.append((list(payloads), bucket, snap.value, out))
        return out

    srv.register("lm_batch", lmg, max_batch=LMG_BATCH, deadline_ms=5.0)
    srv.predict("lm_batch", np.arange(1, 9), timeout_s=600)   # warm
    lmg.run = run_seen
    rng = np.random.default_rng(47)
    lmg_prompts = [rng.integers(0, vocab, int(n))
                   for n in rng.integers(1, LMG_PROMPT + 1, LMG_N)]
    dev_sync()
    fa.reset_launches()
    t0 = time.perf_counter()
    futs = [srv.submit("lm_batch", p) for p in lmg_prompts]
    lmg_outs = [np.asarray(f.result(timeout=600)["result"]) for f in futs]
    dev_sync()
    lmg_wall = time.perf_counter() - t0
    # the serving run's launches, before the oracle below adds its own
    flash = dict(fa.LAUNCHES_BY_KEY_LEN)
    launches["flash_fwd"] = fa.LAUNCHES
    # the oracle: greedy_decode through plain attention (ref_cfg) on the
    # same padded batch, so the flash prefill is held to the plain one
    same = checked = 0
    for payloads, bucket, value, outs in batches:
        host = np.zeros((bucket, LMG_PROMPT), np.int64)
        lens = np.ones(bucket, np.int64)
        for i, p in enumerate(payloads):
            host[i, : len(p)] = p
            lens[i] = len(p)
        want = tf.greedy_decode(ref_cfg, value,
                                torch.from_numpy(host).to(DEV),
                                torch.from_numpy(lens).to(DEV), LMG_NEW)
        want = want.cpu().numpy()
        for i, got in enumerate(outs):
            got = np.asarray(got)
            checked += 1
            if np.array_equal(got, want[i]):
                same += 1
                continue
            ok, (j, gap, bound) = divergence_allowed(
                ref_cfg, value, np.asarray(payloads[i]), got, want[i])
            say(f"surface d: LMGreedyDecode row {i} of bucket {bucket} "
                f"first differs from plain greedy_decode at token {j}: "
                f"top-2 gap {gap:.5f}, bound {bound:.5f}")
            if not ok:
                fail(f"surface d: LMGreedyDecode row {i} of bucket {bucket} "
                     f"diverges at token {j} where the top-2 gap {gap:.5f} "
                     f">= bound {bound:.5f}")
    say(f"surface d (LMGreedyDecode flash_force, max_prompt {LMG_PROMPT}, "
        f"max_new {LMG_NEW}, {LMG_N} requests): {len(batches)} flushes "
        f"(buckets {[b for _, b, _, _ in batches]}), {same}/{LMG_N} replies "
        f"token-identical to greedy_decode through plain attention on the "
        f"same padded batch (the rest within the near-tie bound), "
        f"{LMG_N * LMG_NEW / lmg_wall:.1f} tok/s, signatures "
        f"{lmg.jit_cache_size()} (the warm call's bucket 1 included), "
        f"flash launches {launches['flash_fwd']} (by key len "
        f"{json.dumps(flash, sort_keys=True)}); card {card_line()}")
    if checked != LMG_N or (on_card and launches["flash_fwd"] <= 0) \
            or len(lmg_outs) != LMG_N:
        fail(f"surface d: {checked}/{LMG_N} replies checked, flash launches "
             f"{launches['flash_fwd']}")

    # -- e. train-while-serving, f. the SLOs --------------------------------------
    prompts_e, prios, _ = default_traffic(base_prompts, vocab)
    eng = srv.register_decoder(
        "lm_tws", lm, slots=SLOTS, max_prompt=MAX_PROMPT, max_new=MAX_NEW,
        max_staleness_s=0.0, slo_ttft_ms=SLO_TTFT_MS, slo_itl_ms=SLO_ITL_MS)
    published = {}
    publish = eng._manager.publish

    def publish_seen():
        snap = publish()
        published[snap.version] = snap.value
        return snap

    eng._manager.publish = publish_seen
    eng.warmup()
    data = app.load_bytes(lm_corpus())
    gen = app.batches(data, TWS_BATCH, TWS_SEQ - 1, seed=0)
    losses = []
    # each wave lets the trainer take its steps while the wave is served
    # (two in the first, one in each later one) and starts only once
    # they are done, so every wave after the first pins a new version
    go = threading.Semaphore(0)
    stepped = threading.Condition()

    def trainer():
        for _ in range(TWS_STEPS):
            go.acquire()
            loss = float(lm.train_batch(next(gen)))
            with stepped:
                losses.append(loss)
                stepped.notify_all()

    dev_sync()
    fa.reset_launches()
    t0 = time.perf_counter()
    tr = threading.Thread(target=trainer)
    tr.start()
    replies = []
    waves = np.array_split(np.arange(len(prompts_e)), TWS_WAVES)
    steps_by = np.cumsum([TWS_STEPS - TWS_WAVES + 1]
                         + [1] * (TWS_WAVES - 1))
    released = 0
    for wave, n_steps in zip(waves, steps_by):
        futs = [srv.submit("lm_tws", {"prompt": prompts_e[i],
                                      "max_new": MAX_NEW,
                                      "priority": int(prios[i])})
                for i in wave]
        while released < n_steps:
            go.release()
            released += 1
        replies += [f.result(timeout=600) for f in futs]
        with stepped:
            stepped.wait_for(lambda: len(losses) >= n_steps, timeout=600)
    tr.join(timeout=600)
    dev_sync()
    tws_wall = time.perf_counter() - t0
    bwd = dict(fa.BWD_LAUNCHES)
    launches["flash_bwd_fused"] = bwd["fused"]
    versions = [rep["snapshot_version"] for rep in replies]
    exact = 0
    for i, rep in enumerate(replies):
        v = rep["snapshot_version"]
        if v not in published:
            fail(f"surface e: reply {i} reports version {v}, never pinned")
        p = prompts_e[i]
        want = tf.greedy_decode(
            cfg, published[v], torch.from_numpy(p[None]).to(DEV),
            torch.tensor([len(p)], device=DEV), MAX_NEW)[0].cpu().numpy()
        got = np.asarray(rep["result"])
        if np.array_equal(got, want):
            exact += 1
            continue
        ok, (j, gap, bound) = divergence_allowed(ref_cfg, published[v], p,
                                                 got, want)
        say(f"surface e: request {i} (version {v}) first differs from "
            f"greedy_decode at token {j}: gap {gap:.5f}, bound {bound:.5f}")
        if not ok:
            fail(f"surface e: request {i} diverges at token {j} where the "
                 f"top-2 gap {gap:.5f} >= bound {bound:.5f}")
    st = eng.stats()
    say(f"surface e (train-while-serving: {TWS_STEPS} train_batch steps of "
        f"{TWS_BATCH} x {TWS_SEQ} tokens, losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}, while {len(replies)} "
        f"requests in {TWS_WAVES} waves were served): {tws_wall:.3f} s, "
        f"versions served {dict(sorted(collections.Counter(versions).items()))}"
        f", pin copies {st['pin_copies']}, publishes "
        f"{st['snapshot_publishes']}, {exact}/{len(replies)} "
        f"token-identical to greedy_decode on their version (the rest "
        f"within the near-tie bound), backward launches {json.dumps(bwd)}; "
        f"card {card_line()}")
    if len(losses) != TWS_STEPS or not np.all(np.isfinite(losses)) \
            or (on_card and bwd["fused"] <= 0) or len(set(versions)) < 2:
        fail(f"surface e: losses {losses}, backward {bwd}, versions "
             f"{sorted(set(versions))}")
    rows = {k: v for k, v in Dashboard.snapshot().items()
            if v["type"] == "slo"}
    for name, row in sorted(rows.items()):
        say(f"surface f: {name} {json.dumps(row, sort_keys=True)}; card "
            f"{card_line()}")
    want_rows = {f"SLO_P99[SERVE_{kind}[{name}]]" for kind in ("TTFT", "ITL")
                 for name in ("lm_tws", "lm_all")}
    if not want_rows <= set(rows) or any(rows[r]["window"] <= 0
                                         for r in want_rows):
        fail(f"surface f: SLO rows {sorted(rows)}")
    srv.stop()
    table = work = None
    mv.shutdown()
    del lm, params, published
    if DEV.type == "cuda":
        torch.cuda.empty_cache()
    return launches


# phase 13: the serving fleet on one card
FLEET_NEW = 32            # max_new of every fleet engine
FLEET_N, FLEET_SESSIONS = 24, 6
FLEET_TENANTS = ("t0", "t1", "t2")
FLEET_KILL = "kill_at_request=3"
FLEET_DROP = "kv_xfer_drop=2"
# (a)'s heartbeat interval; a replica is DEAD after two silent beats. At
# the flag's default, 100 ms, a healthy replica's oldest beat reached
# 78.9-126.3 ms on an H100 host, where three engines, the router and the
# wire share one interpreter and the host's load moved the fleet's tokens/s
# 2.3x between runs; 250 ms keeps a false death out of a slower host's reach
FLEET_HB_MS = 250
# (b)'s interval. Each transfer crosses the wire as one JSON record of
# base64 blocks (the JAX package's format), up to 76 MB for a 1536-token
# prompt at this width, and json/base64 hold the GIL for the whole
# record on the replica, the router (decode, re-encode) and the decode
# replica: at 100 ms a healthy replica's beats went quiet past 200 ms and
# the router flagged it DEAD in a fault-free leg
FLEET_HB_MS_XFER = 1000
# the fleet's contiguous engines: phase 3's layout with the ledger on
FLEET_MONO = dict(slots=SLOTS, max_prompt=MAX_PROMPT, max_new=FLEET_NEW,
                  prompt_buckets=BUCKETS, prefill_token_budget=0,
                  kv_block_size=0, prefix_cache=False, preempt=False,
                  spec_k=0, kv_quant="none", decode_param_quant="none",
                  flight_recorder=False, watchdog=False, cost_ledger=True)
# the disaggregated leg's engines: the JAX defaults with the ledger on
FLEET_DEF = dict(slots=SLOTS, max_prompt=MAX_PROMPT, max_new=FLEET_NEW,
                 cost_ledger=True)


class FleetKV:
    """The KV client the mvserve wire uses (the JAX package's duck type:
    set, blocking get, try get) over an in-process dict."""

    def __init__(self):
        import threading

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


def fleet_up(label, kv, engines, roles, hb_ms, chaos=None):
    """A FleetRouter (rank 0) and one ReplicaServer per engine on the
    ``label`` wire, every replica UP with its role known to the router;
    ``chaos`` arms replica 1 with an in-process kill."""
    from multiverso_tpu_torch.serving import (FaultPlan, FleetConfig,
                                              FleetRouter, ReplicaServer)

    size = len(engines) + 1
    router = FleetRouter(size, kv, label=label, name=label,
                         fleet_config=FleetConfig(heartbeat_ms=hb_ms,
                                                  deadline_s=600.0))
    replicas = []
    try:
        for r, (eng, role) in enumerate(zip(engines, roles)):
            replicas.append(ReplicaServer(r + 1, size, kv, eng, label=label,
                                          heartbeat_ms=hb_ms, role=role))
        if chaos:
            replicas[0].chaos = FaultPlan(chaos, kill_fn=replicas[0].die)
        deadline = time.monotonic() + 60
        while not (router.stats()["up"] == len(engines) and [
                r["role"] for r in router.replica_rows()] == list(roles)):
            if time.monotonic() > deadline:
                fail(f"fleet {label}: replicas not up: "
                     f"{router.replica_rows()}")
            time.sleep(0.01)
    except BaseException:
        fleet_down(router, replicas)
        raise
    return router, replicas


def fleet_down(router, replicas):
    router.stop()
    for rep in replicas:
        rep.stop(stop_engine=False)


def merged_p50(hists) -> float:
    """Nearest-rank p50 over the windows of several engines' histograms."""
    data = sorted(v for h in hists for v in h._window()[1])
    return data[min(len(data) - 1, int(round(0.5 * (len(data) - 1))))] \
        if data else 0.0


def fleet_leg(label, kv, engines, roles, prompts, hb_ms, chaos=None,
              sessions=True, after=None):
    """Serve ``prompts`` through a fleet of ``engines`` (max_new 32,
    tenants t0-t2 round-robin, sessions s0-s5 if ``sessions``); every
    request must resolve with nothing lost and no duplicate mismatch.
    ``after(router, replicas)`` runs before the fleet comes down. Returns
    the outputs, the router's stats and rows, the requests the router
    replayed after a death, wall seconds, tokens, TTFT and ITL p50, and
    the oldest heartbeat the router saw on a replica it never flagged."""
    for e in engines:
        e.reset_stats()
    router, replicas = fleet_up(label, kv, engines, roles, hb_ms, chaos)
    replayed = set()
    requeue, liveness = router._requeue_locked, router._check_liveness_locked
    hb_max = {}                 # rank -> the oldest beat seen while UP

    def requeue_seen(req, why, resolutions):
        if req.redispatched:
            replayed.add(id(req.future))
        requeue(req, why, resolutions)

    def liveness_seen(now, resolutions, sends):
        for r, rep in router._replicas.items():
            if rep.state == 3 and rep.last_hb is not None:   # UP
                hb_max[r] = max(hb_max.get(r, 0.0), now - rep.last_hb)
        liveness(now, resolutions, sends)

    router._requeue_locked = requeue_seen
    router._check_liveness_locked = liveness_seen
    try:
        dev_sync()
        t0 = time.perf_counter()
        done = {}
        futs = []
        for i, p in enumerate(prompts):
            f = router.submit(
                p, FLEET_NEW, session=f"s{i % FLEET_SESSIONS}" if sessions
                else None, tenant=FLEET_TENANTS[i % len(FLEET_TENANTS)])
            t_sub = time.perf_counter()
            f.add_done_callback(lambda f, i=i, t=t_sub: done.__setitem__(
                i, time.perf_counter() - t))
            futs.append(f)
        outs = [np.asarray(f.result(timeout=600)["result"]) for f in futs]
        dev_sync()
        wall = time.perf_counter() - t0
        st = router.stats()
        vocab = FLAGSHIP["vocab_size"]
        if any(o.shape != (FLEET_NEW,) or o.min() < 0 or o.max() >= vocab
               for o in outs):
            fail(f"fleet {label}: an output of the wrong shape or range")
        if (st["completed"] != len(prompts) or st["requests_lost"]
                or st["output_mismatches"] or st["failed"]):
            fail(f"fleet {label}: completed {st['completed']} of "
                 f"{len(prompts)}, lost {st['requests_lost']}, failed "
                 f"{st['failed']}, output mismatches "
                 f"{st['output_mismatches']}")
        res = {"outs": outs, "stats": st, "wall": wall,
               "tokens": sum(o.size for o in outs),
               "replayed": {i for i, f in enumerate(futs)
                            if id(f) in replayed},
               "lat_p50": 1e3 * float(np.median(list(done.values()))),
               # a killed replica ages toward the verdict before it is
               # flagged: only the replicas never flagged count
               "hb": (hb_ms, 1e3 * max(
                   [a for r, a in hb_max.items()
                    if router._replicas[r].deaths == 0] or [0.0])),
               "ttft_p50": merged_p50([e.ttft_hist for e in engines]),
               "itl_p50": merged_p50([e.itl_hist for e in engines])}
        if after is not None:
            after(router, replicas, res)
        res["rows"] = router.replica_rows()
    finally:
        fleet_down(router, replicas)
    return res


def fleet_say(label, res, extra=""):
    st = res["stats"]
    say(f"fleet {label}: {len(res['outs'])} requests, {res['tokens']} "
        f"tokens in {res['wall']:.3f} s = {res['tokens'] / res['wall']:.1f} "
        f"tok/s, request latency p50 {res['lat_p50']:.2f} ms (submit to "
        f"reply at the router), engine TTFT p50 {res['ttft_p50']:.2f} ms, "
        f"ITL p50 {res['itl_p50']:.2f} ms, deaths {st['deaths']}, "
        f"heartbeat every {res['hb'][0]} ms (oldest seen on a replica never "
        f"flagged {res['hb'][1]:.1f} ms, DEAD past {2 * res['hb'][0]} ms), "
        f"requests_lost "
        f"{st['requests_lost']}, output_mismatches "
        f"{st['output_mismatches']}, recovery_time_s "
        f"{st['recovery_time_s']}{extra}, card {card_line()}")


def fleet_ledgers(label, engines):
    """(c): each engine's ledger conserves (drift 0: the sums over its
    tenants equal its own prefill, decode and transfer counters) and
    bills only t0-t2."""
    for e in engines:
        st = e.stats()
        rows = e.ledger.tenants()
        if st["accounting_drift"] != 0 or not set(rows) <= set(
                FLEET_TENANTS):
            fail(f"fleet {label}: engine {e.name} drift "
                 f"{st['accounting_drift']}, tenants {sorted(rows)}")
        sums = {k: sum(r[k] for r in rows.values()) for k in (
            "prefill_tokens", "decode_tokens", "xfer_bytes", "requests")}
        say(f"fleet {label} ledger {e.name}: tenants "
            f"{json.dumps({t: round(r['cost'], 1) for t, r in sorted(rows.items())})}"
            f", sums {json.dumps(sums)} = engine prefill "
            f"{st['prefill_tokens']} decode {st['tokens']} transfer "
            f"{st.get('kv_bytes_moved', 0)}, residual "
            f"{st['accounting_drift']}")


def wait_tenant_rows(label, router, engines):
    """Heartbeat ``tenants`` rows reach ``replica_rows()``: each row must
    come to equal its engine's ledger's heartbeat rows."""
    deadline = time.monotonic() + 10
    while True:
        rows = router.replica_rows()
        want = [e.ledger.heartbeat_rows() for e in engines]
        if [r["tenants"] for r in rows] == want and all(want):
            return rows
        if time.monotonic() > deadline:
            fail(f"fleet {label}: replica_rows tenants "
                 f"{[r['tenants'] for r in rows]} != ledgers {want}")
        time.sleep(0.02)


def phase_fleet(card: str, base_prompts, oracle):
    """13. The serving fleet on one card: a FleetRouter front door over
    ReplicaServers on the real mvserve TCP wire (loopback, one process,
    an in-process KV), each replica its own TransformerLM of phase 3's
    flagship (bf16, seed 0: the same parameters), every engine's cost
    ledger on and requests tagged t0-t2 round-robin; a replica is DEAD
    after two silent heartbeat intervals: FLEET_HB_MS in (a),
    FLEET_HB_MS_XFER in (b), whose transfers hold the GIL for as long as
    a record takes to encode and decode.

    a. the unified fleet: 3 replicas in phase 3's layout (8 slots,
       max_prompt 1536, max_new 32, monolithic flash prefill, contiguous
       KV), 24 requests of phase 3's prompts in six sessions, fault-free
       and then the same trace with kill_at_request=3 on replica 1 (an
       in-process death, ReplicaServer.die). Both legs resolve every
       request with requests_lost 0 and output_mismatches 0; the chaos
       leg flags exactly one death, the fault-free leg none. The chaos
       leg equals the fault-free leg token for token, except that a
       replayed request may differ from a near-tie (phase 10's rule,
       whose negative control must fail it); every fault-free output is
       held to phase 3's oracle (its first 32 tokens) under the same
       rule. Replica 1 is then restarted over its engine: it must be
       readmitted through the half-open probe and serve a request. The
       flash kernel must have been launched by the fleet in both regimes.
    b. disaggregated prefill/decode against unified at the JAX defaults
       (chunks of 32, blocks of 16): one prefill + one decode replica
       against two unified ones on phase 10's trace (phase 3's prompts
       and six sharing a 512-token prefix). Outputs equal the unified
       leg's, except a request whose decode-side admission was a full
       hit (its last position recomputed by the step) or prefilled its
       tail from a spliced prefix off the 32-token chunk grid (other
       chunk shapes than the unified engine's): those may differ only
       from a near-tie. The router's kv_bytes_moved equals the shipped
       blocks x block_nbytes, and the prefill engine's the same; the
       decode engine dedups the shared prefix (dedup blocks > 0). Then
       the same with kv_xfer_drop=2 (both engines' caches flushed
       first): nothing lost, a transfer dropped, outputs under the same
       rule. Then an int8-KV prefill -> int8-KV decode pair on the
       shared-prefix prompts: a payload of int8 blocks with their scale
       columns, bytes = blocks x block_nbytes (scales counted), and the
       outputs' argmax match against the unified leg at least
       QUANT_MATCH_FLOOR.
    c. tenants, on (b)'s engines: each ledger's sums over its tenants
       equal the engine's counters (residual 0), and the heartbeat
       tenants rows reach router.replica_rows().

    Returns the fleet's flash launches by regime (all replicas)."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models import transformer as tf
    from multiverso_tpu_torch.serving import (DecodeEngine,
                                              DecodeEngineConfig,
                                              ReplicaServer)
    from multiverso_tpu_torch.serving import kv_transfer as kt

    import gc
    import threading

    fa = _fa()
    _CARD[:] = [card]
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    gc.collect()
    others = sorted(t.name for t in threading.enumerate()
                    if t is not threading.main_thread())
    say(f"fleet: host at the start: {len(gc.get_objects())} objects the "
        f"collector tracks (a full collection {time.perf_counter() - t0:.3f}"
        f" s), {len(others)} other threads {others[:8]}")
    mv.init(["chip_smoke", f"-device={DEV.type}", "-log_level=error"])
    cfg = tf.TransformerConfig(**FLAGSHIP, dtype=torch.bfloat16,
                               attention="flash_force")
    ref_cfg = tf.TransformerConfig(**FLAGSHIP, dtype=torch.bfloat16,
                                   attention="reference")
    lms = [tf.TransformerLM(cfg) for _ in range(4)]
    params, _ = lms[0].snapshot_params()
    for lm in lms[1:]:
        other, _ = lm.snapshot_params()
        if not all(torch.equal(a, b) for a, b in zip(
                tf._leaves(params), tf._leaves(other))):
            fail("fleet: the replicas' models hold different parameters")

    def build(name, lm, knobs):
        eng = DecodeEngine(name, lm, DecodeEngineConfig(**knobs))
        eng.warmup()
        return eng

    mono = [build(f"fleet_u{r}", lms[r], FLEET_MONO) for r in range(3)]
    uni = [build(f"fleet_du{r}", lms[r], FLEET_DEF) for r in range(2)]
    dis = [build("fleet_pf", lms[2], FLEET_DEF),
           build("fleet_dec", lms[3], FLEET_DEF)]
    q8 = [build(f"fleet_{n}8", lms[2 + i], {**FLEET_DEF, "kv_quant": "int8"})
          for i, n in enumerate(("pf", "dec"))]
    engines = mono + uni + dis + q8
    say(f"fleet: 4 models, {len(engines)} engines built and warm in "
        f"{time.perf_counter() - t_phase:.1f} s")
    kv = FleetKV()
    dev_sync()
    fa.reset_launches()
    try:
        launches = fleet_unified(kv, mono, base_prompts, oracle, ref_cfg,
                                 params, fa)
        fleet_disagg(kv, uni, dis, q8, base_prompts, ref_cfg, params, kt)
    finally:
        for e in engines:
            e.stop()
        mv.shutdown()
    say(f"fleet: phase 13 took {time.perf_counter() - t_phase:.1f} s, card "
        f"{card_line()}")
    return launches


def fleet_unified(kv, mono, base_prompts, oracle, ref_cfg, params, fa):
    """Phase 13 (a): the fault-free and chaos legs, the restart, and the
    flash launches of all of it."""
    from multiverso_tpu_torch.serving import ReplicaServer

    prompts = [base_prompts[i % len(base_prompts)] for i in range(FLEET_N)]
    roles = ("unified",) * len(mono)
    clean = fleet_leg("unified", kv, mono, roles, prompts, FLEET_HB_MS)
    fleet_say("(a) fault-free", clean)
    if clean["stats"]["deaths"]:
        fail(f"fleet (a): a healthy replica was flagged DEAD in the "
             f"fault-free leg: {clean['stats']}")
    restart = {}

    def restart_replica(router, replicas, res):
        """Restart replica 1 over its engine; it must come back through
        the half-open probe and serve a request."""
        t0 = time.perf_counter()
        replicas.append(ReplicaServer(1, len(mono) + 1, kv, mono[0],
                                      label="chaos",
                                      heartbeat_ms=FLEET_HB_MS))
        deadline = time.monotonic() + 60
        while True:
            row = router.replica_rows()[0]
            if row["readmissions"] >= 1 and row["state"] == "UP":
                break
            if time.monotonic() > deadline:
                fail(f"fleet (a): replica 1 not readmitted: "
                     f"{router.replica_rows()}")
            time.sleep(0.01)
        restart["readmit_s"] = time.perf_counter() - t0
        for _ in range(8):
            rep = router.predict(prompts[0], FLEET_NEW, timeout_s=600,
                                 tenant=FLEET_TENANTS[0])
            if rep["replica"] == 1:
                restart["out"] = np.asarray(rep["result"])
                break
        else:
            fail("fleet (a): the readmitted replica 1 served no request")

    chaos = fleet_leg("chaos", kv, mono, roles, prompts, FLEET_HB_MS,
                      chaos=FLEET_KILL, after=restart_replica)
    cs = chaos["stats"]
    if cs["deaths"] != 1 or cs["recovery_time_s"] is None:
        fail(f"fleet (a): the chaos leg flagged {cs['deaths']} deaths "
             f"(recovery {cs['recovery_time_s']})")
    exact = near = 0
    for i, (got, ref) in enumerate(zip(chaos["outs"], clean["outs"])):
        if np.array_equal(got, ref):
            exact += 1
            continue
        if i not in chaos["replayed"]:
            fail(f"fleet (a): request {i}, not replayed, differs from the "
                 f"fault-free leg at token {first_mismatch(got, ref)}")
        ok, (j, gap, bound) = divergence_allowed(ref_cfg, params,
                                                 prompts[i], got, ref)
        say(f"fleet (a): replayed request {i} first differs at token {j}: "
            f"top-2 gap {gap:.5f}, bound {bound:.5f}")
        if not ok:
            fail(f"fleet (a): replayed request {i} diverges at token {j} "
                 f"where the gap {gap:.5f} >= bound {bound:.5f}")
        near += 1
    # the rule's negative control: a divergence at the widest margin
    gap, bound = top2_gaps(ref_cfg, params, prompts[0], clean["outs"][0])
    j = int(np.argmax(gap / bound))
    fake = clean["outs"][0].copy()
    fake[j] = (fake[j] + 1) % FLAGSHIP["vocab_size"]
    if divergence_allowed(ref_cfg, params, prompts[0], fake,
                          clean["outs"][0])[0]:
        fail("fleet (a): negative control: a divergence at a wide gap "
             "passed")
    ok, _ = divergence_allowed(ref_cfg, params, prompts[0], restart["out"],
                               clean["outs"][0])
    if not ok:
        fail("fleet (a): the readmitted replica's reply diverges beyond "
             "the near-tie rule")
    fleet_say("(a) chaos", chaos, f", replayed {len(chaos['replayed'])} "
              f"requests ({exact}/{len(prompts)} token-identical to the "
              f"fault-free leg, {near} within the near-tie rule), negative "
              f"control fails, replica 1 readmitted through the probe in "
              f"{restart['readmit_s']:.3f} s and served a request")
    same = near_tie_check(ref_cfg, params, "fleet (a) vs phase 3's oracle",
                          prompts, clean["outs"],
                          [oracle[i % len(oracle)][:FLEET_NEW]
                           for i in range(FLEET_N)])
    say(f"fleet (a) vs phase 3's greedy_decode oracle: {same}/{FLEET_N} "
        f"token-identical, the rest within the near-tie rule")
    dev_sync()
    by_len = dict(fa.LAUNCHES_BY_KEY_LEN)
    launches = {"short": sum(n for sk, n in by_len.items() if sk <= 1024),
                "long": sum(n for sk, n in by_len.items() if sk > 1024)}
    say(f"fleet (a) flash launches (both legs and the restart, all "
        f"replicas): key len <= 1024: {launches['short']}, > 1024: "
        f"{launches['long']}")
    if DEV.type == "cuda" and (launches["short"] <= 0
                               or launches["long"] <= 0):
        fail(f"fleet (a): the flash kernel was not launched in both "
             f"regimes: {by_len}")
    return launches


def fleet_disagg(kv, uni, dis, q8, base_prompts, ref_cfg, params, kt):
    """Phase 13 (b) and (c)."""
    prompts, _, n_base = default_traffic(base_prompts,
                                         FLAGSHIP["vocab_size"])
    shape = (FLAGSHIP["n_layers"], 16, FLAGSHIP["d_model"])
    per16 = kt.block_nbytes(shape, "bfloat16")
    per8 = kt.block_nbytes(shape, "int8")
    unified = fleet_leg("disagg_unified", kv, uni, ("unified", "unified"),
                        prompts, FLEET_HB_MS_XFER, sessions=False,
                        after=lambda r, reps, res: res.update(
                            trows=wait_tenant_rows("(b) unified", r, uni)))
    fleet_say("(b) unified, 2 replicas", unified)
    fleet_ledgers("(c) unified", uni)
    index = {np.asarray(p, np.int64).tobytes(): i
             for i, p in enumerate(prompts)}
    pf, dec = dis

    for label, chaos in (("disagg", None), ("disagg_drop", FLEET_DROP)):
        for e in dis:
            e._pool.flush_cache()
        admits = {}
        begin = dec._begin_prefill

        def begin_seen(req, slot, begin=begin, admits=admits):
            begin(req, slot)
            i = index.get(req.prompt0.tobytes())
            if i is not None and req.slot != -1:
                admits[i] = (req.full_hit, req.n_hit)

        dec._begin_prefill = begin_seen
        try:
            res = fleet_leg(label, kv, dis, ("prefill", "decode"), prompts,
                            FLEET_HB_MS_XFER, chaos=chaos, sessions=False,
                            after=lambda r, reps, res: res.update(
                                trows=wait_tenant_rows(f"(b) {label}", r,
                                                       dis),
                                drops=reps[0].chaos.counts[
                                    "kv_xfer_drops"]))
        finally:
            dec._begin_prefill = begin
        st, pfs, decs = res["stats"], pf.stats(), dec.stats()
        problems = []
        if st["kv_xfers"] != len(prompts):
            problems.append(f"{st['kv_xfers']} transfers")
        # the prefill engine counts what it fetched, the router what
        # arrived: they differ by the dropped payload's blocks
        if st["kv_bytes_moved"] != st["xfer_blocks"] * per16 or (
                pfs["kv_bytes_moved"] > st["kv_bytes_moved"]) != bool(chaos) \
                or pfs["kv_bytes_moved"] < st["kv_bytes_moved"]:
            problems.append(
                f"bytes: router {st['kv_bytes_moved']}, prefill engine "
                f"{pfs['kv_bytes_moved']}, shipped {st['xfer_blocks']} x "
                f"{per16}")
        if decs["xfer_dedup_blocks"] <= 0:
            problems.append("no dedup on the shared-prefix requests")
        if res["drops"] != (1 if chaos else 0):
            problems.append(f"{res['drops']} transfers dropped")
        if problems:
            fail(f"fleet (b) {label}: " + "; ".join(problems))
        exact = near = 0
        for i, (got, ref) in enumerate(zip(res["outs"], unified["outs"])):
            if np.array_equal(got, ref):
                exact += 1
                continue
            hit, n_hit = admits.get(i, (False, 0))
            if not (hit or (n_hit * 16) % 32):
                fail(f"fleet (b) {label}: request {i} (decode admission "
                     f"{n_hit} blocks hit, full hit {hit}) differs from the "
                     f"unified leg at token {first_mismatch(got, ref)}")
            ok, (j, gap, bound) = divergence_allowed(
                ref_cfg, params, prompts[i], got, ref)
            say(f"fleet (b) {label}: request {i} ({'full hit' if hit else f'{n_hit} blocks spliced'}"
                f") first differs at token {j}: gap {gap:.5f}, bound "
                f"{bound:.5f}")
            if not ok:
                fail(f"fleet (b) {label}: request {i} diverges at token {j}"
                     f" where the gap {gap:.5f} >= bound {bound:.5f}")
            near += 1
        fleet_say(f"(b) {label}, prefill + decode", res,
                  f", transfers {st['kv_xfers']}, blocks shipped "
                  f"{st['xfer_blocks']} x {per16} B = {st['kv_bytes_moved']}"
                  f" B moved, source dedup {st['xfer_dedup_blocks']}, "
                  f"decode-side dedup {decs['xfer_dedup_blocks']}, spliced "
                  f"{decs['xfer_blocks']}, full hits "
                  f"{sum(1 for h, _ in admits.values() if h)}, dropped "
                  f"transfers {res['drops']}; vs unified: {exact}/"
                  f"{len(prompts)} token-identical, {near} within the "
                  f"near-tie rule")
        fleet_ledgers(f"(c) {label}", dis)

    # an int8 prefill -> int8 decode pair on the shared-prefix prompts
    shared = prompts[n_base:]
    payload = q8[0].submit_prefill(shared[0]).result(timeout=600)["xfer"]
    n = len(shared[0]) // 16
    if (payload["dtype"] != "int8" or len(payload["blocks"]) != n
            or kt.payload_bytes(payload) != n * per8
            or not all("ks" in r and "vs" in r
                       for r in payload["blocks"].values())):
        fail(f"fleet (b) int8: payload dtype {payload['dtype']}, "
             f"{len(payload['blocks'])} of {n} blocks, "
             f"{kt.payload_bytes(payload)} B (want {n * per8})")
    q8[0]._pool.flush_cache()
    res = fleet_leg("disagg_int8", kv, q8, ("prefill", "decode"), shared,
                    FLEET_HB_MS_XFER, sessions=False)
    st = res["stats"]
    rate = float(np.mean([argmax_match(a, b) for a, b in zip(
        res["outs"], unified["outs"][n_base:])]))
    if (st["kv_bytes_moved"] != st["xfer_blocks"] * per8
            or st["xfer_blocks"] <= 0 or rate < QUANT_MATCH_FLOOR):
        fail(f"fleet (b) int8: {st['xfer_blocks']} blocks, "
             f"{st['kv_bytes_moved']} B (want x {per8}), argmax match "
             f"{rate:.3f}")
    fleet_ledgers("(c) int8", q8)
    fleet_say("(b) int8 KV prefill + decode", res,
              f", blocks shipped {st['xfer_blocks']} x {per8} B (int8 with "
              f"scales) = {st['kv_bytes_moved']} B, argmax match against "
              f"the bf16 unified leg {rate:.3f} (floor {QUANT_MATCH_FLOOR})")


# phase 14: the fleet's two planes
PLANE_REPORT_MS = 250     # -obs_report_ms of (a)'s loopback agent
PLANE_METRICS_S = 0.5     # -metrics_interval_s of (a)'s exporter
# (b) and (c): the staleness bound and the silence that must trip it
PLANE_STALE_S, PLANE_SILENCE_S = 0.5, 0.75
PLANE_KEYED, PLANE_DRAW, PLANE_SCALE = 8, 65536, 1e-3
PLANE_QUERIES = 32
PLANE_NEIGHBORS_AFTER = (4, 9)   # delta records (8 keyed, then the dense)
PLANE_ZOMBIE = "zombie_epoch=4:1"
PLANE_WAIT_S = 120.0


def wait_for(what: str, pred, timeout_s: float = PLANE_WAIT_S) -> None:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            fail(f"planes: timed out waiting for {what}")
        time.sleep(0.005)


def phase_planes(card: str, base_prompts):
    """14. The fleet's two planes (see the module docstring): (a) the
    observability plane at phase 3's width, (b) the parameter plane at
    the text8 width, (c) the engine's staleness health. Returns phase
    14's kernel launches by kernel, each counted from 0 just before the
    path that launches it."""
    t_phase = time.perf_counter()
    _CARD[:] = [card]
    launches = collections.Counter()
    planes_obs(base_prompts, launches)
    import multiverso_tpu_torch as mv

    mv.init(["chip_smoke", f"-device={DEV.type}", "-log_level=error",
             f"-params_stale_after_s={PLANE_STALE_S}"])
    try:
        planes_params(launches)
        planes_health(base_prompts, launches)
    finally:
        mv.shutdown()
        mv.set_flag("params_stale_after_s", 0.0)
    say(f"planes: launches {json.dumps(dict(launches), sort_keys=True)}; "
        f"phase 14 took {time.perf_counter() - t_phase:.1f} s, card "
        f"{card_line()}")
    if DEV.type == "cuda" and not all(launches[k] > 0 for k in (
            "flash_fwd_short", "flash_fwd_long", "row_gather",
            "row_scatter_add", "flash_bwd_fused")):
        fail(f"planes: a kernel of the path was not launched: "
             f"{dict(launches)}")
    return dict(launches)


def planes_serve(label, flags, prompts, launches):
    """Serve ``prompts`` on phase 3's flagship and layout in a session of
    its own (``flags`` added); returns the outputs, tokens/s, the engine
    and its server, the session's agent and its report build times. The
    session stays up: the caller checks, then shuts it down."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models import transformer as tf
    from multiverso_tpu_torch.runtime import Session
    from multiverso_tpu_torch.serving import InferenceServer

    fa = _fa()
    mv.init(["chip_smoke", f"-device={DEV.type}", "-log_level=error"]
            + flags)
    lm = tf.TransformerLM(tf.TransformerConfig(
        **FLAGSHIP, dtype=torch.bfloat16, attention="flash_force"))
    srv = InferenceServer(f"planes_{label}")
    eng = srv.register_decoder(
        f"planes_{label}", lm, slots=SLOTS, max_prompt=MAX_PROMPT,
        max_new=MAX_NEW, prompt_buckets=BUCKETS, prefill_token_budget=0,
        kv_block_size=0, prefix_cache=False, spec_k=0, kv_quant="none",
        decode_param_quant="none", preempt=False, flight_recorder=False,
        watchdog=False, cost_ledger=False)
    agent = Session.get().obs_agent
    build_ms = []
    if agent is not None:
        build = agent.build_report

        def timed_build():
            t0 = time.perf_counter()
            rep = build()
            build_ms.append(1e3 * (time.perf_counter() - t0))
            return rep

        agent.build_report = timed_build
    dev_sync()
    fa.reset_launches()
    t0 = time.perf_counter()
    futs = [srv.submit(f"planes_{label}", {"prompt": p, "max_new": MAX_NEW})
            for p in prompts]
    outs = [np.asarray(f.result(timeout=600)["result"]) for f in futs]
    dev_sync()
    wall = time.perf_counter() - t0
    by_len = dict(fa.LAUNCHES_BY_KEY_LEN)
    launches["flash_fwd_short"] += sum(n for k, n in by_len.items()
                                       if k <= 1024)
    launches["flash_fwd_long"] += sum(n for k, n in by_len.items()
                                      if k > 1024)
    tokens = sum(o.size for o in outs)
    return {"outs": outs, "tok_s": tokens / wall, "eng": eng, "srv": srv,
            "agent": agent, "build_ms": build_ms, "wall": wall}


def _counters(snap):
    return {n: r["value"] for n, r in snap.items() if r["type"] == "counter"}


def planes_obs(prompts, launches):
    """(a) the observability plane at full width."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import trace
    from multiverso_tpu_torch.dashboard import (BUCKET_REL_ERROR, Dashboard,
                                                _prom_split,
                                                parse_prometheus)

    out_dir = os.path.join(HERE, "build", "planes")
    os.makedirs(out_dir, exist_ok=True)
    jsonl = os.path.join(out_dir, "m.jsonl")
    if os.path.exists(jsonl):
        os.remove(jsonl)
    off = planes_serve("off", [], prompts, launches)
    mv.shutdown()
    Dashboard.reset()
    on_flags = ["-obs_plane=true", f"-obs_report_ms={PLANE_REPORT_MS}",
                "-trace=true", f"-metrics_jsonl={jsonl}",
                f"-metrics_interval_s={PLANE_METRICS_S}"]
    try:
        on = planes_serve("on", on_flags, prompts, launches)
        eng, agent = on["eng"], on["agent"]
        name = eng.name
        if agent is None or agent.collector is None:
            fail("planes a: -obs_plane started no loopback agent")
        same = sum(np.array_equal(a, b)
                   for a, b in zip(off["outs"], on["outs"]))
        if same != len(prompts):
            fail(f"planes a: {same}/{len(prompts)} outputs equal with the "
                 f"plane on and off")
        # two report intervals after the drain: the last report is of a
        # quiescent registry
        n0 = agent.reports
        wait_for("two reports after the drain", lambda: agent.reports >= n0 + 2)
        col = agent.collector
        fl = col.fleet()
        dash = _counters(Dashboard.snapshot())
        if fl["counters"] != dash:
            diff = {k: (fl["counters"].get(k), dash.get(k))
                    for k in set(fl["counters"]) | set(dash)
                    if fl["counters"].get(k) != dash.get(k)}
            fail(f"planes a: collector counters differ from the "
                 f"Dashboard's: {diff}")
        shipped = col.node_state(0)["engines"][name]["stats"]
        live = eng.stats()
        counts = {k for k, v in live.items()
                  if isinstance(v, int) and not isinstance(v, bool)}
        bad = {k: (shipped.get(k), live[k]) for k in counts
               if shipped.get(k) != live[k]}
        if bad or not counts:
            fail(f"planes a: the last shipped stats differ from "
                 f"eng.stats(): {bad}")
        worst = 0.0
        for hist, h in ((f"SERVE_TTFT[{name}]", eng.ttft_hist),
                        (f"SERVE_ITL[{name}]", eng.itl_hist)):
            exact = h.percentiles((50, 99))
            merged = fl["histograms"][hist]
            for p in (50, 99):
                got, want = merged[f"p{p}_ms"], exact[p]
                err = abs(got - want) / want if want else float(got != 0)
                worst = max(worst, err)
                if err > BUCKET_REL_ERROR + 1e-9:
                    fail(f"planes a: merged {hist} p{p} {got} vs exact "
                         f"{want} (relative {err}, bound "
                         f"{BUCKET_REL_ERROR})")
        st = agent.stats()
        if st["dropped_reports"] != 0:
            fail(f"planes a: dropped reports {st['dropped_reports']}")
        text = col.prometheus()
        parsed = parse_prometheus(text)
        samples = [ln for ln in text.splitlines()
                   if ln and not ln.startswith("#")]
        if not samples or not all('node="0"' in ln for ln in samples):
            fail("planes a: a Prometheus sample without its node label")
        for cname, value in fl["counters"].items():
            metric = f"mv_{_prom_split(cname)[0]}"
            if parsed.get(cname, {}).get(metric) != float(value):
                fail(f"planes a: Prometheus gives {cname} as "
                     f"{parsed.get(cname)}, the collector {value}")
        doc = col.export_chrome()
        summary = trace.validate_chrome_events(doc["traceEvents"],
                                               root_name="serve.request")
        if summary["roots"] < len(prompts):
            fail(f"planes a: {summary['roots']} request roots in the merged "
                 f"trace for {len(prompts)} requests")
        wire = planes_obs_wire(eng)
        build_ms = list(on["build_ms"])
    finally:
        mv.shutdown()
        for flag, value in (("obs_plane", False), ("trace", False),
                            ("metrics_jsonl", ""),
                            ("obs_report_ms", 1000),
                            ("metrics_interval_s", 10.0)):
            mv.set_flag(flag, value)
        trace.disable()
        trace.collector().clear()
    lines = [json.loads(x) for x in open(jsonl).read().splitlines()]
    after = _counters(Dashboard.snapshot())
    if not lines or _counters(lines[-1]["snapshot"]) != after:
        fail("planes a: the last JSON line's counters differ from the "
             "Dashboard's")
    say(f"planes a (observability, {len(prompts)} requests of phase 3, "
        f"reports every {PLANE_REPORT_MS} ms, JSON lines every "
        f"{PLANE_METRICS_S} s): {off['tok_s']:.1f} tok/s off, "
        f"{on['tok_s']:.1f} on; {len(prompts)}/{len(prompts)} outputs "
        f"equal; {st['reports']} reports, dropped 0, report build mean "
        f"{np.mean(build_ms):.3f} ms max {np.max(build_ms):.3f} ms over "
        f"{len(build_ms)}; spans shipped {st['spans_shipped']} missed "
        f"{st['spans_missed']}; {len(fl['counters'])} counters equal the "
        f"Dashboard's; worst merged-percentile error {worst:.4f} (bound "
        f"{BUCKET_REL_ERROR:.4f}); {summary['spans']} spans, "
        f"{summary['roots']} request roots validate; {len(lines)} JSON "
        f"lines; card {card_line()}")
    say(f"planes a (mvobs TCP wire, rank 1 -> rank 0): {wire['reports']} "
        f"reports ingested, {wire['spans']} spans, outstanding "
        f"{wire['outstanding']}, dropped {wire['dropped']}, the engine's "
        f"completed {wire['completed']}; card {card_line()}")


def planes_obs_wire(eng):
    """A rank-1 agent shipping ``eng``'s stats over the real mvobs TCP
    wire to a rank-0 collector; its reports must be ingested and the
    acks must release its window to 0."""
    from multiverso_tpu_torch.serving import ObsAgent

    kv = FleetKV()
    label = "mvobs_planes"
    col = ObsAgent(rank=0, size=2, client=kv, label=label,
                   report_ms=PLANE_REPORT_MS, engines=lambda: {},
                   start=False)
    a1 = ObsAgent(rank=1, size=2, client=kv, label=label,
                  report_ms=PLANE_REPORT_MS,
                  engines=lambda: {eng.name: eng}, start=False)
    try:
        def ingested():
            if a1.reports < 3:
                a1.tick()
            col.tick()
            return col.collector.node_state(1)["reports"] >= 3

        def released():
            col.tick()
            a1._release_acked_and_can_ship()
            return a1.stats()["outstanding"] == 0

        wait_for("the wire's reports", ingested, timeout_s=60)
        wait_for("the wire's acks", released, timeout_s=60)
        st1, node = a1.stats(), col.collector.node_state(1)
        done = node["engines"][eng.name]["stats"]["completed"]
        if st1["dropped_reports"] or done != eng.stats()["completed"]:
            fail(f"planes a: the wire agent dropped "
                 f"{st1['dropped_reports']}, shipped completed {done}")
        return {"reports": node["reports"], "spans": len(node["spans"]),
                "outstanding": st1["outstanding"],
                "dropped": st1["dropped_reports"], "completed": done}
    finally:
        a1.stop(final_report=False)
        col.stop(final_report=False)


def planes_params(launches):
    """(b) the parameter plane at the text8 width."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.serving import (EmbeddingNeighbors, FaultPlan,
                                              InferenceServer,
                                              ParamPublisher,
                                              ParamSubscriber,
                                              SnapshotManager)

    emb = _emb()
    V, D = W2V_VOCAB, W2V_DIM
    trainer = mv.create_table("matrix", V, D, init_value="random",
                              dtype=torch.bfloat16, seed=0)
    reps = [mv.create_table("matrix", V, D, dtype=torch.bfloat16)
            for _ in range(2)]
    kv = FleetKV()
    label = "mvparam_planes"
    all_ids = torch.arange(V, dtype=torch.int32, device=DEV)
    srv = InferenceServer("planes_w2v")
    tables = {"trainer": trainer, "r1": reps[0], "r2": reps[1]}
    for tag, t in tables.items():
        srv.register(f"w2v_{tag}", EmbeddingNeighbors(t, k=EMB_K),
                     max_batch=PLANE_QUERIES, deadline_ms=1000.0,
                     max_staleness_s=0.0)
    q_rng = np.random.default_rng(44)

    def read_bits(t):
        return bits(emb.embedding_lookup(t.array, all_ids))

    def hold(what, subs, applied):
        for r, sub in enumerate(subs):
            wait_for(f"replica {r + 1} to apply {what}",
                     lambda: sub.applied == applied)
        want = read_bits(trainer)
        for r, t in enumerate(reps):
            if t.version != trainer.version or not torch.equal(
                    read_bits(t), want):
                fail(f"planes b: replica {r + 1} after {what}: version "
                     f"{t.version} vs the trainer's {trainer.version}, "
                     f"bitwise equal {torch.equal(read_bits(t), want)}")

    def neighbors(k):
        ids = q_rng.integers(0, V, PLANE_QUERIES)
        got = {}
        for tag in tables:
            futs = [srv.submit(f"w2v_{tag}", int(i)) for i in ids]
            got[tag] = [f.result(timeout=600) for f in futs]
            last = srv._entry(f"w2v_{tag}").batcher.flushes[-1]
            if last[0] != PLANE_QUERIES:
                fail(f"planes b: {tag}'s flush of {last}, not one of "
                     f"{PLANE_QUERIES}")
        for tag in ("r1", "r2"):
            for i, (a, b) in enumerate(zip(got["trainer"], got[tag])):
                if (a["snapshot_version"] != trainer.version
                        or b["snapshot_version"] != trainer.version
                        or not np.array_equal(a["result"][0], b["result"][0])
                        or not np.array_equal(a["result"][1],
                                              b["result"][1])):
                    fail(f"planes b: EmbeddingNeighbors of id {ids[i]} on "
                         f"{tag} differs from the trainer's after delta "
                         f"record {k}")
        return float(np.max([r["result"][1][0] for r in got["trainer"]]))

    rng, vals_rng = np.random.default_rng(14), np.random.default_rng(15)
    pub = ParamPublisher(kv, 3, label=label)
    subs = [ParamSubscriber(kv, {trainer.table_id: t}, rank=r + 1, size=3,
                            label=label, poll_s=0.01)
            for r, t in enumerate(reps)]
    pub2 = None
    try:
        if pub.epoch != 1:
            fail(f"planes b: the first publisher claimed epoch {pub.epoch}")
        dev_sync()
        emb.reset_launches()
        pub.publish_state(trainer)
        hold("the STATE rebase", subs, 1)
        keyed_s, keyed_bytes, n_rows = 0.0, 0, 0
        for k in range(1, PLANE_KEYED + 2):
            b0, t0 = pub.publish_bytes, time.perf_counter()
            if k <= PLANE_KEYED:
                ids = np.unique(zipf_ids(rng, V, PLANE_DRAW))
                vals = torch.from_numpy((vals_rng.standard_normal(
                    (ids.size, D)) * PLANE_SCALE).astype(
                        np.float32)).to(torch.bfloat16)
                trainer.add_rows(ids, vals)
                pub.publish_keyed(trainer, ids, vals)
                n_rows += ids.size
            else:
                ratio_keyed = pub.stats()["wire_compressed_ratio"]
                d = (np.random.default_rng(16).standard_normal((V, D))
                     * PLANE_SCALE).astype(np.float32)
                trainer.add(d)
                pub.publish_delta(trainer, d)
            hold(f"delta record {k}", subs, k + 1)
            if k <= PLANE_KEYED:
                keyed_s += time.perf_counter() - t0
                keyed_bytes += pub.publish_bytes - b0
            if k in PLANE_NEIGHBORS_AFTER:
                neighbors(k)
        # the restart: epoch 2 by claim_epoch, a rebase, then the zombie
        pub.stop()
        pub2 = ParamPublisher(kv, 3, label=label,
                              chaos=FaultPlan(PLANE_ZOMBIE))
        if pub2.epoch != 2:
            fail(f"planes b: the restarted publisher claimed epoch "
                 f"{pub2.epoch}")
        switches = [s.epoch_switches for s in subs]
        applied = PLANE_KEYED + 2
        pub2.publish_state(trainer)                         # publish 1
        applied += 1
        hold("the epoch-2 rebase", subs, applied)
        for r, (s, t) in enumerate(zip(subs, reps)):
            snap = SnapshotManager.of(t).publish()
            if (s.epoch_switches != switches[r] + 1 or t.epoch != 2
                    or (snap.epoch, snap.version) != (2, trainer.version)):
                fail(f"planes b: replica {r + 1} after the restart: "
                     f"switches {s.epoch_switches}, table epoch {t.epoch}, "
                     f"snapshot ({snap.epoch}, {snap.version})")

        def keyed_publish():
            ids = np.unique(zipf_ids(rng, V, PLANE_DRAW))
            vals = torch.from_numpy((vals_rng.standard_normal(
                (ids.size, D)) * PLANE_SCALE).astype(
                    np.float32)).to(torch.bfloat16)
            trainer.add_rows(ids, vals)
            pub2.publish_keyed(trainer, ids, vals)

        keyed_publish()                                     # publish 2
        applied += 1
        hold("the restarted publisher's keyed record", subs, applied)
        time.sleep(PLANE_SILENCE_S)
        stale = [s.params_stale() for s in subs]
        ages = [s.params_age_s() for s in subs]
        if not all(stale):
            fail(f"planes b: after {PLANE_SILENCE_S} s of silence the "
                 f"replicas read stale {stale} (ages {ages})")
        keyed_publish()                                     # publish 3
        applied += 1
        hold("the publish after the silence", subs, applied)
        if any(s.params_stale() for s in subs):
            fail("planes b: a publish did not clear the stale verdict")
        before = [(read_bits(t).clone(), t.version) for t in reps]
        keyed_publish()                                     # 4: epoch 1
        keyed_publish()                                     # 5: epoch 1
        for r, s in enumerate(subs):
            wait_for(f"replica {r + 1}'s fence",
                     lambda: s.stats()["fence_rejections"] == 2)
        for r, (t, (b, v)) in enumerate(zip(reps, before)):
            if t.version != v or not torch.equal(read_bits(t), b) \
                    or subs[r].applied != applied:
                fail(f"planes b: replica {r + 1} moved on a zombie record")
        dev_sync()
        launches["row_gather"] += emb.LAUNCHES["row_gather"]
        launches["row_scatter_add"] += emb.LAUNCHES["row_scatter_add"]
        zombies = pub2.stats()["chaos"]["zombie_publishes"]
        st = [s.stats() for s in subs]
    finally:
        for s in subs:
            s.stop()
        (pub2 or pub).stop()
        srv.stop()
    mb = keyed_bytes / 1e6
    say(f"planes b (parameters, [{V}, {D}] bf16 tables, 2 replicas over "
        f"mvparam TCP): {PLANE_KEYED} keyed records of {n_rows} rows in all "
        f"at {PLANE_KEYED / keyed_s:.2f} records/s, {mb / keyed_s:.1f} MB/s "
        f"({mb:.1f} MB, publish to both replicas applied), "
        f"wire_compressed_ratio {ratio_keyed:.6f}; every record bitwise "
        f"equal on both replicas at the trainer's version "
        f"{trainer.version}; EmbeddingNeighbors equal after delta records "
        f"{PLANE_NEIGHBORS_AFTER}; restart: epoch 2, switches "
        f"{[x['epoch_switches'] for x in st]}, stale after "
        f"{PLANE_SILENCE_S} s (ages {[round(a, 3) for a in ages]}) and "
        f"cleared; zombie publishes {zombies}, fence rejections "
        f"{[x['fence_rejections'] for x in st]}; launches "
        f"{json.dumps(dict(emb.LAUNCHES), sort_keys=True)}; card "
        f"{card_line()}")


def planes_health(prompts, launches):
    """(c) the repaired staleness health at full width."""
    from multiverso_tpu_torch.apps import lm as app
    from multiverso_tpu_torch.dashboard import Dashboard
    from multiverso_tpu_torch.models import transformer as tf
    from multiverso_tpu_torch.serving import InferenceServer

    fa = _fa()
    cfg = tf.TransformerConfig(**FLAGSHIP, dtype=torch.bfloat16,
                               attention="flash_force",
                               learning_rate=LM_LR, momentum=0.9)
    lm = tf.TransformerLM(cfg)
    srv = InferenceServer("planes_health")
    name = "planes_health"
    eng = srv.register_decoder(name, lm, slots=SLOTS,
                               max_prompt=MAX_PROMPT, max_new=MAX_NEW,
                               max_staleness_s=0.0)
    try:
        srv.submit(name, {"prompt": prompts[0], "max_new": 8}).result(
            timeout=600)
        time.sleep(PLANE_SILENCE_S)
        h = eng.health()
        gauge = Dashboard.get_or_create_gauge(
            f"SERVE_PARAMS_AGE[{name}]").get()
        if not (h["params_age_s"] > PLANE_STALE_S and h["params_stale"]
                is True and gauge >= PLANE_STALE_S
                and "snapshot_epoch" in h):
            fail(f"planes c: after {PLANE_SILENCE_S} s without a step: "
                 f"health {h}, gauge {gauge}")
        data = app.load_bytes(lm_corpus())
        gen = app.batches(data, TWS_BATCH, TWS_SEQ - 1, seed=0)
        dev_sync()
        fa.reset_launches()
        loss = float(lm.train_batch(next(gen)))
        dev_sync()
        fused = fa.BWD_LAUNCHES["fused"]
        launches["flash_bwd_fused"] += fused
        h2 = eng.health()
        if h2["params_stale"] is not False or not np.isfinite(loss) \
                or h2["params_age_s"] >= PLANE_STALE_S:
            fail(f"planes c: after a train_batch (loss {loss}): {h2}")
    finally:
        srv.stop()
    say(f"planes c (health, -params_stale_after_s={PLANE_STALE_S}): after "
        f"{PLANE_SILENCE_S} s params_age_s {h['params_age_s']}, "
        f"params_stale {h['params_stale']}, SERVE_PARAMS_AGE {gauge:.4f}, "
        f"snapshot_version {h['snapshot_version']}, snapshot_epoch "
        f"{h['snapshot_epoch']}; one train_batch ({TWS_BATCH} x {TWS_SEQ}, "
        f"loss {loss:.4f}, one-pass backward launches {fused}) -> "
        f"params_age_s {h2['params_age_s']}, params_stale "
        f"{h2['params_stale']}; card {card_line()}")


def _fa():
    return importlib.import_module("multiverso_tpu_torch.ops.flash_attention")


def bwd_bound_ms(kind: str, B, H, D, sq, sk, causal, q_base, k_base,
                 item: int, dtype):
    """The least time of backward function ``kind`` (module docstring)."""
    pairs = live_pairs(sq, sk, causal, q_base, k_base)
    flops = FB_PRODUCTS[kind] * 2.0 * D * B * H * pairs
    reads = 2 * (B * sq * H * D + B * sk * H * D) * item + 2 * B * H * sq * 4
    writes = 4 * (B * sq * H * D * (kind != "dkv")
                  + 2 * B * sk * H * D * (kind != "dq"))
    peak = TFLOPS_BF16 if dtype == torch.bfloat16 else TFLOPS_F32
    t_ops, t_bytes = flops / peak, (reads + writes) / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


def bwd_errors(got, ref):
    """Per output (dq, dk, dv): max |got - ref| / max |ref|."""
    return [((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
            for a, b in zip(got, ref)]


def bwd_case(B, H, D, sq, sk, dt, causal, qb, kb, packed=False):
    """One backward case on the card (module docstring, phase 7): checks
    the kernels against the plain version with each output zeroed as a
    failing control, times kernel, plain and library, prints one line.
    Returns (tag, result, the kernel call's args and kwargs)."""
    import torch.nn.functional as F

    fa = _fa()
    gen = torch.Generator(device="cpu").manual_seed(3)
    if packed:   # q, k, v: strided views into one [B, S, 3, H, D] tensor
        qkv = torch.randn((B, sq, 3, H, D), generator=gen).to(DEV, dt)
        q, k, v = qkv.unbind(2)
    else:
        q = torch.randn((B, sq, H, D), generator=gen).to(DEV, dt)
        k, v = (torch.randn((B, sk, H, D), generator=gen).to(DEV, dt)
                for _ in range(2))
    g = torch.randn((B, sq, H, D), generator=gen).to(DEV, dt)
    scale = 1.0 / D ** 0.5
    # the rows' statistics from the forward kernel, as a caller has them
    acc, m, l = fa._fa_cuda(q, k, v, qb, kb, causal=causal, scale=scale,
                            normalize=False)
    lse = m + torch.log(torch.clamp(l, min=1e-20))
    out = acc / torch.clamp(l, min=1e-20).transpose(1, 2)[..., None]
    delta = torch.einsum("bshd,bshd->bhs", g.float(), out).contiguous()
    del acc, m, l, out
    args = (q, k, v, g, lse, delta, qb, kb)
    kw = dict(causal=causal, scale=scale)
    kinds = fa.bwd_kernels(sk)
    got = fa._bwd_cuda(*args, **kw)
    torch.cuda.synchronize()
    ref = fa._bwd_plain(*args, **kw)
    errs = bwd_errors(got, ref)
    tol = FB_TOL[dt]
    tag = (f"B={B} H={H} D={D} sq={sq} sk={sk} {str(dt).split('.')[-1]} "
           f"causal={int(causal)} offs=({qb},{kb})"
           f"{' packed' if packed else ''} {'+'.join(kinds)}")
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    if not (finite and max(errs) <= tol):
        fail(f"flash_bwd vs plain {tag}: max_abs_err / max|ref| of dq, "
             f"dk, dv {errs} (tolerance {tol}), finite {finite}")
    dead = max(0, min(sq, kb - qb)) if causal else 0
    if dead and bool((got[0][:, :dead] != 0).any()):
        fail(f"flash_bwd {tag}: rows with no live key have dq != 0")
    # negative controls: each output zeroed must fail the same check
    for i, name in enumerate(("dq", "dk", "dv")):
        zeroed = list(got)
        zeroed[i] = torch.zeros_like(got[i])
        if not bwd_errors(zeroed, ref)[i] > tol:
            fail(f"flash_bwd {tag}: negative control: a zero {name} "
                 f"passes the check")
    ms = time_ms(lambda: fa._bwd_cuda(*args, **kw))
    plain_ms = time_ms(lambda: fa._bwd_plain(*args, **kw))
    lib_ms = None
    if qb == kb == 0:
        # the library's backward at the same shapes (the port never
        # calls it): autograd of scaled_dot_product_attention
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                            scale=scale)
        gt = g.transpose(1, 2).contiguous()
        lib_ms = time_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), gt, retain_graph=True))
        del qt, kt, vt, ot, gt
    bound, by = bwd_bound_ms("fused", B, H, D, sq, sk, causal, qb, kb,
                             q.element_size(), dt)
    r = dict(max_abs_err=max(e * b.abs().max().item()
                             for e, b in zip(errs, ref)),
             ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
             library_ms=lib_ms, design=FB_DESIGN[dt])
    tflops = bwd_tflops("fused", B, H, D, sq, sk, causal, qb, kb, ms)
    say(f"kernel flash_bwd {tag} [{FB_DESIGN[dt]}]: err/max dq "
        f"{errs[0]:.2e} dk {errs[1]:.2e} dv {errs[2]:.2e} (tol {tol}; each "
        f"zeroed fails), ms {ms:.4f} ({tflops:.1f} TFLOP/s) plain_ms "
        f"{plain_ms:.4f} library_ms {fmt(lib_ms)} bound_ms {bound:.4f} "
        f"({by})")
    del got, ref
    return tag, r, args, kw


def bwd_tflops(kind, B, H, D, sq, sk, causal, q_base, k_base, ms) -> float:
    """Achieved TFLOP/s: the function's products over the live pairs
    (FB_PRODUCTS x 2 D flops each) over the time."""
    pairs = live_pairs(sq, sk, causal, q_base, k_base)
    return FB_PRODUCTS[kind] * 2.0 * D * B * H * pairs / (ms * 1e-3) / 1e12


def phase_bwd_kernels():
    """The flash backward kernels against their plain version on the card
    (module docstring, phase 7)."""
    fa = _fa()
    H, D = FLAGSHIP["n_heads"], FLAGSHIP["d_model"] // FLAGSHIP["n_heads"]
    bf = torch.bfloat16
    results = {}
    cases = [(B, H, D, sq, sk, dt, causal, qb, kb, False)
             for B, sq, sk, dt, causal, qb, kb in FB_CASES]
    cases += [(B, h, d, sq, sk, bf, causal, qb, kb, packed)
              for B, h, d, sq, sk, causal, qb, kb, packed in FB_TILE_CASES]
    for B, h, d, sq, sk, dt, causal, qb, kb, packed in cases:
        tag, r, args, kw = bwd_case(B, h, d, sq, sk, dt, causal, qb, kb,
                                    packed)
        path = (dt == bf and causal and qb == kb == 0 and sq == sk
                and (sq, B) in LM_TRAIN and (h, d) == (H, D) and not packed)
        kinds = fa.bwd_kernels(sk)
        if path and kinds == ("fused",):
            results["fused"] = r
        if path and len(kinds) == 2:
            # each pass alone, for the kernels line
            dq, dk, dv = (torch.empty(t.shape, device=DEV)
                          for t in args[:3])
            line = f"kernel flash_bwd {tag} passes alone:"
            for kind in kinds:
                k_ms = time_ms(lambda: fa._launch_bwd(
                    kind, *args[:6], dq, dk, dv, 0, 0, **kw))
                p_ms = time_ms(lambda: fa._bwd_plain(*args, **kw,
                                                     kinds=(kind,)))
                b_ms, b_by = bwd_bound_ms(kind, B, h, d, sq, sk, causal, 0,
                                          0, dq.new_empty((), dtype=dt)
                                          .element_size(), dt)
                results[kind] = dict(
                    max_abs_err=r["max_abs_err"], ms=k_ms, plain_ms=p_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    library_ms_of_backward=r["library_ms"],
                    design=r["design"])
                tflops = bwd_tflops(kind, B, h, d, sq, sk, causal, 0, 0, k_ms)
                line += (f" {kind} ms {k_ms:.4f} ({tflops:.1f} TFLOP/s) "
                         f"plain_ms {p_ms:.4f} bound_ms {b_ms:.4f} ({b_by});")
            say(line)
            del dq, dk, dv
        del args
        torch.cuda.empty_cache()
    return results


def _leaf_grads(cfg, params, toks):
    from multiverso_tpu_torch.models import transformer as tf

    leaves = [w.requires_grad_() for w in tf._leaves(params)]
    loss = tf.loss_fn(cfg, params, toks)
    return loss, torch.autograd.grad(loss, leaves)


def phase_grad_check():
    """One full-width f32 loss_fn gradient through the backward kernels
    against the same gradient through reference attention (module
    docstring, phase 8)."""
    from multiverso_tpu_torch.models import transformer as tf

    fa = _fa()
    names = None
    out = {}
    for seq, batch in GRAD_CASES:
        dims = dict(FLAGSHIP, max_seq=seq)
        cfg = tf.TransformerConfig(**dims, attention="flash_force")
        ref_cfg = tf.TransformerConfig(**dims, attention="reference")
        params = tf.init_params(cfg, device=DEV)
        names = [f"{k}.{n}" if isinstance(v, dict) else k
                 for k, v in params.items()
                 for n in (v if isinstance(v, dict) else [None])]
        toks = torch.from_numpy(np.random.default_rng(seq).integers(
            0, cfg.vocab_size, (batch, seq + 1))).to(DEV)
        fa.reset_launches()
        loss, g_flash = _leaf_grads(cfg, params, toks)
        launched = dict(fa.BWD_LAUNCHES)
        ref_loss, g_ref = _leaf_grads(ref_cfg, params, toks)
        rel = [((a - b).norm() / b.norm().clamp(min=1e-30)).item()
               for a, b in zip(g_flash, g_ref)]
        # the no-op control: the same gradient with the attention
        # gradient zeroed must fail the check
        bwd_call = fa._bwd_call
        fa._bwd_call = lambda q, k, v, *a, **kw: tuple(
            torch.zeros(t.shape, device=t.device) for t in (q, k, v))
        try:
            _, g_zero = _leaf_grads(cfg, params, toks)
        finally:
            fa._bwd_call = bwd_call
        ctl = [((a - b).norm() / b.norm().clamp(min=1e-30)).item()
               for a, b in zip(g_zero, g_ref)]
        worst = int(np.argmax(rel))
        kinds = fa.bwd_kernels(seq)
        say(f"grad check f32 seq {seq} batch {batch}: loss flash "
            f"{loss.item():.6f} reference {ref_loss.item():.6f}; worst "
            f"relative error norm {rel[worst]:.3e} ({names[worst]}; "
            f"tolerance {GRAD_TOL}); attention gradient zeroed: max "
            f"{max(ctl):.3e}; backward launches {json.dumps(launched)}")
        if not (max(rel) <= GRAD_TOL and abs(loss.item() - ref_loss.item())
                <= 1e-4):
            fail(f"grad check seq {seq}: relative error norms "
                 f"{dict(zip(names, rel))}")
        if not max(ctl) > GRAD_TOL:
            fail(f"grad check seq {seq}: negative control: a zero "
                 f"attention gradient passes ({max(ctl)})")
        if any(launched[k] <= 0 for k in kinds):
            fail(f"grad check seq {seq}: kernels {kinds} not launched: "
                 f"{launched}")
        out[seq] = max(rel)
        del params, g_flash, g_ref, g_zero
        torch.cuda.empty_cache()
    return out


def lm_corpus() -> str:
    """The bytes of the checkout's own multiverso_tpu/**/*.py and *.md
    files, concatenated into build/ (real text already on the machine)."""
    src = os.path.join(HERE, "multiverso_tpu")
    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(src)
                   for f in fs if f.endswith((".py", ".md")))
    path = os.path.join(HERE, "build", "lm_corpus.txt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as out:
        for f in files:
            with open(f, "rb") as fh:
                out.write(fh.read())
    return path


def train_flops_per_step(d_model, n_layers, d_ff, vocab, batch, seq):
    """tools/lm_mfu.py:37-42's count: 6 x the matmul parameters a token
    plus causal attention, 3 x the forward's."""
    n_matmul = n_layers * (4 * d_model * d_model + 2 * d_model * d_ff) \
        + d_model * vocab
    per_token = 6 * n_matmul + 3 * 4 * (seq / 2) * d_model * n_layers
    return per_token * batch * seq


def profile_window(fn):
    """One call of ``fn`` under torch.profiler: (wall ms with the profiler
    on, device busy ms, top-10 table by device time)."""
    return profile_kernels(fn)[:3]


def profile_kernels(fn, rows: int = 10):
    """:func:`profile_window`'s three values (the table's top ``rows``)
    and the number of device kernels (and copies) the call ran."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(avg[0], "self_device_time_total")
           else "self_cuda_time_total")
    # device busy time: the device-side events (kernels, copies) only; the
    # ops that launch them carry the same time again
    dev = [e for e in avg
           if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_us = sum(getattr(e, key) for e in dev)
    return (wall * 1e3, busy_us / 1e3,
            avg.table(sort_by=key, row_limit=rows),
            sum(e.count for e in dev))


def phase_lm_train(card: str):
    """The training slice (module docstring, phase 9)."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.apps import lm as app
    from multiverso_tpu_torch.models import transformer as tf

    fa = _fa()
    corpus = lm_corpus()
    data = app.load_bytes(corpus)
    say(f"lm corpus: {data.shape[0]} bytes of multiverso_tpu/**/*.py, *.md")
    torch.cuda.synchronize()
    fa.reset_launches()       # the main path: counts to 0 just before
    runs = {}
    # forward launches of the bf16 (tensor-core) route by regime: the
    # flagship's bf16 steps; the app trains in f32 (the CUDA-core route)
    bf16_fwd = {"short": 0, "long": 0}
    for seq, batch in LM_TRAIN:
        t0 = time.perf_counter()
        widths = [f"-{k}" if i == 0 else str(FLAGSHIP[k])
                  for k in ("d_model", "n_layers", "n_heads", "d_ff")
                  for i in range(2)]
        rc = app.main(["-train_file", corpus, *widths, "-seq", str(seq),
                       "-batch", str(batch), "-steps", str(LM_APP_STEPS),
                       "-lr", str(LM_LR), "-log_every", "1", "-sample", "8",
                       "-device=cuda"])
        torch.cuda.synchronize()
        if rc != 0:
            fail(f"apps.lm.main at seq {seq} returned {rc}")
        say(f"lm app: main -seq {seq} -batch {batch} -steps {LM_APP_STEPS} "
            f"-lr {LM_LR} -sample 8 (f32, the app's default dtype) ran in "
            f"{time.perf_counter() - t0:.1f} s")
        mv.init(["chip_smoke", "-device=cuda"])
        before = fa.LAUNCHES_BY_KEY_LEN[seq]
        cfg = tf.TransformerConfig(**dict(FLAGSHIP, max_seq=seq),
                                   dtype=torch.bfloat16, attention="flash",
                                   learning_rate=LM_LR, momentum=0.9)
        lm = tf.TransformerLM(cfg)
        gen = app.batches(data, batch, seq, seed=0)
        losses = [lm.train_batch(next(gen)) for _ in range(LM_WARM)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [lm.train_batch(next(gen)) for _ in range(LM_TIMED)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / LM_TIMED * 1e3
        losses = [float(x) for x in losses]
        # no host sync inside a step: any synchronizing CUDA call raises
        batch_np = next(gen)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            lm.train_batch(batch_np)
        except RuntimeError as exc:
            fail(f"train_batch synchronized with the host: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        wall_ms, busy_ms, table = profile_window(
            lambda: lm.train_batch(next(gen)))
        flops = train_flops_per_step(
            FLAGSHIP["d_model"], FLAGSHIP["n_layers"], FLAGSHIP["d_ff"],
            FLAGSHIP["vocab_size"], batch, seq)
        tok_s = batch * seq / (step_ms / 1e3)
        say(f"lm train seq {seq} batch {batch} bf16 attention=flash lr "
            f"{LM_LR} momentum 0.9: {step_ms:.3f} ms/step, {tok_s:.1f} tok/s, "
            f"{flops / (step_ms / 1e3) / TFLOPS_BF16:.4f} of 989 TFLOP/s "
            f"(tools/lm_mfu.py FLOPs {flops:.4e}/step); losses "
            f"{' '.join(f'{x:.4f}' for x in losses)}; one step ran with "
            f"set_sync_debug_mode('error'), no host sync; card {card}")
        say(f"lm profile of one step: wall {wall_ms:.3f} ms (profiler on), "
            f"device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.3f} of "
            f"wall); top 10 by device time:\n{table}")
        if not (np.all(np.isfinite(losses)) and np.mean(losses[-3:])
                < losses[0] - LM_LOSS_DROP):
            fail(f"lm loss at seq {seq} not finite and falling by "
                 f"{LM_LOSS_DROP}: {losses}")
        runs[seq] = dict(step_ms=step_ms, tok_s=tok_s, losses=losses)
        bf16_fwd["short" if seq <= 1024 else "long"] += \
            fa.LAUNCHES_BY_KEY_LEN[seq] - before
        mv.shutdown()
        del lm
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = dict(fa.BWD_LAUNCHES)
    by_len = dict(fa.LAUNCHES_BY_KEY_LEN)
    fwd_short = sum(n for sk, n in by_len.items() if sk <= 1024)
    fwd_long = sum(n for sk, n in by_len.items() if sk > 1024)
    say(f"lm train launches: backward {json.dumps(launches)}, forward key "
        f"len <= 1024: {fwd_short}, > 1024: {fwd_long} (by key len "
        f"{json.dumps(by_len, sort_keys=True)}; of them the bf16 route "
        f"{json.dumps(bf16_fwd)}, the f32 app's the rest)")
    if min(launches.values()) <= 0 or min(bf16_fwd.values()) <= 0 \
            or fwd_short <= bf16_fwd["short"] or fwd_long <= bf16_fwd["long"]:
        fail(f"the training run did not launch every backward kernel and "
             f"both forward regimes on both routes: {launches}, {by_len}, "
             f"bf16 {bf16_fwd}")
    return launches, bf16_fwd


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
               seed: int, cap: int = 100, sparse: bool = False):
    """A table and deltas on the 2^-16 grid whose every running sum is
    exact in the table dtype, in any order: x0 in [-128, 128] units, and
    each element of a row takes at most ``cap`` nonzero +-1-unit adds
    (update k of a row with h hits is nonzero at elements e with (k + e) %
    ceil(h/cap) == 0), so |sum| <= 128 + cap units: under 2^8 in bf16 (cap
    100), under 2^24 in f32 (a cap of 2^20 makes every update nonzero at
    every element). Every update is nonzero at some element while
    ceil(h/cap) <= D; with ``sparse`` a row hit more often may take
    all-zero updates (only D / ceil(h/cap) of its updates are nonzero)."""
    limit = 2 ** 8 if dtype == torch.bfloat16 else 2 ** 24
    if 128 + cap >= limit:
        fail(f"exact scatter case: a cap of {cap} adds leaves the exact "
             f"range of {dtype}")
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
    stride = torch.clamp((hits + cap - 1) // cap, min=1)
    if int(stride.max()) > D and not sparse:
        fail(f"exact scatter case: {int(hits.max())} hits on a row of {D}")
    e = torch.arange(D, device=dev)
    nz = (rank[:, None] + e[None, :]) % stride[:, None] == 0
    sign = torch.randint(0, 2, (n, D), generator=g, device=dev) * 2 - 1
    deltas = (nz * sign).float().mul_(unit).to(delta_dtype)
    x0 = torch.randint(-128, 129, (V, D), generator=g, device=dev).float()
    return x0.mul_(unit).to(dtype), deltas


W2V_EXACT_ALPHA = -0.5
# phase 4's chain control: rows hit more often than this lose their adds
W2V_HOT_HITS = 256


def device_ms(fn, iters: int = 20, warmup: int = 2):
    """``(ms, kernels)`` of one call of ``fn`` on the card: the CUPTI
    durations of the device kernels that ``iters`` calls ran under
    torch.profiler, each kernel's mean duration summed over the kernels a
    call runs (each once), and the kernel records a call left. Each
    duration is the kernel's own, so host time between the calls is not
    counted and no device sleep is needed to hide it. The mean, not the
    sum over ``iters``: a profiler that has run before in the process may
    drop the first records of a window (fewer than one kernel a call)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):      # a window the profiler left empty is retried
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        avg = prof.key_averages()
        key = ("self_device_time_total"
               if hasattr(avg[0], "self_device_time_total")
               else "self_cuda_time_total")
        dev = [e for e in avg
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
        if dev:
            break
    return (sum(getattr(e, key) / e.count for e in dev) / 1e3,
            sum(e.count for e in dev) / iters)


def exact_scaled(ids: torch.Tensor, V: int, deltas: torch.Tensor,
                 seed: int = 13):
    """``(alpha, row_scale, deltas)`` for the fused scatter on the exact
    grid: alpha -1/2 and a row scale of 2^-k (k in 0..3) for each row, and
    the exact-grid deltas divided by alpha x scale[row], so that every
    product alpha x scale x delta is an exact-grid delta again and every
    summation order gives the same bits."""
    dev = ids.device
    g = torch.Generator(device=dev).manual_seed(seed)
    scale = torch.exp2(-torch.randint(0, 4, (V,), generator=g,
                                      device=dev).float())
    w, ok = _emb()._wrapped(ids, V)
    coef = W2V_EXACT_ALPHA * scale[torch.where(ok, w, torch.zeros_like(w))]
    pre = (deltas.float() / coef[:, None]).to(deltas.dtype)
    return W2V_EXACT_ALPHA, scale, pre


def graph_replay(V: int, D: int, ids_np: np.ndarray):
    """One f32-out gather and one fused scatter (alpha and row scale, on
    the exact grid) captured in a torch.cuda.CUDAGraph and replayed: each
    replay must equal the eager call bit for bit."""
    emb = _emb()
    ids = torch.from_numpy(ids_np).to(DEV)
    table = torch.randn(V, D, device=DEV).to(torch.bfloat16)
    start, deltas = exact_case(V, D, ids, torch.bfloat16, torch.float32,
                               seed=17)
    alpha, scale, deltas = exact_scaled(ids, V, deltas)
    work = start.clone()

    def gather():
        return emb.embedding_lookup(table, ids, out_dtype=torch.float32)

    def scatter():
        return emb.scatter_add_rows(work, ids, deltas, alpha=alpha,
                                    row_scale=scale)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gather()
        scatter()
    torch.cuda.current_stream().wait_stream(side)
    g_gather, g_scatter = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(g_gather):
        captured = gather()
    with torch.cuda.graph(g_scatter):
        scatter()
    captured.zero_()
    work.copy_(start)
    g_gather.replay()
    g_scatter.replay()
    torch.cuda.synchronize()
    eager_rows = gather()
    eager = emb.scatter_add_rows(start.clone(), ids, deltas, alpha=alpha,
                                 row_scale=scale)
    torch.cuda.synchronize()
    if not torch.equal(bits(captured), bits(eager_rows)):
        fail("row_gather CUDA graph replay differs from the eager call")
    if not torch.equal(bits(work), bits(eager)):
        fail("row_scatter_add CUDA graph replay differs from the eager call")
    if torch.equal(bits(work), bits(start)):
        fail("row_scatter_add CUDA graph: negative control: the replay "
             "left the table unchanged")
    say(f"CUDA graph: a captured f32-out gather and fused scatter "
        f"(n={ids.numel()}) replay bitwise equal to eager")


def one_row_view(D: int):
    """The gather of a contiguous [1, D] table whose size-1 dim has stride
    1, not D (a [D, 1] tensor transposed): the kernel must read rows of D
    elements, bitwise against the plain version, in both dtypes and both
    output dtypes; the rows of the table reversed must fail that check."""
    emb = _emb()
    ids = torch.tensor([0, -1, 0, 1, -2], dtype=torch.int32, device=DEV)
    for dt, out_dtype in ((torch.float32, None), (torch.bfloat16, None),
                          (torch.bfloat16, torch.float32)):
        table = torch.randn(D, 1, device=DEV).to(dt).t()
        got = emb._gather_cuda(table, ids, out_dtype)
        torch.cuda.synchronize()
        want = emb._gather_plain(table, ids, out_dtype)
        if not torch.equal(bits(got), bits(want)):
            fail(f"row_gather [1, {D}] view {dt}: differs from the plain "
                 f"version")
        if torch.equal(bits(got), bits(emb._gather_plain(
                table.flip(1).contiguous(), ids, out_dtype))):
            fail(f"row_gather [1, {D}] view {dt}: negative control: the "
                 f"reversed row passes the same check")
    say(f"kernel row_gather on a [1, {D}] view of a [{D}, 1] tensor: "
        f"bitwise equal, f32 / bf16 / bf16 -> f32")


def scatter_chain(tag: str, V: int, D: int, dtype, ids_np: np.ndarray,
                  fused: bool) -> None:
    """The long duplicate chains (the Huffman root's 65,536 adds a
    call) held bitwise on the exact grid: f32 with every update
    nonzero at every element (cap 2^20, sums exact to 2^24 units), or
    bf16 with at most 100 nonzero adds an element (a row hit more
    often takes all-zero updates between them). Two controls must
    fail the same bitwise check: the plain update with the adds of
    every row hit over W2V_HOT_HITS times left out, and with one
    nonzero add of the hottest row left out."""
    emb = _emb()
    dev = DEV
    ids = torch.from_numpy(ids_np).to(dev)
    cap = 100 if dtype == torch.bfloat16 else 2 ** 20
    table, deltas = exact_case(V, D, ids, dtype, torch.float32,
                               seed=19, cap=cap, sparse=True)
    alpha = scale = None
    if fused:
        alpha, scale, deltas = exact_scaled(ids, V, deltas)
    got = emb._scatter_add_cuda(table.clone(), ids, deltas, alpha, scale)
    torch.cuda.synchronize()
    want = emb._scatter_add_plain(table.clone(), ids, deltas, alpha,
                                  scale)
    if not torch.equal(bits(got), bits(want)):
        n_bad = int((bits(got) != bits(want)).sum())
        fail(f"row_scatter_add chain {tag}: {n_bad} elements differ "
             f"from the plain version")
    w, ok, landed = emb._landing_deltas(table, ids, deltas, alpha, scale)
    wc = torch.where(ok, w, torch.zeros_like(w))
    hits = torch.bincount(wc[ok], minlength=V)
    top = int(torch.argmax(hits))
    hot = ok & (hits[wc] > W2V_HOT_HITS)
    nonzero = ok & (wc == top) & (landed.reshape(w.shape[0], -1) != 0
                                  ).any(dim=1)
    last = int(torch.nonzero(nonzero)[-1])
    for what, drop in (
            (f"the adds of the {int((hits > W2V_HOT_HITS).sum())} rows "
             f"hit over {W2V_HOT_HITS} times", hot),
            (f"one add of row {top}", torch.arange(
                w.shape[0], device=dev) == last)):
        ctl = emb._scatter_add_plain(
            table.clone(), torch.where(drop, V, ids), deltas, alpha,
            scale)
        if torch.equal(bits(got), bits(ctl)):
            fail(f"row_scatter_add chain {tag}: negative control: the "
                 f"plain update without {what} gives the same table")
    say(f"kernel row_scatter_add chain {tag}: bitwise equal on the "
        f"exact grid (cap {cap} nonzero adds an element); row {top} "
        f"hit {int(hits[top])} times, {int(nonzero.sum())} of its adds "
        f"nonzero; the plain update without the rows hit over "
        f"{W2V_HOT_HITS} times, or without one add of row {top}, "
        f"differs (controls)")


def phase_w2v_kernels():
    """Row gather and row scatter-add against their plain versions on the
    card (module docstring, phase 4)."""
    emb = _emb()
    dev = DEV
    rng = np.random.default_rng(7)
    results = {}

    def gather_case(tag, V, D, dtype, ids_np, out_dtype=None):
        table = torch.from_numpy(
            rng.standard_normal((V, D)).astype(np.float32)).to(dev, dtype)
        ids = torch.from_numpy(ids_np).to(dev)
        out = emb._gather_cuda(table, ids, out_dtype)
        torch.cuda.synchronize()
        ref = emb._gather_plain(table, ids, out_dtype)
        if not torch.equal(bits(out), bits(ref)):
            fail(f"row_gather {tag}: differs from the plain version")
        rolled = torch.roll(ids, 1)
        if not torch.equal(rolled, ids) and torch.equal(
                bits(out), bits(emb._gather_plain(table, rolled,
                                                  out_dtype))):
            fail(f"row_gather {tag}: negative control: the rows of the ids "
                 f"rolled by one pass the same check")
        uniq = int(torch.unique(ids).numel())
        nbytes = uniq * D * table.element_size() + ids.numel() * (
            D * out.element_size() + 4)

        def call():
            return emb._gather_cuda(table, ids, out_dtype)

        ms = time_ms(call, iters=20)
        dev_ms, per_call = device_ms(call)
        plain_ms = time_ms(lambda: emb._gather_plain(table, ids, out_dtype),
                           iters=20)
        # the library call has no wrap/NaN rule (a bad id is a device
        # assert): timed on in-range ids only. No one call widens while
        # it gathers: the f32 route's yardstick is two calls, the gather
        # and the cast the word2vec step made before
        lib = None
        if in_range(ids, V):
            lib = ((lambda: torch.index_select(table, 0, ids))
                   if out_dtype is None else
                   (lambda: torch.index_select(table, 0, ids).float()))
        lib_ms = time_ms(lib, iters=20) if lib else None
        lib_dev = device_ms(lib)[0] if lib else None
        r = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                 bound_ms=nbytes / HBM_BYTES_S * 1e3, bound_by="bytes",
                 library_ms=lib_ms if out_dtype is None else None,
                 device_ms=dev_ms, library_device_ms=(
                     lib_dev if out_dtype is None else None))
        if out_dtype is not None:
            r.update(two_call_ms=lib_ms, two_call_device_ms=lib_dev)
        say(f"kernel row_gather {tag}: bitwise equal, unique rows {uniq}, "
            f"ms {ms:.4f} device_ms {dev_ms:.4f} ({per_call:g} kernel "
            f"records a call) plain_ms {plain_ms:.4f} "
            + (f"library_ms {fmt(lib_ms)} device {fmt(lib_dev)}"
               if out_dtype is None else
               f"index_select+float ms {fmt(lib_ms)} device {fmt(lib_dev)}")
            + f" bound_ms {r['bound_ms']:.4f} (bytes)")
        results[("gather", tag)] = r

    def scatter_exact(tag, V, D, dtype, ids_np, delta_dtype=torch.float32,
                      fused=False):
        ids = torch.from_numpy(ids_np).to(dev)
        table, deltas = exact_case(V, D, ids, dtype, delta_dtype, seed=11)
        alpha = scale = None
        if fused:
            alpha, scale, deltas = exact_scaled(ids, V, deltas)
        got = emb._scatter_add_cuda(table.clone(), ids, deltas, alpha, scale)
        torch.cuda.synchronize()
        want = emb._scatter_add_plain(table.clone(), ids, deltas, alpha,
                                      scale)
        if not torch.equal(bits(got), bits(want)):
            n_bad = int((bits(got) != bits(want)).sum())
            fail(f"row_scatter_add exact {tag}: {n_bad} elements differ "
                 f"from the plain version")
        if torch.equal(bits(table), bits(want)):
            fail(f"row_scatter_add exact {tag}: negative control: the "
                 f"plain version left the table unchanged")
        if fused and torch.equal(bits(got), bits(
                emb._scatter_add_plain(table.clone(), ids, deltas))):
            fail(f"row_scatter_add exact {tag}: negative control: the "
                 f"update without alpha and row scale gives the same table")
        w, ok = emb._wrapped(ids, V)
        hits = torch.bincount(w[ok], minlength=V)
        say(f"kernel row_scatter_add exact {tag}: bitwise equal, max hits "
            f"{int(hits.max())}")

    def scatter_real(tag, V, D, dtype, ids_np, delta_dtype=torch.float32,
                     timed=True, fused=False):
        table = torch.from_numpy(((rng.random((V, D)) - 0.5) / D)
                                 .astype(np.float32)).to(dev, dtype)
        # fused: grads that alpha x scale (the bench's -lr, scales in
        # [1/2, 1]) bring to the same N(0, 1e-4) scale as the plain case
        sd = 1e-4 / abs(W2V_ALPHA) if fused else 1e-4
        deltas = torch.from_numpy(
            (rng.standard_normal((ids_np.shape[0], D)) * sd)
            .astype(np.float32)).to(dev, delta_dtype)
        alpha = scale = None
        if fused:
            alpha = W2V_ALPHA
            scale = torch.from_numpy(
                (0.5 + 0.5 * rng.random(V)).astype(np.float32)).to(dev)
        ids = torch.from_numpy(ids_np).to(dev)
        got = emb._scatter_add_cuda(table.clone(), ids, deltas, alpha, scale)
        torch.cuda.synchronize()
        want = emb._scatter_add_plain(table.clone(), ids, deltas, alpha,
                                      scale)
        landed = emb._landing_deltas(table, ids, deltas, alpha, scale)[2]
        hits, absum, _ = scatter_stats(table, ids, landed)
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
        # elements exactly at the bound: ties that round to even in
        # opposite directions in the two orders at every add (PERF.md)
        at_bound = int(((diff == tol) & (tol > 0)).sum())
        line = (f"kernel row_scatter_add {tag}: max_abs_err {err:.3e} "
                f"({ex:.6f} of the tolerance, {at_bound} elements at it; "
                f"unchanged table {control:.3g}")
        if fused:
            unscaled = emb._scatter_add_plain(table.clone(), ids, deltas)
            uctl = excess((unscaled.float() - want.float()).abs()
                          .reshape(flat), tol)
            if not uctl > 1.0:
                fail(f"row_scatter_add {tag}: negative control: the update "
                     f"without alpha and row scale is within the tolerance "
                     f"({uctl:.3f})")
            line += f", unscaled update {uctl:.3g}"
        uniq = int((hits > 0).sum())
        line += (f"), max hits {int(hits.max())}, unique rows {uniq}")
        if timed:
            # every id is read; only an id that lands reads its deltas
            row = D * table.element_size()
            n_land = int(emb._wrapped(ids, V)[1].sum())
            nbytes = (2 * uniq * row + ids.numel() * 4
                      + n_land * D * deltas.element_size()
                      + (4 * uniq if fused else 0))
            work = table.clone()

            def call():
                return emb._scatter_add_cuda(work, ids, deltas, alpha, scale)

            ms = time_ms(call, iters=20)
            dev_ms, per_call = device_ms(call)
            plain_ms = time_ms(lambda: emb._scatter_add_plain(
                work, ids, deltas, alpha, scale), iters=5, warmup=1)
            cast = landed
            lib_ms = lib_dev = None
            lib_ids = ids
            if not in_range(ids, V) and bool((ids >= 0).all()):
                # only dropped ids past the table: the library call takes
                # the in-range ones, the adds the function makes
                keep = ids < V
                lib_ids, cast = ids[keep], landed[keep]
            if in_range(lib_ids, V):
                def lib():
                    return work.index_add_(0, lib_ids, cast)
                lib_ms = time_ms(lib, iters=20)
                lib_dev = device_ms(lib)[0]
            r = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=nbytes / HBM_BYTES_S * 1e3, bound_by="bytes",
                     library_ms=lib_ms, device_ms=dev_ms,
                     library_device_ms=lib_dev)
            results[("scatter", tag)] = r
            line += (f", ms {ms:.4f} device_ms {dev_ms:.4f} ({per_call:g} "
                     f"kernel records a call) plain_ms {plain_ms:.4f} "
                     f"library_ms {fmt(lib_ms)} device {fmt(lib_dev)} "
                     f"bound_ms {r['bound_ms']:.4f} (bytes)")
        say(line)

    V, D = W2V_VOCAB, W2V_DIM
    f32 = torch.float32
    # centers/targets, and the B/G x K negatives
    for n in (W2V_BATCH, W2V_BATCH // W2V_G * 5):
        ids = zipf_ids(rng, V, n)
        for dt in (torch.bfloat16, f32):
            name = f"path n={n} {str(dt).split('.')[-1]}"
            gather_case(name, V, D, dt, ids)
            scatter_real(name, V, D, dt, ids)
            scatter_exact(name, V, D, dt, ids)
        # what the word2vec step runs on its bf16 tables: rows widened to
        # f32, and f32 grads scaled by -lr x the row's scale
        name = f"path n={n} bfloat16 -> float32"
        gather_case(name, V, D, torch.bfloat16, ids, out_dtype=f32)
        name = f"fused path n={n} bfloat16"
        scatter_real(name, V, D, torch.bfloat16, ids, fused=True)
        scatter_exact(name, V, D, torch.bfloat16, ids, fused=True)
    # duplicate-free: every row hit once, so the tolerance is 0 (bitwise)
    for dt in (torch.bfloat16, f32):
        uniq_ids = rng.permutation(V)[:5120].astype(np.int32)
        scatter_real(f"unique n=5120 {str(dt).split('.')[-1]}", V, D, dt,
                     uniq_ids, timed=False)
    # bf16 deltas into a bf16 table, ids with wrap and drop
    odd = zipf_ids(rng, V, 4096)
    odd[:64] = -1 - odd[:64]           # negative: wraps
    odd[64:96] = V + 5                 # out of range: dropped / NaN row
    gather_case("wrap+oob n=4096 bfloat16", V, D, torch.bfloat16, odd)
    gather_case("wrap+oob n=4096 bfloat16 -> float32", V, D, torch.bfloat16,
                odd, out_dtype=f32)
    scatter_real("wrap+drop n=4096 bf16 deltas", V, D, torch.bfloat16, odd,
                 delta_dtype=torch.bfloat16, timed=False)
    scatter_exact("wrap+drop n=4096 bf16 deltas", V, D, torch.bfloat16, odd,
                  delta_dtype=torch.bfloat16)
    # the fused scale read at wrapped ids, never at dropped ones; the
    # exact-grid table's bf16 grads (the step's G = 1 raw-sum case)
    scatter_exact("fused wrap+drop n=4096 bf16 deltas", V, D,
                  torch.bfloat16, odd, delta_dtype=torch.bfloat16,
                  fused=True)
    scatter_exact("fused wrap+drop n=4096 float32", V, D, f32, odd,
                  fused=True)
    # the probe's shape (w2v_kernel_probe.py:61-82) and K1b's (:231-252)
    probe_ids = zipf_ids(np.random.default_rng(7), 71296, 204800)
    probe = "probe V=71296 D=256 N=204800 float32"
    gather_case(probe, 71296, 256, f32, probe_ids)
    scatter_real(probe, 71296, 256, f32, probe_ids)
    scatter_exact(probe, 71296, 256, f32, probe_ids)
    gather_case("k1b V=64 D=256 N=8 float32", 64, 256, f32,
                rng.integers(0, 64, 8).astype(np.int32))
    # phase 12's shapes: the Huffman path nodes of 65,536 zipf targets
    # (the bench counts' codes, pad slots included: node 0, zero deltas on
    # the path) and the 2W = 10 context slots of 65,536 CBOW examples;
    # f32 deltas, the fused route, held by rule (b), and the long chains
    # (the root node's 65,536 adds a call) bitwise on the exact grid
    huff = w2v_corpus()["huffman"]
    targets = zipf_ids(rng, V, W2V_BATCH)
    # the step gathers every slot (pads read node 0) and scatters only the
    # slots with a gradient: the pads' ids are past the table (dropped)
    hs_gather = huff.paths[targets].reshape(-1)
    hs_scatter = np.where(huff.mask[targets] > 0, huff.paths[targets],
                          V).astype(np.int32).reshape(-1)
    cbow_ids = zipf_ids(rng, V, W2V_BATCH * 10)
    for name, g_ids, s_ids in ((W2V_HS, hs_gather, hs_scatter),
                               (W2V_CBOW, cbow_ids, cbow_ids)):
        gather_case(name + " bfloat16 -> float32", V, D, torch.bfloat16,
                    g_ids, out_dtype=f32)
        scatter_real("fused " + name + " bfloat16", V, D, torch.bfloat16,
                     s_ids, fused=True)
        scatter_chain(name + " float32", V, D, f32, s_ids, fused=False)
        scatter_chain("fused " + name + " bfloat16", V, D, torch.bfloat16,
                      s_ids, fused=True)
    path_ids = zipf_ids(rng, V, W2V_BATCH)
    graph_replay(V, D, path_ids)
    one_row_view(D)
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

        def recording(table, ids, deltas, alpha=None, row_scale=None):
            landed = emb._landing_deltas(table, ids, deltas, alpha,
                                         row_scale)[2]
            got = scatter_stats(table, ids, landed)
            seen = stats[table.data_ptr()]
            stats[table.data_ptr()] = got if seen is None else tuple(
                a + b for a, b in zip(seen, got))
            return plain(table, ids, deltas, alpha, row_scale)

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
    wall_ms, busy_ms, table, n_dev = profile_kernels(
        lambda: float(model.train_device_steps(W2V_STEPS)[0]))
    say(f"w2v profile of one {W2V_STEPS}-step call: wall {wall_ms:.3f} "
        f"ms (profiler on), device busy {busy_ms:.3f} ms "
        f"({busy_ms / wall_ms:.3f} of wall), {n_dev} device kernels "
        f"({n_dev / W2V_STEPS:.2f} a step); top 10 by device "
        f"time:\n{table}")
    return {"launches": launches, "pairs_per_sec": res["pairs_per_sec"],
            "dispatch_ms": res["dispatch_ms"],
            "kernels_per_step": n_dev / W2V_STEPS}


# phase 12: word2vec completion, every single-process option of the JAX
# config on the bench corpus and width (bench.py:148-154)
W2V_OPT_ITERS = 5
# how each configuration's loss must move over the held step, the warm
# call and the timed calls: "falls", the last call at least W2V_FALL
# (relative) under the held step; "peak", at least W2V_FALL under the
# highest call (AdaGrad's first updates move every touched element by
# ~lr, and its loss rises first); "flat", not W2V_FALL over the held step.
# Realized row-mean, the JAX auto rule's choice for CBOW and the host
# stream, leaves the loss of the iid bench corpus at its init for hundreds
# of steps, in the JAX package too (tools/w2v_loss_witness.py)
W2V_FALL = 1e-3
W2V_OPT_CONFIGS = (
    # tag, the Word2VecConfig fields that differ from the bench's, whether
    # the config's updates go through the scatter kernel (segsum and
    # split8 apply them with index_add_ into an f32 buffer), the loss rule,
    # and the steps after the held step that the card and the CPU twin
    # take with the same draws (the witness of a loss that does not fall)
    ("a cbow+ns", dict(cbow=True), True, "flat", 4),
    ("b hs", dict(hs=True, negative=0), True, "falls", 0),
    ("c hs+ns", dict(hs=True), True, "falls", 0),
    ("d adagrad", dict(use_adagrad=True), True, "peak", 4),
    ("e segsum", dict(update_impl="segsum"), False, "falls", 0),
    ("f split8", dict(update_impl="split8"), False, "falls", 0),
    ("g cbow gather", dict(cbow=True, compact_impl="gather"), True, "flat",
     0),
)
W2V_HOST_CONFIGS = (("h host skip-gram", dict()),
                    ("h host cbow", dict(cbow=True)))
# the witness's loss, card against the CPU twin, relative: the two start
# from tables that differ within phase 5's rule, and AdaGrad's hot rows
# then move by ~lr a duplicate, which magnifies each rounding difference
# (its third step read 7.3772 on an H100 against 7.3861 on the CPU, 1.2e-3
# apart, on a rise from 4.159); 1e-2 still tells a rise of 77% apart
W2V_WITNESS_TOL = 1e-2
_W2V_CORPUS = {}


def w2v_corpus():
    """The bench corpus, its dictionary, encoding, discard law and Huffman
    codes, built once."""
    if not _W2V_CORPUS:
        from multiverso_tpu_torch import bench
        from multiverso_tpu_torch.apps.wordembedding import (
            Dictionary, encode_corpus, subsample_probs)
        from multiverso_tpu_torch.models.word2vec import build_huffman

        path = str(bench.corpus_file(W2V_WORDS, W2V_VOCAB))
        d = Dictionary.build(path, min_count=1)
        counts = np.asarray(d.counts, np.float64)
        ids, sents = encode_corpus(path, d)
        _W2V_CORPUS.update(
            path=path, dictionary=d, counts=counts, ids=ids, sents=sents,
            discard=subsample_probs(counts, 1e-3).astype(np.float32),
            huffman=build_huffman(counts))
    return _W2V_CORPUS


def w2v_option_model(overrides, device_corpus: bool = True):
    """A bench-configuration Word2Vec (bf16 tables, batch 65,536, G 64, a
    2^22 negative pool, oversample 2.5) with ``overrides``; row-mean by the
    JAX trainer's auto rule, static where JAX allows it (skip-gram SGD on
    the device corpus)."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.apps.wordembedding import _auto_row_mean
    from multiverso_tpu_torch.models.word2vec import Word2Vec, Word2VecConfig

    c = w2v_corpus()
    kw = dict(vocab_size=W2V_VOCAB, embedding_size=W2V_DIM, window=5,
              negative=5, init_lr=0.025, batch_size=W2V_BATCH,
              oversample=2.5, neg_pool_size=1 << 22, shared_negatives=W2V_G)
    kw.update(overrides)
    cfg = Word2VecConfig(**kw)
    cfg.row_mean_updates = _auto_row_mean(cfg, c["counts"])
    cfg.row_mean_static = (cfg.row_mean_updates and device_corpus
                           and not (cfg.cbow or cfg.hs or cfg.use_adagrad))
    w_in = mv.create_table("matrix", W2V_VOCAB, W2V_DIM,
                           init_value="random", dtype=torch.bfloat16)
    w_out = mv.create_table("matrix", W2V_VOCAB, W2V_DIM,
                            dtype=torch.bfloat16)
    model = Word2Vec(cfg, w_in, w_out, counts=c["counts"],
                     huffman=c["huffman"] if cfg.hs else None)
    model.total_words = 10 ** 9
    if device_corpus:
        model.load_corpus_chunk(c["ids"], c["sents"], c["discard"])
    return model


def w2v_cpu_twin(model):
    """A Word2Vec on CPU copies of ``model``'s tables, accumulators, corpus
    buffers, scales and lr progress, for the held step."""
    import dataclasses

    from multiverso_tpu_torch.models.word2vec import Word2Vec, tables_from_jax

    cfg = dataclasses.replace(model.config)
    c_in, c_out = tables_from_jax(model.input_table.get(),
                                  model.output_table.get(), device="cpu",
                                  dtype=model.input_table._data.dtype)
    cpu = Word2Vec(cfg, c_in, c_out, counts=model._host_counts,
                   huffman=w2v_corpus()["huffman"] if cfg.hs else None)
    cpu.total_words = model.total_words
    cpu._words_trained = model._words_trained
    if hasattr(model, "_ext_bufs"):
        cpu._ext_bufs = tuple(b.cpu() for b in model._ext_bufs)
        cpu._corpus_len = model._corpus_len
        cpu._stream_pos = model._stream_pos
    if model._static_scale_in is not None:
        cpu._static_scale_in = model._static_scale_in.cpu()
        cpu._static_scale_out = model._static_scale_out.cpu()
    if cfg.use_adagrad:
        cpu._g_in = model._g_in.cpu().clone()
        cpu._g_out = model._g_out.cpu().clone()
    return cpu


def w2v_state(model):
    """The tensors one step changes, by name, on the model's device."""
    out = {"w_in": model.input_table._data, "w_out": model.output_table._data}
    if model.config.use_adagrad:
        out.update(g_in=model._g_in, g_out=model._g_out)
    return out


def w2v_recorded_step(cpu, step):
    """Run ``step()`` on the CPU twin, recording for each state tensor its
    update statistics (:func:`scatter_stats`: hits, sum |delta| as landed,
    the sum of each update's largest |delta|): from the plain scatter-add
    or, for segsum / split8, from the f32 updates summed into the dense
    buffer. Returns the step's result, the stats and the CPU seconds."""
    from multiverso_tpu_torch.models.word2vec import _at

    emb = _emb()
    state = w2v_state(cpu)
    names = {t.data_ptr(): n for n, t in state.items()}
    stats = {}
    plain = emb._scatter_add_plain
    dense = cpu._apply_dense

    def add(table, as_table, ids, landed):
        name = names[table.data_ptr()]
        got = scatter_stats(as_table, ids, landed)
        seen = stats.get(name)
        stats[name] = got if seen is None else tuple(
            a + b for a, b in zip(seen, got))

    def recording(table, ids, deltas, alpha=None, row_scale=None):
        add(table, table, ids, emb._landing_deltas(table, ids, deltas,
                                                   alpha, row_scale)[2])
        return plain(table, ids, deltas, alpha, row_scale)

    def recording_dense(w, rows, grads, lr, scale):
        # the f32 updates as summed: stats over an f32 view of the table
        coef = -lr if scale is None else (_at(scale, rows) * -lr)[:, None]
        add(w, w.float(), rows, coef * grads.float())
        return dense(w, rows, grads, lr, scale)

    emb._scatter_add_plain = recording
    cpu._apply_dense = recording_dense
    try:
        t0 = time.perf_counter()
        result = step()
        secs = time.perf_counter() - t0
    finally:
        emb._scatter_add_plain = plain
        del cpu._apply_dense
    return result, stats, secs


def w2v_hold_change(tag, model, cpu, before, stats, dense: bool):
    """Phase 5's rule on every state tensor: the card's change (after -
    before) against the CPU's, each element within h x ulp(A') + 1e-4 x
    the row's sum of largest |delta| (+ 2^-7 x sum |delta| in bf16, a
    delta rounding to the other neighbour) for the scatter; for the dense
    impls, whose f32 sums round once to the table, 1 ulp(A') of the table
    dtype + the f32 sums' h x ulp(A') + 1e-4 x the row's sum of largest
    |delta|. A change of nothing must fail it. Returns the share of the
    tolerance reached by name."""
    worst = {}
    card_state, cpu_state = w2v_state(model), w2v_state(cpu)
    for name, b in before.items():
        dtype = b.dtype
        hits, absum, rowscale = stats[name]
        bf = b.float()
        V = bf.shape[0]
        if dense and name in ("w_in", "w_out"):
            A = bf.abs().reshape(V, -1) + absum
            tol = (ulp(A + ulp(A, dtype), dtype)
                   + sum_ulp(bf, hits, absum, torch.float32)
                   + 1e-4 * rowscale[:, None])
        else:
            flip = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
            tol = (sum_ulp(bf, hits, absum, dtype) + flip * absum
                   + 1e-4 * rowscale[:, None])
        d_card = card_state[name].float().cpu() - bf
        d_cpu = cpu_state[name].float() - bf
        diff = (d_card - d_cpu).abs()
        worst[name] = excess(diff, tol)
        control = excess(d_cpu.abs(), tol)
        if not (worst[name] <= 1.0 and torch.isfinite(d_card).all()):
            i = int(torch.argmax(torch.where(
                tol > 0, diff / tol.clamp(min=1e-38), diff * float("inf"))))
            v, e = divmod(i, W2V_DIM)
            fail(f"w2v {tag} held step {name}: change {worst[name]} x the "
                 f"tolerance; worst at row {v} col {e}: before "
                 f"{bf[v, e].item():.6e} change card "
                 f"{d_card[v, e].item():.6e} cpu {d_cpu[v, e].item():.6e} "
                 f"hits {hits[v].item():.0f} tol {tol[v, e].item():.6e}")
        if not control > 1.0:
            fail(f"w2v {tag} held step {name}: negative control: no change "
                 f"is within the tolerance ({control:.3f})")
        worst[name + "_control"] = control
    return worst


def w2v_check_packing(model, draws):
    """(g): the gather compaction packs this step's CBOW batch bit for bit
    as the scatter compaction does on the same draws; the scatter packing
    of the next slab must differ (the control)."""
    M = model._candidate_batch(model._corpus_len)
    start = model._stream_pos % model._corpus_len
    args = (draws["shrink"][0], draws["u_center"][0], draws["u_ctx"][0])
    got = model._sample_cbow(start, M, *args)
    model.config.compact_impl = "scatter"
    try:
        want = model._sample_cbow(start, M, *args)
        other = model._sample_cbow((start + M) % model._corpus_len, M, *args)
    finally:
        model.config.compact_impl = "gather"
    for g, w in zip(got, want):
        if g.dtype != w.dtype or not torch.equal(g, w):
            fail("w2v (g): the gather compaction's batch differs from the "
                 "scatter compaction's on the same draws")
    if all(torch.equal(g, o) for g, o in zip(got, other)):
        fail("w2v (g): negative control: the next slab packs the same batch")
    return int((got[2].sum(dim=1) > 0).sum())


def w2v_host_stream(model, cbow: bool):
    """The host-stream batches of ``apps.wordembedding.train``
    (``iter_pair_batches`` on the loader thread), epoch after epoch."""
    from multiverso_tpu_torch.apps.wordembedding import iter_pair_batches
    from multiverso_tpu_torch.parallel import prefetch_iterator

    c = w2v_corpus()
    cfg = model.config

    def epochs():
        epoch = 0
        while True:
            yield from iter_pair_batches(
                c["path"], c["dictionary"], cfg.window, cfg.batch_size,
                sample=1e-3, cbow=cbow, seed=cfg.seed + epoch)
            epoch += 1

    return prefetch_iterator(epochs(), depth=2 * W2V_STEPS)


def w2v_examples(mask: np.ndarray, cbow: bool) -> float:
    return float((mask.sum(axis=-1) > 0).sum() if cbow else mask.sum())


def w2v_held_step(tag, model, stream):
    """One step of ``model`` on the card and on its CPU twin with the same
    draws (for the host stream: the stream's next batch and the same
    negatives), every state tensor's change held by
    :func:`w2v_hold_change`; for the gather compaction, the packing too.
    The output table is first set like the random init (+-0.5/D), as in
    phase 5, so the step moves the input table too. Returns the card's
    loss and the CPU twin."""
    from multiverso_tpu_torch.models.word2vec import sample_negatives

    cfg = model.config
    dense = cfg.update_impl != "scatter" and not cfg.use_adagrad
    model.output_table.set_array(torch.from_numpy(
        ((np.random.default_rng(3).random((W2V_VOCAB, W2V_DIM)) - 0.5)
         / W2V_DIM).astype(np.float32)))
    before = {n: t.detach().cpu().clone()
              for n, t in w2v_state(model).items()}
    cpu = w2v_cpu_twin(model)
    packed = ""
    if stream is None:
        draws = model.draw(1)
        if cfg.compact_impl == "gather":
            n_ex = w2v_check_packing(model, draws)
            packed = (f"; gather packing bitwise equal to the scatter "
                      f"packing ({n_ex} examples)")
        t0 = time.perf_counter()
        loss, count = model.train_device_steps(1, draws=draws)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        (closs, ccount), stats, cpu_s = w2v_recorded_step(
            cpu, lambda: cpu.train_device_steps(
                1, draws={k: v.cpu() for k, v in draws.items()}))
    else:
        cen, ctx, msk = next(stream)
        G = max(cfg.shared_negatives, 1)
        negs = sample_negatives(model._gen, model._packed_alias,
                                (cfg.batch_size // G, cfg.negative))
        lr = float(np.float32(model.current_lr()))
        tens = [torch.from_numpy(np.asarray(a)) for a in (cen, ctx, msk)]

        def host_step(m, ts, ng):
            return m._raw_step(m.input_table._data, m.output_table._data,
                               *ts, lr, ng)

        t0 = time.perf_counter()
        loss = host_step(model, [t.to(DEV) for t in tens], negs)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        closs, stats, cpu_s = w2v_recorded_step(
            cpu, lambda: host_step(cpu, tens, negs.cpu()))
        count = ccount = w2v_examples(msk, cfg.cbow)
    worst = w2v_hold_change(tag, model, cpu, before, stats, dense)
    lerr = abs(float(loss) - float(closs))
    if float(count) != float(ccount) or not lerr <= 1e-4:
        fail(f"w2v {tag} held step: count {float(count)} vs "
             f"{float(ccount)}, loss {float(loss)} vs {float(closs)}")
    shares = " ".join(f"{n} {worst[n]:.3e} (no change "
                      f"{worst[n + '_control']:.3g})" for n in before)
    rm = ("static" if cfg.row_mean_static else
          "realized" if cfg.row_mean_updates else "off")
    say(f"w2v {tag} held step (batch {cfg.batch_size}, row-mean {rm}): "
        f"examples {float(count):.0f}, loss {float(loss):.6f} vs cpu "
        f"{float(closs):.6f}; change, share of the tolerance: {shares}"
        f"{packed}; host clock card {card_s:.3f} s (first step, cold), "
        f"cpu {cpu_s:.3f} s")
    return loss, cpu


def w2v_witness(tag, model, cpu, steps: int):
    """``steps`` single steps on the card and on the CPU twin (the plain
    route), each from where the held step left it, with the same draws:
    each step's loss on the card within W2V_WITNESS_TOL (relative) of the
    CPU's. Shows that a loss which does not fall, or rises, does so on
    the plain route too. Returns the two series."""
    card, plain = [], []
    for _ in range(steps):
        draws = model.draw(1)
        card.append(float(model.train_device_steps(1, draws=draws)[0]))
        plain.append(float(cpu.train_device_steps(
            1, draws={k: v.cpu() for k, v in draws.items()})[0]))
    worst = max(abs(a - b) / abs(b) for a, b in zip(card, plain))
    if not worst <= W2V_WITNESS_TOL:
        fail(f"w2v {tag} witness: the loss of {steps} steps on the card "
             f"{card} vs the CPU twin {plain}")
    say(f"w2v {tag} witness: {steps} more steps from the held step's "
        f"tables, the same draws: loss card {card} cpu {plain} (worst "
        f"{worst:.3e} relative, tolerance {W2V_WITNESS_TOL:g})")
    return card, plain


def phase_w2v_options(card: str):
    """12. word2vec completion: every single-process option of the JAX
    config at the bench width (module docstring, phase 12). Returns each
    configuration's launches by kernel."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import bench

    emb = _emb()
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    c = w2v_corpus()
    say(f"w2v options: bench corpus {W2V_WORDS} words, vocab "
        f"{c['dictionary'].vocab_size}, Huffman depth "
        f"{int(c['huffman'].mask.sum(1).max())}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    results = {}
    configs = [(tag, o, k, rule, n, True)
               for tag, o, k, rule, n in W2V_OPT_CONFIGS]
    configs += [(tag, o, True, "flat", 0, False)
                for tag, o in W2V_HOST_CONFIGS]
    steps = W2V_STEPS
    for tag, overrides, scatters, rule, n_wit, device_corpus in configs:
        # host seconds by part: set-up, held step, witness, timed run,
        # sync check and profile
        marks = [time.perf_counter()]
        model = w2v_option_model(overrides, device_corpus)
        cfg = model.config
        stream = (None if device_corpus
                  else w2v_host_stream(model, cfg.cbow))
        marks.append(time.perf_counter())
        # 1. one held step, card against the CPU twin, the same draws,
        # and for a loss that does not fall, the witness steps
        loss, cpu = w2v_held_step(tag, model, stream)
        marks.append(time.perf_counter())
        witness = w2v_witness(tag, model, cpu, n_wit)[0] if n_wit else []
        del cpu
        marks.append(time.perf_counter())
        # 2. the timed run, the kernels' launches counted around it
        torch.cuda.synchronize()
        emb.reset_launches()
        # the loss series starts at the held step, the first from the init
        losses = [float(loss)]
        if device_corpus:
            res = bench.timed_window(model, steps, W2V_OPT_ITERS)
            losses += [res["warm_loss"]] + res["losses"]
            n_ex, elapsed = res["pairs"], res["elapsed_s"]

            def one_call():
                return model.train_device_steps(steps)
        else:
            def one_call():
                group = [next(stream) for _ in range(steps)]
                loss = model.train_batches(*(np.stack([b[i] for b in group])
                                             for i in range(3)))
                return loss, sum(w2v_examples(b[2], cfg.cbow) for b in group)

            losses.append(float(one_call()[0]))
            n_ex = 0.0
            t0 = time.perf_counter()
            pending = []
            for _ in range(W2V_OPT_ITERS):
                loss, n = one_call()
                pending.append(loss)
                n_ex += n
            losses += [float(x) for x in pending]
            elapsed = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(emb.LAUNCHES)
        unit = "examples" if cfg.cbow else "pairs"
        say(f"w2v {tag}: {W2V_OPT_ITERS} x {steps}-step calls after one "
            f"warm call: {n_ex:.0f} {unit} in {elapsed:.3f} s = "
            f"{n_ex / elapsed:.1f} {unit}/s, "
            f"{elapsed / W2V_OPT_ITERS * 1e3:.3f} ms per call; loss of the "
            f"held step and of each call {losses}; "
            f"launches {json.dumps(launches)}; card {card}")
        # the loss rule (W2V_OPT_CONFIGS)
        top = max(losses + witness)
        moved = {"falls": losses[-1] <= losses[0] * (1 - W2V_FALL),
                 "peak": losses[-1] <= top * (1 - W2V_FALL),
                 "flat": losses[-1] <= losses[0] * (1 + W2V_FALL)}[rule]
        if not (np.isfinite(losses + witness).all() and moved):
            fail(f"w2v {tag}: loss not finite or not as the rule "
                 f"{rule!r} asks: {losses}")
        say(f"w2v {tag}: loss rule {rule!r}: last call {losses[-1]:.6f}, "
            f"held step {losses[0]:.6f}, highest {top:.6f} (relative fall "
            f"{1 - losses[-1] / losses[0]:.3e} from the held step, "
            f"{1 - losses[-1] / top:.3e} from the highest)")
        if n_ex <= 0:
            fail(f"w2v {tag}: trained nothing")
        if launches["row_gather"] <= 0 or (
                (launches["row_scatter_add"] > 0) != scatters):
            fail(f"w2v {tag}: kernel launches {launches} (the scatter "
                 f"kernel {'expected' if scatters else 'not expected'})")
        # 3. no host sync inside a call
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        torch.cuda.set_sync_debug_mode("error")
        try:
            one_call()
        except RuntimeError as exc:
            fail(f"w2v {tag}: a call synchronized with the host: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        wall_ms, busy_ms, table, n_dev = profile_kernels(
            lambda: float(one_call()[0]), rows=5)
        say(f"w2v {tag}: sync check passed (one {steps}-step call under "
            f"set_sync_debug_mode('error')); profile of one call: wall "
            f"{wall_ms:.3f} ms (profiler on), device busy {busy_ms:.3f} ms "
            f"({busy_ms / wall_ms:.3f} of wall), {n_dev / steps:.2f} device "
            f"kernels a step; top 5 by device time:\n{table}")
        results[tag] = launches
        marks.append(time.perf_counter())
        parts = " / ".join(f"{b - a:.1f}" for a, b in zip(marks, marks[1:]))
        say(f"w2v {tag}: {marks[-1] - marks[0]:.1f} s (set-up / held step / "
            f"witness / timed run / sync check and profile: {parts})")
        del model
        mv.session().tables.clear()
        torch.cuda.empty_cache()
    say(f"w2v options: phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return results


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_device()
    fwd_results, serve_counts = lm_phases(card)
    bwd, train_counts = lm_train_phases(card)
    kernels_line = fwd_entries(fwd_results, serve_counts, train_counts) + bwd
    wk = phase_w2v_kernels()
    import multiverso_tpu_torch as mv

    mv.init(["chip_smoke", "-device=cuda"])
    phase_w2v_step()
    w2v = phase_w2v_slice(card)
    options = phase_w2v_options(card)
    mv.shutdown()
    n_g = w2v["launches"]["row_gather"]
    n_s = w2v["launches"]["row_scatter_add"]
    for name, r, line, n in (
            ("row_gather", wk[("gather", W2V_PATH)], 95, n_g),
            ("row_gather[f32 out]",
             wk[("gather", W2V_PATH + " -> float32")], 95, n_g),
            ("row_gather[k1b]",
             wk[("gather", "k1b V=64 D=256 N=8 float32")], 231, n_g),
            ("row_scatter_add", wk[("scatter", W2V_PATH)], 157, n_s),
            ("row_scatter_add[fused]",
             wk[("scatter", "fused " + W2V_PATH)], 157, n_s)):
        entry = {"name": name, "route": "cuda",
                 "source": W2V_SRC[name.split("[")[0]],
                 "replaces": f"{PROBE}:{line}", "launches": n, **r}
        if "[" in name:
            # one kernel's route or shape: K1b's 8 rows the path never
            # gives it, the f32-out gather and the fused scatter that the
            # path runs; the launches are the kernel's, all at the path's
            # shapes
            entry["launches_of"] = name.split("[")[0]
        # phase 12's configurations, each counted from 0 around its run
        kernel = name.split("[")[0]
        entry["launches_completion"] = {
            tag: launches[kernel] for tag, launches in options.items()}
        kernels_line.append(entry)
    # phase 12's shapes of the two routes the word2vec step runs
    for entry in kernels_line:
        kind, route = {"row_gather[f32 out]": ("gather", " -> float32"),
                       "row_scatter_add[fused]": ("scatter", "fused ")}.get(
                           entry["name"], (None, None))
        if kind is None:
            continue
        for key, shape in (("hs_nodes", W2V_HS), ("cbow_ctx", W2V_CBOW)):
            tag = (shape + " bfloat16" + route if kind == "gather"
                   else route + shape + " bfloat16")
            r = wk[(kind, tag)]
            entry.update({f"{key}_{k}": r[k] for k in (
                "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                "library_ms", "library_device_ms")})
            if kind == "gather":
                entry[f"{key}_two_call_ms"] = r["two_call_ms"]
    # phase 11's own launches (the micro-batcher's flash prefills and row
    # gathers, train-while-serving's one-pass backward), each counted
    # from 0 just before its sub-phase
    surface = serve_counts["surface"]
    for entry in kernels_line:
        key = {"flash_fwd[key_len<=1024]": "flash_fwd",
               "flash_bwd[fused]": "flash_bwd_fused",
               "row_gather": "row_gather"}.get(entry["name"])
        if key is not None:
            entry["launches_surface"] = surface[key]
    # phase 13's flash launches, summed over the fleet's replicas
    for entry in kernels_line:
        regime = {"flash_fwd[key_len<=1024]": "short",
                  "flash_fwd[key_len>1024]": "long"}.get(entry["name"])
        if regime is not None:
            entry["launches_fleet"] = serve_counts["fleet"][regime]
    # phase 14's launches: the planes' serving, tables and training step
    for entry in kernels_line:
        key = {"flash_fwd[key_len<=1024]": "flash_fwd_short",
               "flash_fwd[key_len>1024]": "flash_fwd_long",
               "row_gather": "row_gather",
               "row_scatter_add": "row_scatter_add",
               "flash_bwd[fused]": "flash_bwd_fused"}.get(entry["name"])
        if key is not None:
            entry["launches_planes"] = serve_counts["planes"].get(key, 0)
    say(f"chip_smoke: the whole script took "
        f"{time.perf_counter() - T_START:.1f} s, card {card_line()}")
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def lm_phases(card: str):
    """Phases 2-3, the crossover, phase 10, phase 11, phase 13 and phase
    14; the forward's results, the serving run's launches by regime,
    phase 11's launches by kernel, phase 13's by regime and phase 14's by
    kernel."""
    results = phase_kernels()
    phase_crossover()
    served = phase_slice(card)
    phase_defaults(card, served["prompts"], served["oracle"])
    served["surface"] = phase_serving_surface(card, served["prompts"])
    served["fleet"] = phase_fleet(card, served["prompts"], served["oracle"])
    served["planes"] = phase_planes(card, served["prompts"])
    return results, served


def lm_train_phases(card: str):
    """Phases 7-9; the kernels line's entries of the backward kernels and
    the training run's bf16 forward launches by regime."""
    results = phase_bwd_kernels()
    phase_grad_check()
    launches, bf16_fwd = phase_lm_train(card)
    entries = []
    for kind in ("fused", "dq", "dkv"):
        entries.append({
            "name": f"flash_bwd[{kind}]", "route": "cuda", "source": FB_SRC,
            "replaces": f"{FA_JAX}:{FB_JAX_LINES[kind]}",
            "launches": launches[kind], **results[kind]})
    return entries, bf16_fwd


def fwd_entries(results, serve_counts, train_counts):
    """The kernels line's forward entries: K3 (key length <= 1024) and K4
    (> 1024), each at the serving path's batch-1 shape, with the training
    path's shape (B 8 x S 1024, B 4 x S 2048) beside it."""
    entries = []
    for name, regime, line in (("flash_fwd[key_len<=1024]", "short", 165),
                               ("flash_fwd[key_len>1024]", "long", 83)):
        r, tr = results[f"serve_{regime}"], results[f"train_{regime}"]
        case = next(c for c in FA_CASES if c["name"] == f"train_{regime}")
        entries.append({
            "name": name, "route": "cuda", "source": FA_SRC,
            "replaces": f"{FA_JAX}:{line}",
            "launches": serve_counts[regime],
            "launches_train": train_counts[regime],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "design": FB_DESIGN[torch.bfloat16],
            "train_shape": f"B {case['B']} x S {case['sk']}",
            "train_ms": tr["ms"], "train_tflops": tr["tflops"],
            "train_library_ms": tr["library_ms"],
            "train_bound_ms": tr["bound_ms"],
            "train_bound_by": tr["bound_by"]})
    # phase 11's micro-batched prefill runs K3 at its own shape
    sr = results["surface_lmg"]
    case = next(c for c in FA_CASES if c["name"] == "surface_lmg")
    entries[0].update({
        "surface_shape": f"B {case['B']} x S {case['sk']}",
        "surface_max_abs_err": sr["max_abs_err"], "surface_ms": sr["ms"],
        "surface_plain_ms": sr["plain_ms"],
        "surface_bound_ms": sr["bound_ms"],
        "surface_library_ms": sr["library_ms"]})
    return entries


if __name__ == "__main__":
    main()
