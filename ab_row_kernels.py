"""Parent against change on one card: each tree's whole chip smoke test,
then the word2vec row kernels through the entry points both trees share,
in the order parent, change, change, parent.

    python3 ab_row_kernels.py PARENT_DIR OUT_DIR

PARENT_DIR is an unpacked checkout of the parent commit (``git archive``);
the directory of this script is the change. For each tree, in that order,
each step in a new process:

1. ``python3 chip_smoke.py`` from the tree's root (OUT_DIR/<tag>.log);
2. :func:`row_kernel_timers` on the tree's package: K1, K1b and K2 at
   chip_smoke's phase-4 shapes, each with both timers (``time_ms``, host
   included, and ``device_ms``, the CUPTI kernel durations) beside
   index_select / index_add_; then, on the parent, the change's word2vec
   slice phase on the parent's package (its device kernels per step, which
   the parent's own script does not print) and, on the change,
   :func:`launch_path`, the gather's launch path at K1b's shape by part
   (OUT_DIR/<tag>_extra.log).

It prints the timers', launch path's and word2vec slice's lines of every
run and exits nonzero if any step failed.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def host_us(fn, n: int = 2000) -> float:
    """Host microseconds a call of ``fn`` takes, over ``n`` calls issued
    back to back (the card, faster than the host at these shapes, waits)."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / n * 1e6


def row_kernel_timers(cs):
    """K1, K1b and K2 through ``embedding_lookup(table, ids)`` and
    ``scatter_add_rows(table, ids, deltas)``, the entry points that both
    trees share, at phase 4's shapes (65,536 zipf ids into bf16
    [71291, 200] with f32 deltas; 8 ids into f32 [64, 256]), each with
    both timers beside index_select / index_add_. ``cs`` is chip_smoke."""
    import numpy as np
    import torch
    from multiverso_tpu_torch.ops.embedding import (embedding_lookup,
                                                    scatter_add_rows)

    dev = cs.DEV
    rng = np.random.default_rng(7)
    V, D = cs.W2V_VOCAB, cs.W2V_DIM
    ids = torch.from_numpy(cs.zipf_ids(rng, V, cs.W2V_BATCH)).to(dev)
    table = torch.from_numpy(rng.standard_normal((V, D)).astype(
        np.float32)).to(dev, torch.bfloat16)
    deltas = torch.from_numpy((rng.standard_normal((cs.W2V_BATCH, D))
                               * 1e-4).astype(np.float32)).to(dev)
    cast = deltas.to(torch.bfloat16)
    small = torch.randn(64, 256, device=dev)
    small_ids = torch.from_numpy(rng.integers(0, 64, 8).astype(
        np.int32)).to(dev)
    cases = {
        "K1": (lambda: embedding_lookup(table, ids),
               lambda: torch.index_select(table, 0, ids)),
        "K1b": (lambda: embedding_lookup(small, small_ids),
                lambda: torch.index_select(small, 0, small_ids)),
        "K2": (lambda: scatter_add_rows(table, ids, deltas),
               lambda: table.index_add_(0, ids, cast)),
    }
    for name, (kern, lib) in cases.items():
        r = {"ms": cs.time_ms(kern, iters=20),
             "device_ms": cs.device_ms(kern)[0],
             "library_ms": cs.time_ms(lib, iters=20),
             "library_device_ms": cs.device_ms(lib)[0]}
        cs.say(f"row kernel timers {name}: "
               + " ".join(f"{k} {v:.4f}" for k, v in r.items()))


def launch_path(cs):
    """Host cost of each part of the change's row-gather launch path at
    K1b's shape (8 ids into [64, 256] f32), host clock over 2,000 calls
    each, beside index_select's and beside the two parts of the parent's
    wrapper that this one no longer takes (a ``torch.cuda.device`` context
    and a ``torch.cuda.Stream`` object per call); two rounds, the second
    in reverse order, against drift of the host."""
    import torch
    from multiverso_tpu_torch import kernels
    from multiverso_tpu_torch.ops import embedding as emb

    table = torch.randn(64, 256, device=cs.DEV)
    ids = torch.randint(0, 64, (8,), device=cs.DEV, dtype=torch.int32)
    out = table.new_empty((8, 256))
    dev, stream = kernels.launch_target(table)
    fn = kernels.bind("row_gather", "mv_row_gather", emb._GATHER_ARGS)
    ptrs = (table.data_ptr(), ids.data_ptr(), out.data_ptr())

    def device_context():
        with torch.cuda.device(table.device):
            pass

    parts = {
        "index_select": lambda: torch.index_select(table, 0, ids),
        "wrapper": lambda: emb.embedding_lookup(table, ids),
        "checks": lambda: (emb._check_table(table, "k1b"),
                           emb._check_ids(ids, dev, "k1b")),
        "launch_target": lambda: kernels.launch_target(table),
        "new_empty": lambda: table.new_empty(ids.shape + table.shape[1:]),
        "c_call_no_launch": lambda: fn(*ptrs, 0, 64, 1024, 0, dev, stream),
        "c_call_launch": lambda: fn(*ptrs, 8, 64, 1024, 0, dev, stream),
        "parent_device_context": device_context,
        "parent_stream_object": lambda: torch.cuda.current_stream(
            table.device).cuda_stream,
    }
    rounds = [{name: host_us(parts[name]) for name in order}
              for order in (list(parts), list(parts)[::-1])]
    cs.say("launch path at K1b's shape, host us a call over 2000 calls, "
           "two rounds: " + ", ".join(
               f"{k} {rounds[0][k]:.3f} / {rounds[1][k]:.3f}"
               for k in parts))


def extra(tree: str, tag: str) -> None:
    """Step 2 on ``tree``'s package, in this process."""
    import chip_smoke as cs   # puts HERE first on the path

    sys.path.insert(0, os.path.abspath(tree))
    import multiverso_tpu_torch as mv

    if os.path.dirname(os.path.abspath(mv.__file__)) != os.path.join(
            os.path.abspath(tree), "multiverso_tpu_torch"):
        cs.fail(f"{tag}: imported {mv.__file__}, not {tree}'s package")
    row_kernel_timers(cs)
    if tag.startswith("parent"):
        mv.init(["ab_row_kernels", "-device=cuda"])
        cs.phase_w2v_slice(f"{tag} tree")
        mv.shutdown()
    else:
        launch_path(cs)


def main(parent: str, out_dir: str) -> int:
    os.makedirs(out_dir, exist_ok=True)
    trees = {"parent": os.path.abspath(parent), "change": HERE}
    failed = []
    for i, which in enumerate(("parent", "change", "change", "parent")):
        tag = f"{which}{1 if i < 2 else 2}"
        for cmd, cwd, log in (
                ([sys.executable, "chip_smoke.py"], trees[which],
                 f"{tag}.log"),
                ([sys.executable, os.path.join(HERE, "ab_row_kernels.py"),
                  "--extra", trees[which], tag], HERE, f"{tag}_extra.log")):
            t0 = time.perf_counter()
            with open(os.path.join(out_dir, log), "w") as f:
                rc = subprocess.run(cmd, cwd=cwd, stdout=f,
                                    stderr=subprocess.STDOUT).returncode
            print(f"{log}: exit {rc}, {time.perf_counter() - t0:.0f} s",
                  flush=True)
            if rc:
                failed.append(log)
            with open(os.path.join(out_dir, log)) as f:
                for line in f:
                    if line.startswith(("row kernel timers", "launch path",
                                        "w2v slice", "w2v profile")):
                        print(f"  {tag}: {line.rstrip()}", flush=True)
    if failed:
        print(f"failed: {failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--extra":
        extra(sys.argv[2], sys.argv[3])
    elif len(sys.argv) == 3:
        raise SystemExit(main(sys.argv[1], sys.argv[2]))
    else:
        raise SystemExit(__doc__)
