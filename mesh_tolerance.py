"""The distances that chip_smoke.py's phase 19 limits were set from.

    python3 mesh_tolerance.py [--layers 2] [--runs 128x8,256x4]

Runs phase 19 itself (``chip_smoke.mesh_worker`` in 4 processes on a
(2, 2) mesh, then ``mesh_single`` in this process, then ``mesh_hold``)
on the CPU: the flagship's width in bf16 with ``attention="flash_force"``
(the kernels' plain versions on the CPU), lr 0.003 and momentum 0.9, on
phase 9's corpus, at a cut depth (``--layers``) and sequence (``--runs``,
``seq x global batch``) for the CPU's time and memory. It prints, for
each run, the (2, 2) mesh's distance from one process in the form phase
19 holds it (``chip_smoke.MESH_TOLS``' comment: the first step's loss
and momentum, the later losses, the parameters and momentum after the
last step; whether dp replicas are bitwise equal), and the two controls'
distances (layer 0's first reduce_from_tp skipped: the first step's
loss; the gradients left out of the dp average: the momentum after one
step).
"""

from __future__ import annotations

import argparse
import os
import shutil

import torch


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--runs", default="128x8,256x4")
    args = ap.parse_args()
    os.environ.update(MESH_DEVICE="cpu", MESH_LAYERS=str(args.layers),
                      MESH_RUNS=args.runs, OMP_NUM_THREADS="2")
    import chip_smoke as c

    shutil.rmtree(c.MESH_DIR, ignore_errors=True)
    os.makedirs(c.MESH_DIR)
    c.lm_corpus()
    _, layers, runs = c.mesh_setup()
    group = c.worker_group(c.MESH_DIR, "mesh", 4, "mesh_worker", 3600.0)
    for rank, (rc, _) in enumerate(group):
        if rc != 0:
            raise SystemExit(f"rank {rank} exited {rc}:\n"
                             f"{c.log_tail(c.MESH_DIR, 'mesh', rank)}")
    single = c.mesh_single(runs, layers, "cpu")
    parts = c.mesh_load(4, runs)
    errs = c.mesh_hold(parts, single, runs, torch.device("cpu"),
                       [p["json"]["ctl_reduce_loss"] for p in parts],
                       [p["ctl"] for p in parts])
    print(f"mesh_tolerance: {layers} layers, runs {runs}, bf16, CPU")
    for seq, batch in runs:
        e = errs[seq]
        print(f"seq {seq} x {batch}: {c.mesh_fmt(e)}; losses mesh "
              f"{parts[0]['json'][str(seq)]['losses']} one process "
              f"{single[seq]['losses']}")
    for name, value in errs["controls"].items():
        print(f"control ({name}): {value:.3e}")
    shutil.rmtree(c.MESH_DIR, ignore_errors=True)


if __name__ == "__main__":
    main()
