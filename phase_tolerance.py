"""The distances that chip_smoke.py's phase 19 and phase 20 limits were
set from, and a CPU rehearsal of phase 21.

    python3 phase_tolerance.py --phase mesh [--layers 2]
                               [--runs 128x8,256x4]
    python3 phase_tolerance.py --phase pipemoe [--layers 4]
                               [--runs 128x8,256x4] [--tokens 2048]
    python3 phase_tolerance.py --phase decode_tp [--layers 1]

Runs the phase itself on the CPU, its workers in 4 processes (two
threads each, as this process): the flagship's width in bf16 with
``attention="flash_force"`` (the kernels' plain versions on the CPU), lr
0.003 and momentum 0.9, on phase 9's corpus, at a cut depth
(``--layers``), sequence (``--runs``, ``seq x global batch``) and MoE
token count (``--tokens``, over 4 ranks) for the CPU's time and memory.
The phase's ``<MESH|PM>_DEVICE``, ``_LAYERS``, ``_RUNS`` and ``_TOKENS``
variables carry these to the workers (``chip_smoke.phase_setup``).

``mesh`` (phase 19: ``chip_smoke.mesh_worker`` on a (2, 2) mesh, then
``mesh_single`` in this process, then ``mesh_hold``) prints, for each
run, the (2, 2) mesh's distance from one process in the form phase 19
holds it (``chip_smoke.MESH_TOLS``' comment: the first step's loss and
momentum, the later losses, the parameters and momentum after the last
step; whether dp replicas are bitwise equal), and the two controls'
distances (layer 0's first reduce_from_tp skipped: the first step's
loss; the gradients left out of the dp average: the momentum after one
step).

``decode_tp`` (phase 21: ``chip_smoke.phase_decode_tp`` as the card runs
it, on the CPU: every leg on a one-process engine in this process, then
``dtp_worker`` in 2 processes on decode_tp=2 engines, at the flagship's
width and phase 3's prompts, ``layers`` deep) prints each leg's line and
fails as the phase fails; the launch checks and the kernels at a rank's
shapes run on the card only.

``pipemoe`` (phase 20: ``chip_smoke.pm_oracle`` and ``pm_moe_oracle`` in
this process, then ``pm_worker`` on a 4-stage axis and a 4-process
expert axis, then ``pm_hold`` and ``pm_moe_hold``; 4 stages of ``layers
/ 4``, microbatches of [1, seq]) prints, for each run, the pipeline's
distance from one process in the form phase 20 holds it
(``chip_smoke.PM_TOLS``' comment: the first step's gradients, whether the
first loss and GPipe's outputs are bitwise equal, the later losses), the
two controls' distances, and for MoE by dtype and capacity factor the
output's, the auxiliary loss's and the gradients' distances, the tokens
routed differently and the control's distance.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil


def run_workers(c, work_dir: str, leg: str, entry: str) -> None:
    group = c.worker_group(work_dir, leg, 4, entry, 3600.0)
    for rank, (rc, _) in enumerate(group):
        if rc != 0:
            raise SystemExit(f"rank {rank} exited {rc}:\n"
                             f"{c.log_tail(work_dir, leg, rank)}")


def mesh(c) -> None:
    import torch

    _, layers, runs, _ = c.phase_setup("MESH", c.MESH_RUNS)
    run_workers(c, c.MESH_DIR, "mesh", "mesh_worker")
    single = c.mesh_single(runs, layers, "cpu")
    parts = c.mesh_load(4, runs)
    errs = c.mesh_hold(parts, single, runs, torch.device("cpu"),
                       [p["json"]["ctl_reduce_loss"] for p in parts],
                       [p["ctl"] for p in parts])
    print(f"mesh: {layers} layers, runs {runs}, bf16, CPU")
    for seq, batch in runs:
        print(f"seq {seq} x {batch}: {c.mesh_fmt(errs[seq])}; losses mesh "
              f"{parts[0]['json'][str(seq)]['losses']} one process "
              f"{single[seq]['losses']}")
    for name, value in errs["controls"].items():
        print(f"control ({name}): {value:.3e}")


def pipemoe(c) -> None:
    device, layers, runs, tokens = c.phase_setup("PM", c.PM_RUNS,
                                                 c.PM_MOE["tokens"])
    single = c.pm_oracle(runs, layers, device, timed=False)
    c.pm_moe_oracle(tokens, device, timed=False)
    run_workers(c, c.PM_DIR, "pipemoe", "pm_worker")
    parts = c.pm_load(c.PM_STAGES)
    print(f"pipemoe: {layers} layers, runs {runs}, {tokens} MoE tokens, "
          f"bf16 (MoE also f32), CPU")
    for key, e in c.pm_hold(parts, single, runs).items():
        print(f"{key}: {json.dumps(e)}")
    for tag, e in c.pm_moe_hold(parts).items():
        print(f"moe {tag}: {json.dumps(e)}")


def decode_tp(c) -> None:
    import numpy as np
    import torch

    c.DEV = torch.device("cpu")
    prompts = c.slice_prompts(c.FLAGSHIP["vocab_size"],
                              np.random.default_rng(1))
    c.phase_decode_tp("CPU rehearsal", prompts)


# phase: (its variables' prefix, and chip_smoke's <prefix>_DIR; default
# depth; the reading)
PHASES = {"mesh": ("MESH", 2, mesh), "pipemoe": ("PM", 4, pipemoe),
          "decode_tp": ("DTP", 1, decode_tp)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=sorted(PHASES), required=True)
    ap.add_argument("--layers", type=int)
    ap.add_argument("--runs", default="128x8,256x4")
    ap.add_argument("--tokens", type=int, default=2048)
    args = ap.parse_args()
    prefix, layers, reading = PHASES[args.phase]
    # before torch is imported: this process and its workers alike
    os.environ.update({f"{prefix}_DEVICE": "cpu",
                       f"{prefix}_LAYERS": str(args.layers or layers),
                       f"{prefix}_RUNS": args.runs,
                       f"{prefix}_TOKENS": str(args.tokens),
                       "OMP_NUM_THREADS": "2"})
    import chip_smoke as c

    work_dir = getattr(c, f"{prefix}_DIR")
    shutil.rmtree(work_dir, ignore_errors=True)
    os.makedirs(work_dir)
    c.lm_corpus()
    try:
        reading(c)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
