"""The distances that chip_smoke.py's phase 18 limits were set from.

    python3 seqpar_tolerance.py [--heads 2] [--device cpu]

On phase 18's inputs (seed 18, seq 4,096, head dim 64, bf16, causal; the
first ``--heads`` heads of the flagship's 12, for the CPU's memory) it
prints, in the form phase 18 holds its legs (the output's error of each
row over that row's largest |ref|, each gradient's over its largest
|ref|, beyond ``ulps`` bf16 ulps of the reference):

* the kernels' plain versions over the whole sequence (``_fa_plain``,
  then ``_bwd_plain`` on its statistics) against ``reference_attention``
  in f32, the distance the bf16 roundings alone make (phase 18's fixed
  f32 limits sit over it);
* a ring of ``n`` = 2 and 4 blocks of the plain versions, merged as
  ``ring_attention`` merges its kernels' partials, against the plain
  version over the whole sequence (phase 18's per-row output limit sits
  over it).

It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import importlib

import torch

from multiverso_tpu_torch.ops.ring_attention import reference_attention

fa = importlib.import_module("multiverso_tpu_torch.ops.flash_attention")

SEQ, HEAD_DIM, SEED = 4096, 64, 18
BF16 = torch.bfloat16


def ulp(x: torch.Tensor) -> torch.Tensor:
    mag = x.float().abs().clamp(min=torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def errors(got, ref, ulps: float) -> list:
    out = []
    for i, (a, b) in enumerate(zip(got, ref)):
        a, b = a.float(), b.float()
        excess = ((a - b).abs() - ulps * ulp(b)).clamp(min=0)
        if i == 0:
            size = b.abs().amax(-1).clamp(min=torch.finfo(torch.float32).tiny)
            out.append((excess.amax(-1) / size).max().item())
        else:
            out.append((excess.max() / b.abs().max()).item())
    return out


def plain_blocks(q, k, v, g, n: int, scale: float) -> list:
    """Output and grads of ``n`` query blocks, each against every key
    block through the plain versions and merged; ``n`` = 1 is the plain
    version over the whole sequence."""
    block = SEQ // n
    outs, dqs = [], []
    dk = torch.zeros(k.shape, device=k.device)
    dv = torch.zeros_like(dk)
    rows = [slice(r * block, (r + 1) * block) for r in range(n)]
    for r, rq in enumerate(rows):
        qr, gr = q[:, rq], g[:, rq]
        f32 = dict(device=q.device, dtype=torch.float32)
        m = torch.full((1, q.shape[2], block), -1e30, **f32)
        l = torch.zeros((1, q.shape[2], block), **f32)
        acc = torch.zeros(qr.shape, **f32)
        for src, rk in enumerate(rows):
            part = fa._fa_plain(qr, k[:, rk], v[:, rk], r * block,
                                src * block, causal=True, scale=scale,
                                normalize=False)
            m, l, acc = fa.merge_partials(m, l, acc, part[1], part[2],
                                          part[0])
        l_safe = torch.clamp(l, min=1e-20)
        out = (acc / l_safe.transpose(-1, -2)[..., None]).to(BF16)
        lse = m + torch.log(l_safe)
        delta = torch.einsum("bshd,bshd->bhs", gr.float(), out.float())
        dq = torch.zeros(qr.shape, **f32)
        for src, rk in enumerate(rows):
            dq_p, dk_p, dv_p = fa._bwd_plain(
                qr, k[:, rk], v[:, rk], gr, lse, delta, r * block,
                src * block, causal=True, scale=scale)
            dq += dq_p
            dk[:, rk] += dk_p
            dv[:, rk] += dv_p
        outs.append(out[0])
        dqs.append(dq[0].to(BF16))
    return [torch.cat(outs), torch.cat(dqs), dk[0].to(BF16), dv[0].to(BF16)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    gen = torch.Generator().manual_seed(SEED)
    # phase 18's inputs (sp_inputs), then their first heads
    q, k, v, g = [torch.randn((SEQ, 12, HEAD_DIM), generator=gen).to(BF16)
                  [:, :args.heads].contiguous().to(dev) for _ in range(4)]
    scale = 1.0 / HEAD_DIM ** 0.5
    with torch.no_grad():
        plain = plain_blocks(q[None], k[None], v[None], g[None], 1, scale)
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    out = reference_attention(qf, kf, vf, causal=True)
    out.backward(g.float())
    f32 = [out.detach(), qf.grad, kf.grad, vf.grad]
    tag = f"seq {SEQ}, {args.heads} heads x {HEAD_DIM}, bf16, {dev.type}"
    print(f"plain versions vs f32 reference_attention ({tag}), output / dq "
          f"/ dk / dv: {errors(plain, f32, 0.0)}")
    for n in (2, 4):
        with torch.no_grad():
            ring = plain_blocks(q[None], k[None], v[None], g[None], n, scale)
        print(f"a ring of {n} plain blocks vs the plain versions ({tag}, "
              f"beyond 1 ulp): {errors(ring, plain, 1.0)}")


if __name__ == "__main__":
    main()
