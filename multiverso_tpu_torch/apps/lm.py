"""Transformer language-model training CLI.

Counterpart of ``multiverso_tpu/apps/lm.py``: a byte-level causal LM
(``models/transformer.py``) trained with momentum SGD on random windows of
a text corpus, with checkpoint autosave and resume, then optionally
sampled. The flags and their defaults are the JAX app's, ``-attention
flash`` included; ``-dtype`` (``float32``, the JAX app's, or
``bfloat16``) is the port's own, to train in the dtype the flagship is
measured in. The model trains on the session's mesh, data parallel over
the ``worker`` axis and tensor parallel over ``server`` (``-mesh_shape``;
by default one worker per process); every rank draws the same global
batches from one seed and trains on its rows of them.

The corpus is read through ``io/stream.open_stream``: a local path, a
``file://`` or a ``memory://`` URI (``gs://`` and ``hdfs://`` raise, ROADMAP.md
Queue 1 item 7b). ``-ckpt DIR`` resumes and autosaves as the JAX app does
(:122-183): every parameter lives, flattened in ``jax.tree_util``'s leaf
order (dict keys sorted) and in f32, in an ``array`` table ``lm_params``;
``io/checkpoint.restore_latest`` at start (then replaying the journal past
the checkpoint under ``-wal``), an ``Autosaver`` every ``-ckpt_every``
steps, and a final save when the last step is not a multiple of it. As in
the JAX app, momentum is not checkpointed (it starts again at zero on
resume) and the batch stream starts again from its seed. A mesh whose
``server`` axis spans several processes holds no whole parameter in any
process; ``-ckpt`` there is refused until sharded checkpoints are ported
(ROADMAP.md Queue 1 item 8f).

Usage::

    python -m multiverso_tpu_torch.apps.lm -train_file corpus.txt \\
        [-d_model 256] [-n_layers 4] [-n_heads 4] [-seq 256] [-batch 32]
        [-steps 1000] [-lr 0.1] [-attention flash|reference|flash_force]
        [-ckpt DIR] [-ckpt_every 200] [-sample 128] [-dtype bfloat16]
        [-device=cpu]

It runs on the card unless ``-device=cpu`` is given.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..log import Log

_VOCAB = 256   # byte-level


def load_bytes(path: str) -> np.ndarray:
    """The bytes of a corpus (a path or a URI) as int32 token ids."""
    from ..io.stream import open_stream

    with open_stream(path, "rb") as f:
        data = f.read()
    if len(data) < 2:
        Log.fatal(f"corpus too small: {path}")
    return np.frombuffer(data, np.uint8).astype(np.int32)


def batches(data: np.ndarray, batch: int, seq: int, seed: int = 0):
    """Random [batch, seq+1] windows forever (next-token targets); the JAX
    app's numpy stream, so one seed draws the same windows."""
    rng = np.random.default_rng(seed)
    n = data.shape[0] - seq - 1
    while True:
        starts = rng.integers(0, n, batch)
        yield np.stack([data[s:s + seq + 1] for s in starts])


def sample(lm, prompt: np.ndarray, n_tokens: int, temperature: float = 1.0,
           seed: int = 0) -> np.ndarray:
    """Greedy/temperature sampling (a host loop: generation is not the
    hot path here, the training step is)."""
    rng = np.random.default_rng(seed)
    toks = list(prompt)
    max_seq = lm.config.max_seq
    for _ in range(n_tokens):
        ctx = np.asarray(toks[-max_seq:], np.int32)[None, :]
        logits = lm.logits(ctx)[0, -1].cpu().numpy()
        if temperature <= 0:
            nxt = int(logits.argmax())
        else:
            p = np.exp((logits - logits.max()) / temperature)
            p /= p.sum()
            nxt = int(rng.choice(_VOCAB, p=p))
        toks.append(nxt)
    return np.asarray(toks, np.int32)


def pytree_leaves(tree: Dict[str, Any]) -> List[Any]:
    """The leaves of a parameter dict in ``jax.tree_util``'s order (keys
    sorted, depth first): the layout of the JAX app's flat table."""
    out: List[Any] = []
    for key in sorted(tree):
        value = tree[key]
        out.extend(pytree_leaves(value) if isinstance(value, dict)
                   else [value])
    return out


def main(argv: Optional[List[str]] = None) -> int:
    import torch

    import multiverso_tpu_torch as mv
    from ..models.transformer import TransformerConfig, TransformerLM
    from ..topology import SERVER_AXIS

    argv = list(sys.argv[1:] if argv is None else argv)

    def opt(name, default, cast=str):
        flag = f"-{name}"
        if flag in argv:
            i = argv.index(flag)
            val = cast(argv[i + 1])
            del argv[i:i + 2]
            return val
        return default

    train_file = opt("train_file", "")
    d_model = opt("d_model", 256, int)
    n_layers = opt("n_layers", 4, int)
    n_heads = opt("n_heads", 4, int)
    d_ff = opt("d_ff", 0, int) or 4 * d_model
    seq = opt("seq", 256, int)
    batch = opt("batch", 32, int)
    steps = opt("steps", 1000, int)
    lr = opt("lr", 0.1, float)
    attention = opt("attention", "flash")
    ckpt = opt("ckpt", "")
    ckpt_every = opt("ckpt_every", 200, int)
    n_sample = opt("sample", 0, int)
    log_every = opt("log_every", 50, int)
    dtype = opt("dtype", "float32")
    if not train_file:
        print("usage: lm -train_file FILE [-d_model N] [-n_layers N] "
              "[-n_heads N] [-seq N] [-batch N] [-steps N] [-lr F] "
              "[-attention flash|reference|flash_force] [-ckpt DIR] "
              "[-ckpt_every N] [-sample N] [-dtype float32|bfloat16] "
              "[-device=cpu]")
        return 2
    if dtype not in ("float32", "bfloat16"):
        Log.fatal(f"-dtype must be float32 or bfloat16, got {dtype!r}")

    mv.init(argv)
    cfg = TransformerConfig(vocab_size=_VOCAB, d_model=d_model,
                            n_heads=n_heads, n_layers=n_layers, d_ff=d_ff,
                            max_seq=seq, learning_rate=lr,
                            attention=attention,
                            dtype=getattr(torch, dtype))
    lm = TransformerLM(cfg)
    data = load_bytes(train_file)
    if data.shape[0] < seq + 2:
        Log.fatal(f"corpus has {data.shape[0]} bytes; needs >= seq+2 "
                  f"({seq + 2}) for [batch, seq+1] windows")
    Log.info("LM: %d bytes corpus, d_model %d, %d layers, %d heads, "
             "attention=%s, mesh %s, device %s", data.shape[0], d_model,
             n_layers, n_heads, attention, dict(mv.session().mesh.shape),
             lm.device)
    if ckpt and lm.mesh.shape[SERVER_AXIS] > 1:
        Log.fatal(f"-ckpt with the server axis over "
                  f"{lm.mesh.shape[SERVER_AXIS]} processes: no process "
                  f"holds a whole parameter; sharded checkpoints are "
                  f"ROADMAP.md Queue 1 item 8f")

    # resume + autosave through the table registry: the parameters live in
    # the model, so a flat array table exposes them to the checkpoint layer
    saver = None
    start_step = 0
    flat_table = None
    if ckpt:
        from ..io import checkpoint

        leaves = pytree_leaves(lm.params)
        total = int(sum(leaf.numel() for leaf in leaves))
        flat_table = mv.create_table("array", total, name="lm_params")
        latest = checkpoint.restore_latest(ckpt)
        if latest is not None:
            flat = torch.from_numpy(flat_table.get())
            offset = 0
            with torch.no_grad():
                for leaf in leaves:
                    size = leaf.numel()
                    leaf.copy_(flat[offset:offset + size].reshape(
                        leaf.shape))
                    offset += size
            start_step = latest
            Log.info("resumed from step %d", latest)
        saver = checkpoint.Autosaver(ckpt, every_steps=ckpt_every)

    def snapshot_params():
        flat = torch.cat([leaf.detach().float().reshape(-1)
                          for leaf in pytree_leaves(lm.params)]).cpu().numpy()
        current = flat_table.get()
        # scale by the add's fan-out: under sync aggregation (a sum over
        # processes) and the async bus (every peer applies every add)
        # each replica receives size copies of the delta; in ma mode or
        # alone the add stays local
        fanout = (mv.size() if (mv.get_flag("sync")
                                or mv.session().async_bus is not None)
                  else 1)
        flat_table.add((flat - current) / fanout)

    t0 = time.perf_counter()
    # one seed on every rank: the global batch is the same everywhere
    gen = batches(data, batch, seq, seed=0)
    loss = None
    for step in range(start_step + 1, steps + 1):
        loss = lm.train_batch(next(gen))
        if log_every and step % log_every == 0:
            elapsed = time.perf_counter() - t0
            tps = (step - start_step) * batch * seq / elapsed
            Log.info("step %d: loss %.4f, ppl %.1f, %.0f tok/s",
                     step, float(loss), float(np.exp(float(loss))), tps)
        if saver is not None and step % ckpt_every == 0:
            snapshot_params()
            saver.step(step)
    if saver is not None and steps % ckpt_every != 0 and steps > start_step:
        snapshot_params()
        saver.save_now(steps)   # the final state is the app's artifact
    if loss is not None:
        Log.info("final loss %.4f (ppl %.1f)", float(loss),
                 float(np.exp(float(loss))))

    if n_sample > 0:
        # over tp shards the forward is collective: every rank samples,
        # rank 0 prints
        out = sample(lm, data[:16], n_sample)
        if mv.rank() == 0:
            text = bytes(out.astype(np.uint8)).decode("utf-8",
                                                      errors="replace")
            print("--- sample ---")
            print(text)

    mv.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
