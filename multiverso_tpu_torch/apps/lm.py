"""Transformer language-model training CLI.

Counterpart of ``multiverso_tpu/apps/lm.py``: a byte-level causal LM
(``models/transformer.py``) trained with momentum SGD on random windows of
a local text file, then optionally sampled. The flags and their defaults
are the JAX app's, ``-attention flash`` included. One process on one
device: the JAX app's mesh (``-mesh_shape``) belongs to the distributed
paths and the session refuses it. ``-ckpt`` (autosave and resume through
an array table) needs ``io/checkpoint``, and URIs need ``io/stream``; both
raise :class:`~..log.FatalError` until the I/O slice is ported.

Usage::

    python -m multiverso_tpu_torch.apps.lm -train_file corpus.txt \\
        [-d_model 256] [-n_layers 4] [-n_heads 4] [-seq 256] [-batch 32]
        [-steps 1000] [-lr 0.1] [-attention flash|reference|flash_force]
        [-sample 128] [-device=cpu]

It runs on the card unless ``-device=cpu`` is given.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

import numpy as np

from ..log import Log

_VOCAB = 256   # byte-level


def load_bytes(path: str) -> np.ndarray:
    """The bytes of a local file as int32 token ids."""
    if "://" in path:
        Log.fatal(f"{path}: URIs need io/stream, which is not ported to "
                  f"multiverso_tpu_torch yet; pass a local path")
    with open(path, "rb") as f:
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


def main(argv: Optional[List[str]] = None) -> int:
    import multiverso_tpu_torch as mv
    from ..models.transformer import TransformerConfig, TransformerLM

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
    opt("ckpt_every", 200, int)
    n_sample = opt("sample", 0, int)
    log_every = opt("log_every", 50, int)
    if not train_file:
        print("usage: lm -train_file FILE [-d_model N] [-n_layers N] "
              "[-n_heads N] [-seq N] [-batch N] [-steps N] [-lr F] "
              "[-attention flash|reference|flash_force] [-sample N] "
              "[-device=cpu]")
        return 2
    if ckpt:
        Log.fatal("-ckpt needs io/checkpoint (autosave and resume through "
                  "an array table), which is not ported to "
                  "multiverso_tpu_torch yet")

    mv.init(argv)
    cfg = TransformerConfig(vocab_size=_VOCAB, d_model=d_model,
                            n_heads=n_heads, n_layers=n_layers, d_ff=d_ff,
                            max_seq=seq, learning_rate=lr,
                            attention=attention)
    lm = TransformerLM(cfg)
    data = load_bytes(train_file)
    if data.shape[0] < seq + 2:
        Log.fatal(f"corpus has {data.shape[0]} bytes; needs >= seq+2 "
                  f"({seq + 2}) for [batch, seq+1] windows")
    Log.info("LM: %d bytes corpus, d_model %d, %d layers, %d heads, "
             "attention=%s, device %s", data.shape[0], d_model, n_layers,
             n_heads, attention, lm.device)

    t0 = time.perf_counter()
    gen = batches(data, batch, seq, seed=mv.rank())
    loss = None
    for step in range(1, steps + 1):
        loss = lm.train_batch(next(gen))
        if log_every and step % log_every == 0:
            elapsed = time.perf_counter() - t0
            tps = step * batch * seq / elapsed
            Log.info("step %d: loss %.4f, ppl %.1f, %.0f tok/s",
                     step, float(loss), float(np.exp(float(loss))), tps)
    if loss is not None:
        Log.info("final loss %.4f (ppl %.1f)", float(loss),
                 float(np.exp(float(loss))))

    if n_sample > 0:
        out = sample(lm, data[:16], n_sample)
        text = bytes(out.astype(np.uint8)).decode("utf-8", errors="replace")
        print("--- sample ---")
        print(text)

    mv.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
