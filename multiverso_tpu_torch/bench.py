"""Word2vec training throughput of the port on one device.

    python -m multiverso_tpu_torch.bench              # on the card
    python -m multiverso_tpu_torch.bench -device=cpu  # an explicit CPU run

The counterpart of the JAX package's ``bench.py``: skip-gram negative
sampling at the text8 shape (71,291-word vocabulary, 200-dim bf16 tables),
on a synthetic zipf corpus of 4M words written by :func:`make_corpus` (the
same generator, seed and law as ``bench.py``), through the port's normal
entry points: ``Dictionary.build`` -> ``encode_corpus`` ->
``subsample_probs`` -> ``create_table("matrix", ...)`` x2 -> ``Word2Vec``
-> ``load_corpus_chunk`` -> ``train_device_steps(25)``. Configuration as
in ``bench.py``: window 5, 5 negatives, lr 0.025, batch 65,536, oversample
2.5, a 2^22 negative pool, G = 64 shared negatives, static capped row-mean
updates. One warm call, then a timed window of 20 calls of 25 steps.

Prints ONE JSON line: ``metric`` (``word2vec_train_pairs_per_sec``),
``value``, ``unit``, ``negatives``, ``device``, ``card`` (name and power
limit as ``nvidia-smi`` prints them; ``cpu`` for a CPU run) and the mean
``dispatch_ms``. There is no fallback: without a CUDA device and without
``-device=cpu`` the run fails. ``-bench_quick=true`` cuts everything to a
toy size (:data:`QUICK`) for a check that the entry runs; the corpus file
is written once under ``build/bench/`` in the checkout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np

_VOCAB = 71291
_DIM = 200
_BUILD = Path(__file__).resolve().parent.parent / "build" / "bench"
# (words, vocab, dim, batch, steps per call, timed calls)
FULL = (4_000_000, _VOCAB, _DIM, 65536, 25, 20)
QUICK = (20_000, 500, 16, 512, 3, 2)


def make_corpus(path: str, n_words: int = 4_000_000, vocab: int = _VOCAB,
                seed: int = 5) -> None:
    """The JAX bench's synthetic corpus: zipf unigram law over a closed
    vocabulary, every word at least once, 1000 words a line."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    words = rng.choice(vocab, size=n_words, p=probs)
    words[:vocab] = rng.permutation(vocab)
    with open(path, "w") as f:
        for i in range(0, n_words, 1000):
            f.write(" ".join(f"w{w}" for w in words[i:i + 1000]) + "\n")


def card_name() -> str:
    """``name, power.limit`` of card 0 as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        out = []
    if out:
        return out[0].strip()
    import torch

    return f"{torch.cuda.get_device_name(0)}, power limit not read"


def _define_flags() -> None:
    import multiverso_tpu_torch as mv

    mv.define_int("shared_negatives", 64,
                  "share each K-negative draw across G consecutive pairs")
    mv.define_bool("bench_quick", False,
                   "toy corpus, tables and window (a check that it runs)")


def corpus_file(words: int, vocab: int) -> Path:
    """The synthetic corpus of :func:`make_corpus` under ``build/bench/``,
    written once."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    corpus = _BUILD / f"text8_synth_{words}_{vocab}.txt"
    if not corpus.exists():
        tmp = corpus.with_suffix(f".{os.getpid()}.tmp")
        make_corpus(str(tmp), n_words=words, vocab=vocab)
        os.replace(tmp, corpus)
    return corpus


def build_model(words: int, vocab: int, dim: int, batch: int,
                shared_negatives: int, dtype: Any):
    """Corpus file -> dictionary -> encoded corpus -> two tables -> a
    ``Word2Vec`` with the chunk loaded, on the session's device."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.apps.wordembedding import (Dictionary,
                                                         encode_corpus,
                                                         subsample_probs)
    from multiverso_tpu_torch.models.word2vec import Word2Vec, Word2VecConfig

    corpus = corpus_file(words, vocab)
    dictionary = Dictionary.build(str(corpus), min_count=1)
    cfg = Word2VecConfig(vocab_size=dictionary.vocab_size,
                         embedding_size=dim, window=5, negative=5,
                         init_lr=0.025, batch_size=batch, oversample=2.5,
                         neg_pool_size=1 << 22, row_mean_updates=True,
                         row_mean_static=True,
                         shared_negatives=shared_negatives)
    w_in = mv.create_table("matrix", dictionary.vocab_size, dim,
                           init_value="random", dtype=dtype)
    w_out = mv.create_table("matrix", dictionary.vocab_size, dim,
                            dtype=dtype)
    model = Word2Vec(cfg, w_in, w_out,
                     counts=np.asarray(dictionary.counts, np.float64))
    model.total_words = 10 ** 9
    ids, sent_ids = encode_corpus(str(corpus), dictionary)
    discard = subsample_probs(np.asarray(dictionary.counts, np.float64),
                              1e-3).astype(np.float32)
    model.load_corpus_chunk(ids, sent_ids, discard)
    return model, dictionary


def timed_window(model, steps: int, iters: int) -> Dict[str, Any]:
    """One warm call, then ``iters`` calls of ``steps`` steps timed on the
    host clock up to the readback of the last pair count. Returns the
    pairs, the seconds, the pair rate, the mean ms per call, and the loss of
    the warm call and of every timed call."""
    loss, count = model.train_device_steps(steps)
    warm_loss = float(loss)
    counts, losses = [], []
    t0 = time.perf_counter()
    for _ in range(iters):
        loss, count = model.train_device_steps(steps)
        counts.append(count)
        losses.append(loss)
    pairs = float(np.sum([float(c) for c in counts]))  # waits for the last
    elapsed = time.perf_counter() - t0
    return {"pairs": pairs, "elapsed_s": elapsed,
            "pairs_per_sec": pairs / elapsed,
            "dispatch_ms": elapsed / iters * 1e3,
            "warm_loss": warm_loss,
            "losses": [float(x) for x in losses]}


def main(argv=None) -> int:
    import torch

    import multiverso_tpu_torch as mv

    _define_flags()
    argv = list(sys.argv[1:] if argv is None else argv)
    rest = mv.init(["bench", "-log_level=error"] + argv)
    leftover = [t for t in rest if t != "bench"]
    if leftover:
        for tok in leftover:
            key = tok.lstrip("-").partition("=")[0]
            kind = ("bad value for flag" if mv.config.registry().known(key)
                    else "unknown flag")
            print(f"bench: {kind}: {tok}", file=sys.stderr)
        mv.shutdown()
        return 2
    g = mv.get_flag("shared_negatives")
    dev = mv.session().device
    words, vocab, dim, batch, steps, iters = \
        QUICK if mv.get_flag("bench_quick") else FULL
    try:
        model, _ = build_model(words, vocab, dim, batch, g, torch.bfloat16)
        res = timed_window(model, steps, iters)
    finally:
        mv.shutdown()
    record = {
        "metric": "word2vec_train_pairs_per_sec",
        "value": res["pairs_per_sec"],
        "unit": "pairs/sec",
        "negatives": "exact" if g in (0, 1) else f"group-shared G={g}",
        "device": str(dev),
        "card": card_name() if dev.type == "cuda" else "cpu",
        "dispatch_ms": res["dispatch_ms"],
    }
    if dev.type == "cuda":
        record["kind"] = torch.cuda.get_device_name(dev)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
