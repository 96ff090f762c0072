"""The JAX package's word2vec loss, call by call, at the bench corpus and
width with the batch cut, under each row-mean mode and option.

The bench corpus (``bench.py::make_corpus``: 4M zipf words over the text8
vocabulary of 71,291, every word at least once) is iid: no context says
anything about its center word beyond the unigram law. This tool prints how
the JAX reference's loss moves over a few calls of 25 steps on it, so that
another implementation's loss at the same configuration can be read
against it: under static capped row-mean (the bench's) and under realized
capped row-mean (the trainer's auto rule for CBOW, hierarchical softmax,
AdaGrad and the host stream), for skip-gram, CBOW, AdaGrad and HS alone.

The tables are bf16, the input table the random init and the output table
+-0.5/D (as the port's ``chip_smoke.py`` sets it before its held step), G
= 64 shared negatives from a 2^22 pool, oversample 2.5, lr 0.025.

    JAX_PLATFORMS=cpu python tools/w2v_loss_witness.py [--batch 8192]
        [--calls 12]

Prints one JSON line per configuration: its name, the Word2VecConfig fields
set, the batch and the mean loss of each 25-step call.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

VOCAB, DIM, WORDS, STEPS = 71291, 200, 4_000_000, 25
CORPUS = os.path.join(_REPO, "build", "bench",
                      f"text8_synth_{WORDS}_{VOCAB}.txt")
CONFIGS = {
    "static": dict(row_mean_static=True),
    "realized": dict(),
    "cbow-realized": dict(cbow=True),
    "adagrad-realized": dict(use_adagrad=True),
    "hs-realized": dict(hs=True, negative=0),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--calls", type=int, default=12)
    args = ap.parse_args(argv)

    import jax.numpy as jnp

    import multiverso_tpu as mv
    from bench import make_corpus
    from multiverso_tpu.apps.wordembedding import (Dictionary,
                                                   encode_corpus,
                                                   subsample_probs)
    from multiverso_tpu.models.word2vec import (Word2Vec, Word2VecConfig,
                                                build_huffman)

    if not os.path.exists(CORPUS):
        os.makedirs(os.path.dirname(CORPUS), exist_ok=True)
        make_corpus(CORPUS, n_words=WORDS, vocab=VOCAB)
    mv.init(["w2v_loss_witness"])
    d = Dictionary.build(CORPUS, min_count=1)
    counts = np.asarray(d.counts, np.float64)
    ids, sents = encode_corpus(CORPUS, d)
    discard = subsample_probs(counts, 1e-3).astype(np.float32)
    out_init = ((np.random.default_rng(3).random((VOCAB, DIM)) - 0.5)
                / DIM).astype(np.float32)
    for name, fields in CONFIGS.items():
        kw = dict(vocab_size=VOCAB, embedding_size=DIM, window=5,
                  negative=5, init_lr=0.025, batch_size=args.batch,
                  oversample=2.5, neg_pool_size=1 << 22, shared_negatives=64,
                  steps_per_call=STEPS, row_mean_updates=True)
        kw.update(fields)
        cfg = Word2VecConfig(**kw)
        w_in = mv.create_table("matrix", VOCAB, DIM, init_value="random",
                               dtype=jnp.bfloat16)
        w_out = mv.create_table("matrix", VOCAB, DIM, dtype=jnp.bfloat16)
        w_out.add(out_init)
        model = Word2Vec(cfg, w_in, w_out, counts,
                         build_huffman(counts) if cfg.hs else None)
        model.total_words = 10 ** 9     # lr stays within 0.3% of init_lr
        model.load_corpus_chunk(ids, sents, discard)
        t0 = time.perf_counter()
        losses = [float(model.train_device_steps(STEPS)[0])
                  for _ in range(args.calls)]
        print(json.dumps({"config": name, "fields": fields,
                          "batch": args.batch, "steps_per_call": STEPS,
                          "losses": losses,
                          "seconds": time.perf_counter() - t0}), flush=True)
    mv.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
