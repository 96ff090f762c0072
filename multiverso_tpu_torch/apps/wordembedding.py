"""Word2vec application: dictionary, corpus encoding, training, embedding save.

Counterpart of ``multiverso_tpu/apps/wordembedding.py`` (the reference
WordEmbedding app, ``Applications/WordEmbedding/src/
distributed_wordembedding.cpp``). The dictionary, the corpus encoder, the
subsampling law, the host-stream example builders and the embedding writer
are copies of the JAX package's (the same word ids in the same order, and
the same batches from the same seed). :func:`train` runs either path of the
JAX trainer:

* the device-resident corpus: the encoded corpus lives on the card and
  every call samples and trains ``steps_per_call`` batches there
  (``Word2Vec.load_corpus_chunk`` + ``train_device_steps``); corpora over
  the device budget rotate through equal-length chunks;
* the host stream: :func:`iter_pair_batches` builds fixed-size skip-gram
  or CBOW batches from the text with numpy, run ahead on a loader thread
  (``parallel.prefetch_iterator``), and ``train_batch(es)`` trains them;
  the lr decays over the exact words consumed.

One process, one device. The corpus is read through
``io/stream.TextReader``: a local path, ``file://`` or ``memory://``
(``gs://`` and ``hdfs://`` wait for ROADMAP.md Queue 1 item 7b). Not
ported yet: the multi-process data partition (``shard=``), the async
delta pusher and SSP (the distributed paths, item 8). As in the JAX
trainer, a ``kv`` word-count table (``word2vec_wordcount``, the
reference's KV wordcount table) takes each epoch's words under key 0.

CLI: ``python -m multiverso_tpu_torch.apps.wordembedding -train_file
corpus.txt -output vec.txt -size 100 -window 5 -negative 5 -epoch 1 ...``
(runs on the card; add ``-device=cpu`` for the CPU).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from collections import Counter
from dataclasses import dataclass
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np

from ..dashboard import Dashboard
from ..io.stream import TextReader
from ..log import Log
from ..models.word2vec import Word2Vec, Word2VecConfig, build_huffman

_INFREQUENT_BUCKET = "WE_ARE_THE_INFREQUENT_WORDS"


def _read_lines(path: str) -> Iterator[str]:
    """Lines of a corpus (a path or a ``file://``/``memory://`` URI), read
    through ``io/stream.TextReader`` as the JAX trainer reads them."""
    with TextReader(path) as reader:
        yield from reader


class Dictionary:
    """Vocab with counts + id mapping (reference ``WE/src/dictionary.cpp``).
    Built in Python, as the JAX package builds it without its native
    library: ids by descending count, ties in first-seen order."""

    def __init__(self, min_count: int = 5) -> None:
        self.min_count = min_count
        self.word2id = {}
        self.words: List[str] = []
        self.counts: List[int] = []
        self._whitelist: set = set()

    def set_whitelist(self, words) -> None:
        """Words exempt from frequency pruning/merging (``SetWhiteList``)."""
        self._whitelist = set(words)

    def insert(self, word: str, count: int = 1) -> None:
        """``Insert``: accumulate a word-count pair."""
        idx = self.word2id.get(word)
        if idx is None:
            self.word2id[word] = len(self.words)
            self.words.append(word)
            self.counts.append(int(count))
        else:
            self.counts[idx] += int(count)

    def remove_words_less_than(self, min_count: int) -> None:
        """Drop sub-threshold words (``RemoveWordsLessThan``); whitelisted
        and zero-freq entries survive, like the reference."""
        kept = [(w, c) for w, c in zip(self.words, self.counts)
                if c >= min_count or c == 0 or w in self._whitelist]
        self.word2id = {w: i for i, (w, _) in enumerate(kept)}
        self.words = [w for w, _ in kept]
        self.counts = [c for _, c in kept]

    def merge_infrequent_words(self, threshold: int) -> None:
        """Collapse sub-threshold words into ONE shared bucket id
        (``MergeInfrequentWords``, ``dictionary.cpp:26-51``)."""
        new_words: List[str] = []
        new_counts: List[int] = []
        new_map: dict = {}
        infreq_idx = -1
        for word, count in zip(self.words, self.counts):
            if count >= threshold or count == 0 or word in self._whitelist:
                new_map[word] = len(new_words)
                new_words.append(word)
                new_counts.append(count)
            else:
                if infreq_idx < 0:
                    infreq_idx = len(new_words)
                    new_map[_INFREQUENT_BUCKET] = infreq_idx
                    new_words.append(_INFREQUENT_BUCKET)
                    new_counts.append(0)
                new_map[word] = infreq_idx
                new_counts[infreq_idx] += count
        self.words, self.counts, self.word2id = new_words, new_counts, new_map

    def load_tri_letter(self, path: str, min_count: int = 1,
                        letter_count: int = 3, combine: bool = False) -> None:
        """Tri-letter-gram vocabulary from a word-count file
        (``LoadTriLetterFromFile``, ``dictionary.cpp:95-140``)."""
        for line in _read_lines(path):
            parts = line.split()
            if len(parts) != 2:
                continue
            try:
                word, count = parts[0], int(parts[1])
            except ValueError:
                continue
            if count < min_count:
                continue
            if combine:
                self.insert(word, count)
            hashed = f"#{word}#"
            if len(hashed) <= letter_count:
                self.insert(hashed, count)
            else:
                for i in range(len(hashed) - letter_count + 1):
                    self.insert(hashed[i:i + letter_count], count)

    @classmethod
    def build(cls, corpus_path: str, min_count: int = 5) -> "Dictionary":
        counter: Counter = Counter()
        for line in _read_lines(corpus_path):
            counter.update(line.split())
        d = cls(min_count)
        for word, count in counter.most_common():
            if count < min_count:
                break
            d.word2id[word] = len(d.words)
            d.words.append(word)
            d.counts.append(count)
        return d

    def save(self, path: str) -> None:
        """Write ``word count`` lines (the ``-read_vocab`` format)."""
        with open(path, "w") as f:
            for word, count in zip(self.words, self.counts):
                f.write(f"{word} {count}\n")

    @classmethod
    def load(cls, path: str, min_count: int = 5) -> "Dictionary":
        """Load a saved vocab file instead of re-counting the corpus."""
        d = cls(min_count)
        for line in _read_lines(path):
            parts = line.split()
            if len(parts) != 2:
                continue
            try:
                word, count = parts[0], int(parts[1])
            except ValueError:
                continue
            if count < min_count:
                continue
            d.word2id[word] = len(d.words)
            d.words.append(word)
            d.counts.append(count)
        return d

    @property
    def vocab_size(self) -> int:
        return len(self.words)

    @property
    def train_words(self) -> int:
        return int(sum(self.counts))

    def encode(self, tokens: List[str]) -> List[int]:
        w2i = self.word2id
        return [w2i[t] for t in tokens if t in w2i]


def subsample_probs(counts: np.ndarray, sample: float) -> np.ndarray:
    """Word-discard probabilities (reference sub-sampling formula)."""
    if sample <= 0:
        return np.zeros(counts.shape[0], np.float64)
    total = counts.sum()
    freq = counts / total
    keep = (np.sqrt(freq / sample) + 1) * (sample / np.maximum(freq, 1e-12))
    return np.clip(1.0 - keep, 0.0, 1.0)


def _pairs_from_chunk(ids: np.ndarray, sent_ids: np.ndarray, window: int,
                      rng) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorised skip-gram pair generation over a word chunk (a copy of
    the JAX package's). ``sent_ids`` marks sentence membership so windows
    never cross boundaries; each center's random window shrink is the
    reference trainer's ``rand % window + 1``. Returns (centers, contexts,
    mask), shuffled."""
    n = ids.shape[0]
    if n < 2:
        return (np.empty(0, np.int32), np.empty(0, np.int32),
                np.empty(0, np.float32))
    shrink = rng.integers(1, window + 1, size=n)
    centers_parts, contexts_parts = [], []
    for d in range(1, window + 1):
        same_sent = sent_ids[:-d] == sent_ids[d:]
        # forward pairs: center i, context i+d (center's window covers d)
        fwd = same_sent & (shrink[:-d] >= d)
        centers_parts.append(ids[:-d][fwd])
        contexts_parts.append(ids[d:][fwd])
        # backward pairs: center i+d, context i
        bwd = same_sent & (shrink[d:] >= d)
        centers_parts.append(ids[d:][bwd])
        contexts_parts.append(ids[:-d][bwd])
    centers = np.concatenate(centers_parts).astype(np.int32)
    contexts = np.concatenate(contexts_parts).astype(np.int32)
    perm = rng.permutation(centers.shape[0])
    return (centers[perm], contexts[perm],
            np.ones(centers.shape[0], np.float32))


def _cbow_from_chunk(ids: np.ndarray, sent_ids: np.ndarray, window: int,
                     rng) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorised CBOW example generation (a copy of the JAX package's):
    one example per center word with its (shrunk) window as context slots.
    Returns (centers [N], contexts [N, 2W], cmask [N, 2W]), shuffled."""
    n = ids.shape[0]
    W = window
    if n < 2:
        return (np.empty(0, np.int32), np.empty((0, 2 * W), np.int32),
                np.empty((0, 2 * W), np.float32))
    shrink = rng.integers(1, W + 1, size=n)
    offsets = np.concatenate([np.arange(-W, 0), np.arange(1, W + 1)])
    pos = np.arange(n)
    ctx = pos[:, None] + offsets[None, :]
    in_range = (ctx >= 0) & (ctx < n)
    ctx_c = np.clip(ctx, 0, n - 1)
    in_window = np.abs(offsets)[None, :] <= shrink[:, None]
    valid = in_range & in_window & (sent_ids[ctx_c] == sent_ids[pos][:, None])
    keep_rows = valid.any(axis=1)
    centers = ids[pos[keep_rows]].astype(np.int32)
    contexts = ids[ctx_c[keep_rows]].astype(np.int32)
    cmask = valid[keep_rows].astype(np.float32)
    perm = rng.permutation(centers.shape[0])
    return centers[perm], contexts[perm], cmask[perm]


def iter_pair_batches(
    corpus_path: str,
    dictionary: Dictionary,
    window: int,
    batch_size: int,
    sample: float = 1e-3,
    seed: int = 11,
    cbow: bool = False,
    chunk_words: int = 1 << 20,
    progress: Optional[dict] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield fixed-size (centers, contexts, mask) batches from a local text
    file (the JAX package's host stream, the same batches from the same
    seed). Skip-gram: contexts/mask are [B]; CBOW: [B, 2*window] with
    per-slot validity. Sentences are subsampled, gathered into ~
    ``chunk_words`` word chunks, turned into examples a chunk at a time by
    array ops, and sliced into batches; the last batch is zero-padded (mask
    0). ``progress``, if given, has ``progress["words"]`` updated in place:
    the corpus words consumed so far, before subsampling (the reference's
    ``word_count``), for exact lr decay."""
    rng = np.random.default_rng(seed)
    discard = subsample_probs(np.asarray(dictionary.counts, np.float64),
                              sample)
    vocab_lookup = dictionary.word2id
    from_chunk = _cbow_from_chunk if cbow else _pairs_from_chunk
    chunk_ids: List[np.ndarray] = []
    chunk_sents: List[np.ndarray] = []
    chunk_len = 0
    sent_counter = 0
    leftovers: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    leftover_len = 0

    def flush_chunk():
        nonlocal chunk_ids, chunk_sents, chunk_len, leftover_len
        if not chunk_ids:
            return
        ids = np.concatenate(chunk_ids)
        sents = np.concatenate(chunk_sents)
        chunk_ids, chunk_sents, chunk_len = [], [], 0
        example = from_chunk(ids, sents, window, rng)
        leftovers.append(example)
        leftover_len += example[0].shape[0]

    def drain(final: bool):
        nonlocal leftovers, leftover_len
        if leftover_len == 0:
            return
        if not final and leftover_len < batch_size:
            return
        centers = np.concatenate([e[0] for e in leftovers])
        contexts = np.concatenate([e[1] for e in leftovers])
        masks = np.concatenate([e[2] for e in leftovers])
        full = (centers.shape[0] // batch_size) * batch_size
        for i in range(0, full, batch_size):
            yield (centers[i:i + batch_size], contexts[i:i + batch_size],
                   masks[i:i + batch_size])
        rest = (centers[full:], contexts[full:], masks[full:])
        if final and rest[0].shape[0]:
            pad = batch_size - rest[0].shape[0]
            yield (
                np.concatenate([rest[0], np.zeros(pad, np.int32)]),
                np.concatenate(
                    [rest[1],
                     np.zeros((pad,) + rest[1].shape[1:], np.int32)]),
                np.concatenate(
                    [rest[2],
                     np.zeros((pad,) + rest[2].shape[1:], np.float32)]),
            )
            leftovers, leftover_len = [], 0
        else:
            leftovers = [rest]
            leftover_len = rest[0].shape[0]

    for line in _read_lines(corpus_path):
        arr = np.asarray([vocab_lookup[t] for t in line.split()
                          if t in vocab_lookup], dtype=np.int32)
        if progress is not None:
            progress["words"] = progress.get("words", 0) + int(arr.size)
        if sample > 0 and arr.size:
            keep = rng.random(arr.shape[0]) >= discard[arr]
            arr = arr[keep]
        if arr.size < 2:
            continue
        chunk_ids.append(arr)
        chunk_sents.append(np.full(arr.shape[0], sent_counter, np.int32))
        sent_counter += 1
        chunk_len += arr.shape[0]
        if chunk_len >= chunk_words:
            flush_chunk()
            yield from drain(final=False)
    flush_chunk()
    yield from drain(final=True)


def encode_corpus(corpus_path: str, dictionary: Dictionary
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Encode a corpus to (word ids, sentence ids) arrays for upload to the
    device (``Word2Vec.load_corpus_chunk``); lines with fewer than two
    in-vocabulary words are skipped."""
    ids_parts: List[np.ndarray] = []
    sent_parts: List[np.ndarray] = []
    lookup = dictionary.word2id
    for si, line in enumerate(_read_lines(corpus_path)):
        arr = np.asarray([lookup[t] for t in line.split() if t in lookup],
                         dtype=np.int32)
        if arr.size < 2:
            continue
        ids_parts.append(arr)
        sent_parts.append(np.full(arr.shape[0], si, np.int32))
    if not ids_parts:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    return np.concatenate(ids_parts), np.concatenate(sent_parts)


@dataclass
class TrainResult:
    words_trained: int        # corpus words seen (reference word_count_actual)
    pairs_trained: int        # (center, context) training pairs
    elapsed_s: float
    words_per_sec: float
    pairs_per_sec: float
    final_loss: float


# one chunk's token budget on the device (128M tokens, ~1.5 GB of buffers)
_DEVICE_CORPUS_MAX_TOKENS = 1 << 27
# below this many tokens the auto rule (device_corpus=None) streams from
# the host: the fast path's defaults do not pay off on a small corpus
_DEVICE_CORPUS_AUTO_MIN_TOKENS = 1 << 16


def _auto_row_mean(cfg: Word2VecConfig, counts: np.ndarray) -> bool:
    """The JAX trainer's auto rule: capped row-mean updates once the hottest
    row's expected colliding grads per step pass 512 (summed updates are
    stable at ~150 hits and diverge at ~2300+)."""
    total = max(counts.sum(), 1.0)
    p_center = float(counts.max() / total)
    w75 = counts ** 0.75
    p_neg = float(w75.max() / max(w75.sum(), 1e-12))
    est_hot = cfg.batch_size * (2 * p_center + cfg.negative * p_neg)
    return est_hot > 512


def train(
    corpus_path: str,
    output_path: Optional[str] = None,
    cfg: Optional[Word2VecConfig] = None,
    epochs: int = 1,
    min_count: int = 5,
    sample: float = 1e-3,
    dictionary: Optional[Dictionary] = None,
    log_every: int = 200,
    device_corpus: Optional[bool] = None,
    table_dtype: Optional[Any] = None,
    steps_per_call: Optional[int] = None,
    oversample: Optional[float] = None,
    output_path_ctx: Optional[str] = None,
) -> TrainResult:
    """Full training loop (reference ``TrainNeuralNetwork``).
    ``device_corpus`` True trains on the device-resident corpus path; False
    streams host-built batches; None (the JAX trainer's auto rule) takes
    the device path when the encoded corpus holds between max(batch +
    2*window + 2, 65,536) tokens and the device budget (2^27), else the
    host stream. Left as None, ``steps_per_call`` / ``oversample`` resolve
    to the device path's tuned values (32 / 2.5) when the cfg holds its
    defaults; the host stream keeps the cfg's. The caller's ``cfg`` is never
    mutated."""
    import multiverso_tpu_torch as mv

    cfg = dataclasses.replace(cfg) if cfg is not None else Word2VecConfig()
    if steps_per_call is not None:
        cfg.steps_per_call = int(steps_per_call)
    if oversample is not None:
        cfg.oversample = float(oversample)
    if dictionary is None:
        Log.info("building dictionary from %s ...", corpus_path)
        dictionary = Dictionary.build(corpus_path, min_count=min_count)
    vocab = dictionary.vocab_size
    if vocab == 0:
        Log.fatal(f"empty vocabulary from {corpus_path}")
    cfg.vocab_size = vocab
    counts = np.asarray(dictionary.counts, np.float64)
    Log.info("vocab %d, train words %d", vocab, dictionary.train_words)
    if cfg.row_mean_updates is None:
        cfg.row_mean_updates = _auto_row_mean(cfg, counts)

    ids = sent_ids = None
    if device_corpus is None or device_corpus:
        ids, sent_ids = encode_corpus(corpus_path, dictionary)
        n_enc = int(ids.shape[0])
        min_positions = cfg.batch_size + 2 * cfg.window + 2
        if device_corpus is None:
            device_corpus = (
                n_enc <= _DEVICE_CORPUS_MAX_TOKENS
                and n_enc >= max(min_positions,
                                 _DEVICE_CORPUS_AUTO_MIN_TOKENS))
        elif n_enc < min_positions:
            Log.fatal(f"device_corpus needs at least batch_size + 2*window "
                      f"+ 2 = {min_positions} positions; the corpus has "
                      f"{n_enc}")
    if device_corpus:
        # fast-path defaults, resolved before the model validates them
        if cfg.steps_per_call <= 1 and steps_per_call is None:
            cfg.steps_per_call = 32
        if cfg.oversample <= 1 and oversample is None:
            cfg.oversample = 2.5

    dtype_kw = {} if table_dtype is None else {"dtype": table_dtype}
    input_table = mv.create_table(
        "matrix", vocab, cfg.embedding_size, init_value="random",
        seed=cfg.seed, name="word2vec_input", **dtype_kw)
    output_table = mv.create_table(
        "matrix", vocab, cfg.embedding_size, name="word2vec_output",
        **dtype_kw)
    # word-count bookkeeping table (reference KV wordcount table)
    wordcount_table = mv.create_table("kv", name="word2vec_wordcount")
    huffman = build_huffman(counts, cfg.max_code_length) if cfg.hs else None
    model = Word2Vec(cfg, input_table, output_table, counts=counts,
                     huffman=huffman)
    model.total_words = dictionary.train_words * max(epochs, 1)
    mon = Dashboard.get_or_create("W2V_TRAIN_BATCH")
    t0 = time.perf_counter()
    if device_corpus:
        pairs, loss = _train_device_corpus(model, ids, sent_ids, counts,
                                           sample, epochs, log_every, mon,
                                           t0)
        for _ in range(epochs):
            wordcount_table.add([0], [dictionary.train_words])
        words = dictionary.train_words * epochs
        mode = " [device corpus]"
    else:
        pairs, loss, words = _train_host_stream(
            model, corpus_path, dictionary, sample, epochs, log_every, mon,
            t0, wordcount_table)
        mode = ""
    final_loss = float(loss)
    elapsed = time.perf_counter() - t0

    if output_path:
        save_embeddings(output_path, dictionary, input_table.get())
    if output_path_ctx:
        save_embeddings(output_path_ctx, dictionary, output_table.get())
    result = TrainResult(words_trained=words, pairs_trained=pairs,
                         elapsed_s=elapsed,
                         words_per_sec=words / max(elapsed, 1e-9),
                         pairs_per_sec=pairs / max(elapsed, 1e-9),
                         final_loss=final_loss)
    Log.info("trained %d words (%d pairs) in %.1fs: %.0f words/sec, "
             "%.0f pairs/sec%s", words, pairs, result.elapsed_s,
             result.words_per_sec, result.pairs_per_sec, mode)
    return result


def _train_device_corpus(model: Word2Vec, ids, sent_ids, counts, sample,
                         epochs, log_every, mon, t0):
    """The device-resident corpus path of :func:`train`; returns the
    examples trained and the last loss."""
    cfg = model.config
    n_enc = int(ids.shape[0])
    discard = subsample_probs(counts, sample).astype(np.float32)
    # corpora over the device budget rotate through EQUAL-length chunks;
    # the tail chunk wraps to the front like the in-chunk stream
    n_chunks = -(-n_enc // _DEVICE_CORPUS_MAX_TOKENS)
    chunk_len = -(-n_enc // n_chunks)
    if n_chunks > 1:
        Log.info("device corpus: %d tokens in %d chunk(s) of %d", n_enc,
                 n_chunks, chunk_len)

    def chunk_arrays(c):
        lo = c * chunk_len
        if lo + chunk_len <= n_enc:
            return ids[lo:lo + chunk_len], sent_ids[lo:lo + chunk_len]
        wrap = lo + chunk_len - n_enc
        return (np.concatenate([ids[lo:], ids[:wrap]]),
                np.concatenate([sent_ids[lo:], sent_ids[:wrap]]))

    model.load_corpus_chunk(*chunk_arrays(0), discard)
    spc = cfg.steps_per_call
    m_per_step = model._candidate_batch(chunk_len)
    # one pass samples one (center, context) pair per position; the
    # reference trains ~window+1 pairs per center word, so a skip-gram
    # epoch takes window+1 passes' worth of calls. CBOW is one example per
    # center.
    pair_factor = 1 if cfg.cbow else cfg.window + 1
    calls_per_chunk = max(1, -(-(chunk_len * pair_factor)
                               // (spc * m_per_step)))
    pairs = 0
    loss = float("nan")
    for epoch in range(epochs):
        done = 0.0
        pending = []
        call_no = 0
        for c in range(n_chunks):
            if n_chunks > 1 and (epoch > 0 or c > 0):
                model.load_corpus_chunk(*chunk_arrays(c), discard)
            for _ in range(calls_per_chunk):
                call_no += 1
                mon.begin()
                loss, count = model.train_device_steps(spc)
                mon.end()
                pending.append(count)
                if log_every and call_no % log_every == 0:
                    done += float(sum(float(x) for x in pending))
                    pending = []
                    elapsed = time.perf_counter() - t0
                    Log.info("epoch %d call %d: %.0f pairs/sec, lr %.5f, "
                             "loss %.4f", epoch, call_no,
                             (pairs + done) / elapsed, model.current_lr(),
                             float(loss))
        done += float(sum(float(x) for x in pending))
        pairs += int(done)
    return pairs, loss


def _train_host_stream(model: Word2Vec, corpus_path, dictionary, sample,
                       epochs, log_every, mon, t0, wordcount_table):
    """The host-stream path of :func:`train`: each epoch's batches come
    from :func:`iter_pair_batches` (seed ``cfg.seed + epoch``) on the
    loader thread, ``steps_per_call`` at a time through ``train_batches``
    and the tail one dispatch each; the lr follows the exact words
    consumed, and each epoch adds its words to ``wordcount_table``.
    Returns the examples trained, the last loss and the words."""
    from ..parallel import prefetch_iterator

    cfg = model.config
    group = max(1, cfg.steps_per_call)

    def batch_examples(mask: np.ndarray) -> int:
        if cfg.cbow:
            return int((mask.sum(axis=-1) > 0).sum())
        return int(mask.sum())

    pairs = 0
    loss = 0.0
    words_done = 0   # exact words consumed in finished epochs
    for epoch in range(epochs):
        progress = {"words": 0}
        batches = prefetch_iterator(
            iter_pair_batches(corpus_path, dictionary, cfg.window,
                              cfg.batch_size, sample=sample, cbow=cfg.cbow,
                              seed=cfg.seed + epoch, progress=progress),
            depth=2 * group)
        pending = []
        for step_idx, batch in enumerate(batches):
            pending.append(batch)
            if len(pending) < group:
                continue
            mon.begin()
            if group == 1:
                loss = model.train_batch(*pending[0])
            else:
                loss = model.train_batches(
                    np.stack([b[0] for b in pending]),
                    np.stack([b[1] for b in pending]),
                    np.stack([b[2] for b in pending]))
            pairs += sum(batch_examples(b[2]) for b in pending)
            pending = []
            mon.end()
            # exact lr-decay progress in word units (reference word_count);
            # finished epochs contribute their exact counts
            model.set_words_trained(words_done + progress["words"])
            if log_every and (step_idx + 1) % log_every == 0:
                elapsed = time.perf_counter() - t0
                Log.info("epoch %d step %d: %.0f pairs/sec, lr %.5f, "
                         "loss %.4f", epoch, step_idx + 1, pairs / elapsed,
                         model.current_lr(), float(loss))
        for centers, contexts, mask in pending:  # tail, one dispatch each
            loss = model.train_batch(centers, contexts, mask)
            pairs += batch_examples(mask)
        words_done += progress["words"]
        wordcount_table.add([0], [progress["words"]])
    return pairs, loss, words_done


def save_embeddings(path: str, dictionary: Dictionary,
                    vectors: np.ndarray) -> None:
    """word2vec text format (reference SaveEmbedding,
    ``distributed_wordembedding.cpp:260-328``); float32 text whatever the
    table dtype."""
    vectors = np.asarray(vectors, np.float32)
    with open(path, "w") as f:
        f.write(f"{dictionary.vocab_size} {vectors.shape[1]}\n")
        for i, word in enumerate(dictionary.words):
            vec = " ".join(f"{x:.6f}" for x in vectors[i])
            f.write(f"{word} {vec}\n")


_USAGE = (
    "usage: wordembedding -train_file FILE [-output F] [-size N] "
    "[-window N] [-negative N] [-epoch N] [-min_count N] [-sample F] "
    "[-lr F] [-batch_size N] [-read_vocab F] [-save_vocab F] "
    "[-steps_per_call N] [-oversample F] [-neg_pool N] [-row_mean -1|0|1] "
    "[-shared_negatives G] [-bf16 0|1] [-hs 0|1] [-cbow 0|1] "
    "[-use_adagrad 0|1] [-device_corpus -1|0|1] [-device=cpu]")


def main(argv: Optional[List[str]] = None) -> int:
    import torch

    import multiverso_tpu_torch as mv

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
    output = opt("output", "embeddings.txt")
    size = opt("size", 100, int)
    window = opt("window", 5, int)
    negative = opt("negative", 5, int)
    hs = bool(opt("hs", 0, int))
    cbow = bool(opt("cbow", 0, int))
    epochs = opt("epoch", 1, int)
    min_count = opt("min_count", 5, int)
    sample = opt("sample", 1e-3, float)
    lr = opt("lr", 0.025, float)
    batch = opt("batch_size", 1024, int)
    adagrad = bool(opt("use_adagrad", 0, int))
    read_vocab = opt("read_vocab", "")
    save_vocab = opt("save_vocab", "")
    device_corpus = opt("device_corpus", -1, int)  # -1 auto, 0 off, 1 on
    steps_per_call = opt("steps_per_call", -1, int)
    oversample = opt("oversample", -1.0, float)
    neg_pool = opt("neg_pool", 1 << 22, int)
    row_mean = opt("row_mean", -1, int)
    shared_negatives = opt("shared_negatives", 0, int)
    bf16 = bool(opt("bf16", 0, int))
    if not train_file:
        print(_USAGE)
        return 2
    rest = mv.init(argv)
    if rest:
        print(f"wordembedding: unknown or unported option(s): "
              f"{' '.join(rest)}\n{_USAGE}", file=sys.stderr)
        mv.shutdown()
        return 2
    try:
        cfg = Word2VecConfig(
            embedding_size=size, window=window, negative=negative, hs=hs,
            cbow=cbow, init_lr=lr, batch_size=batch, use_adagrad=adagrad,
            neg_pool_size=neg_pool,
            row_mean_updates=None if row_mean < 0 else bool(row_mean),
            shared_negatives=shared_negatives)
        dictionary = (Dictionary.load(read_vocab, min_count=min_count)
                      if read_vocab else None)
        if save_vocab:
            if dictionary is None:
                dictionary = Dictionary.build(train_file,
                                              min_count=min_count)
            dictionary.save(save_vocab)
        train(train_file, output, cfg, epochs=epochs, min_count=min_count,
              sample=sample, dictionary=dictionary,
              device_corpus=None if device_corpus < 0 else bool(device_corpus),
              table_dtype=torch.bfloat16 if bf16 else None,
              steps_per_call=steps_per_call if steps_per_call > 0 else None,
              oversample=oversample if oversample >= 0 else None)
    finally:
        mv.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
