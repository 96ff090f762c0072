"""Logistic-regression application: config-file driven train/test.

Counterpart of ``multiverso_tpu/apps/logreg.py`` (the reference
LogisticRegression app driver, ``Applications/LogisticRegression/src/
logreg.cpp``): a key=value config file (``LR/src/configure.h:9-93``), the
readers of :mod:`.lr_reader`, the epoch loop with minibatch updates, test
accuracy, and model save/load through ``io/stream``. With
``pipeline=true`` the dense path parses on a loader thread
(``parallel.prefetch_iterator``) and the sparse path runs the reference's
double-buffered pull (``AsyncSampleReader`` + ``PipelinedGetter``);
``sync_frequency=N`` makes the sparse model refresh its pulled weights
every N minibatches (``PSModel::DoesNeedSync``, ``ps_model.cpp:172``).

The tables live on the session's device: the dense model's matrix, the
sparse model's ``SparseTable`` (every Get is the row gather kernel, every
Add the row scatter-add kernel) or the FTRL model's ``FTRLTable``.

Usage: ``python -m multiverso_tpu_torch.apps.logreg train.config`` runs on
the card; add ``-device=cpu`` after the config file for the CPU.
"""

from __future__ import annotations

import os
import sys
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..io.stream import TextReader, open_stream
from ..log import Log
from ..models.logreg import FTRLLogReg, LogReg, LogRegConfig, SparseLogReg
from ..parallel import PipelinedGetter, prefetch_iterator
from .lr_reader import AsyncSampleReader, batched, parse_default, sample_iterator


def parse_config(path: str) -> dict:
    """key=value config file (reference ``Configure``, ``LR/src/configure.cpp``)."""
    out = {}
    with TextReader(path) as reader:
        for line in reader:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            key, _, value = line.partition("=")
            out[key.strip()] = value.strip()
    return out


def config_from_dict(d: dict) -> LogRegConfig:
    cfg = LogRegConfig()
    casts = {
        "input_size": int, "output_size": int, "minibatch_size": int,
        "sync_frequency": int, "read_buffer_size": int,
        "learning_rate": float,
        "learning_rate_coef": float, "regular_coef": float,
        "ftrl_alpha": float, "ftrl_beta": float,
        "ftrl_lambda1": float, "ftrl_lambda2": float,
    }
    for key, value in d.items():
        if key in ("objective_type", "regular_type", "reader_type"):
            setattr(cfg, key, value)
        elif key in ("sparse", "pipeline"):
            setattr(cfg, key, value.lower() in ("1", "true", "yes"))
        elif key in casts:
            setattr(cfg, key, casts[key](value))
    return cfg


# libsvm/dense text parsing lives in lr_reader; kept under the JAX name
parse_sample = parse_default


def iter_samples(path: str, sparse: bool, input_size: int,
                 reader_type: str = "default"):
    """Reader-factory front door (``SampleReader::Get``,
    ``LR/src/reader.cpp:212``); see :mod:`.lr_reader` for the variants."""
    yield from sample_iterator(reader_type, path, sparse, input_size)


def iter_dense_minibatches(path: str, cfg: LogRegConfig
                           ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Fixed-size [B, input] / [B, output] batches for the dense jitted path."""
    xs, ys = [], []
    for label, _, values in iter_samples(path, False, cfg.input_size,
                                         cfg.reader_type):
        xs.append(values)
        if cfg.output_size == 1:
            ys.append([label])
        else:
            onehot = np.zeros(cfg.output_size, np.float32)
            onehot[int(label)] = 1.0
            ys.append(onehot)
        if len(xs) == cfg.minibatch_size:
            yield np.stack(xs), np.asarray(ys, np.float32)
            xs, ys = [], []
    if xs:
        yield np.stack(xs), np.asarray(ys, np.float32)


def build_model(cfg: LogRegConfig):
    """Table + model factory (reference ``Model::Get``/``PSModel`` ctor,
    ``LR/src/model/model.cpp:212``, ``ps_model.cpp:13-67``)."""
    import multiverso_tpu_torch as mv

    if cfg.objective_type == "ftrl":
        table = mv.create_table("ftrl", cfg.input_size + 1, name="logreg_ftrl")
        return FTRLLogReg(cfg, table)
    if cfg.sparse:
        table = mv.create_table("sparse", cfg.input_size + 1, updater="sgd",
                                name="logreg_sparse")
        return SparseLogReg(cfg, table)
    table = mv.create_table("matrix", cfg.output_size, cfg.input_size + 1,
                            updater="sgd", name="logreg_weights")
    return LogReg(cfg, table)


def train_file(model, cfg: LogRegConfig, path: str, epochs: int = 1,
               log_every: int = 100) -> float:
    """Epoch loop (reference ``LogReg::Train``, ``LR/src/logreg.cpp:40``)."""
    loss = 0.0
    for epoch in range(epochs):
        if isinstance(model, LogReg):
            batches = iter_dense_minibatches(path, cfg)
            if cfg.pipeline:
                batches = prefetch_iterator(batches, depth=4)
            for i, (x, y) in enumerate(batches):
                loss = model.train_minibatch(x, y)
                if log_every and (i + 1) % log_every == 0:
                    Log.info("epoch %d batch %d loss %.4f", epoch, i + 1,
                             float(loss))
            loss = float(loss)
        elif isinstance(model, SparseLogReg):
            loss = _train_sparse_epoch(model, cfg, path)
        else:  # FTRL: per-sample proximal updates
            for label, keys, values in iter_samples(
                    path, True, cfg.input_size, cfg.reader_type):
                loss = model.train_sample(keys, values, label)
    return float(loss)


def _train_sparse_epoch(model: SparseLogReg, cfg: LogRegConfig, path: str
                        ) -> float:
    """One epoch of the sparse PS path.

    ``pipeline=true`` runs the reference's double-buffered pull
    (``PSModel::GetPipelineTable``, ``LR/src/model/ps_model.cpp:236``): the
    async reader publishes each sync window's keyset ahead of time, a
    background getter pulls those rows while the current window trains, and
    the result lands in the model cache at the window boundary.
    """
    loss = 0.0
    samples = sample_iterator(cfg.reader_type, path, True, cfg.input_size)
    sync_every = max(cfg.sync_frequency, 1)
    if not cfg.pipeline:
        for batch in batched(samples, cfg.minibatch_size):
            loss = model.train_minibatch(
                [(keys, values, label) for label, keys, values in batch])
        return loss
    window = cfg.minibatch_size * sync_every
    reader = AsyncSampleReader(
        samples, window_size=window, bias_key=model.bias_key,
        # At the start of window j the consumer blocks on keyset j+1, which
        # the loader publishes only after parsing 2*window samples past the
        # consumer's position — the ring must hold that much.
        buffer_samples=max(cfg.read_buffer_size, 2 * window))
    getter = PipelinedGetter(lambda ks: (ks, model.table.get_keys(ks)))
    in_flight = False
    first = reader.next_keyset()
    if first is not None:
        getter.prime(first)
        in_flight = True
    try:
        for batch_idx, batch in enumerate(batched(reader, cfg.minibatch_size)):
            # Align on the per-epoch batch index: the reader's keyset windows
            # restart at sample 0 each epoch, so the boundary phase must
            # restart with them (model.steps carries phase across epochs
            # whenever an epoch's batch count is not a multiple of
            # sync_frequency, which would misalign every later window).
            if in_flight and batch_idx % sync_every == 0:
                nxt = reader.next_keyset()
                pulled = getter.get(nxt)
                in_flight = nxt is not None
                model.load_cache(*pulled)
            loss = model.train_minibatch(
                [(keys, values, label) for label, keys, values in batch])
    finally:
        reader.close()
    return loss


def test_file(model, cfg: LogRegConfig, path: str) -> float:
    """Accuracy over a test file (reference ``LogReg::Test``)."""
    if isinstance(model, LogReg):
        correct = total = 0
        for x, y in iter_dense_minibatches(path, cfg):
            preds = model.predict(x)
            if cfg.output_size == 1:
                correct += int((((preds[:, 0] > 0.5) == (y[:, 0] > 0.5))).sum())
            else:
                correct += int((preds.argmax(-1) == y.argmax(-1)).sum())
            total += x.shape[0]
        return correct / max(total, 1)
    correct = total = 0
    for label, keys, values in iter_samples(path, True, cfg.input_size,
                                            cfg.reader_type):
        pred = model.predict_sample(keys, values)
        correct += int((pred > 0.5) == (label > 0.5))
        total += 1
    return correct / max(total, 1)


def save_model(model, path: str) -> None:
    with open_stream(path, "wb") as stream:
        model.table.store(stream)


def load_model(model, path: str) -> None:
    with open_stream(path, "rb") as stream:
        model.table.load(stream)


def main(argv: Optional[List[str]] = None) -> int:
    import multiverso_tpu_torch as mv

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: logreg <config-file> [-device=cpu]")
        return 2
    if not os.path.exists(argv[0]):
        print(f"logreg: config file not found: {argv[0]}")
        return 2
    conf = parse_config(argv[0])
    mv.init(argv[1:])
    cfg = config_from_dict(conf)
    model = build_model(cfg)
    if conf.get("init_model_file"):
        load_model(model, conf["init_model_file"])
    if conf.get("train_file"):
        epochs = int(conf.get("train_epoch", "1"))
        loss = train_file(model, cfg, conf["train_file"], epochs=epochs)
        Log.info("final train loss: %.4f", loss)
    if conf.get("test_file"):
        acc = test_file(model, cfg, conf["test_file"])
        Log.info("test accuracy: %.4f", acc)
    if conf.get("output_model_file"):
        save_model(model, conf["output_model_file"])
    mv.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
