"""Logistic regression / softmax / FTRL model family.

Counterpart of ``multiverso_tpu/models/logreg.py`` (the reference
LogisticRegression application's model layer,
``Applications/LogisticRegression/src``): the objectives (linear, sigmoid,
softmax; FTRL-proximal), the L1/L2 regularisers, dense minibatch training
against a weight table, and the keyed sparse and FTRL paths.

* :class:`LogReg` — one minibatch step on the matrix table's tensor, on
  its device: the forward, the objective's gradient in closed form
  (``(p - y) / B`` against the scores for sigmoid and softmax, ``(s - y) /
  B`` for the squared error; the JAX step's autodiff of the same losses),
  the L1/L2 term, ``delta = lr * grads``, and the table's updater, under
  the table lock. The GEMMs are ``torch.matmul``, as the JAX package
  leaves them to XLA: no kernel of this repository is on this path.
* :class:`FTRLLogReg` — the closed-form weights and the ``(z, n)``
  updates in float64 on the host, over an ``FTRLTable`` (the row gather
  and scatter-add kernels at 8-byte rows).
* :class:`SparseLogReg` — pull the minibatch's keyset from a
  ``SparseTable`` (the row gather kernel at 4-byte rows), the gradient in
  float64 on the host, push keyed deltas (the scatter-add kernel), with
  the JAX model's local weight cache and ``sync_frequency`` windows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..log import Log
from ..updaters import AddOption


@dataclass
class LogRegConfig:
    """Mirrors the reference config file keys (``LR/src/configure.h:9-93``)."""

    input_size: int = 0          # feature dim (bias handled internally)
    output_size: int = 1         # 1 = binary, >1 = softmax classes
    objective_type: str = "sigmoid"   # linear|sigmoid|softmax|ftrl
    regular_type: str = "none"        # none|l1|l2
    regular_coef: float = 0.0
    learning_rate: float = 0.1
    learning_rate_coef: float = 1.0   # lr decay: lr/(1+coef*t) (reference sgd)
    minibatch_size: int = 64
    sparse: bool = False
    sync_frequency: int = 1
    pipeline: bool = False
    reader_type: str = "default"      # default|weight|bsparse (LR/src/reader.cpp:212)
    read_buffer_size: int = 4096      # async reader ring (LR/src/configure.h:31)
    # FTRL hyperparameters (LR/src/configure.h)
    ftrl_alpha: float = 0.1
    ftrl_beta: float = 1.0
    ftrl_lambda1: float = 0.001
    ftrl_lambda2: float = 0.001


def _regular_grad(w: torch.Tensor, kind: str,
                  coef: float) -> Optional[torch.Tensor]:
    """The regulariser's gradient, or None for ``none``."""
    if kind == "l2":
        return coef * w
    if kind == "l1":
        return coef * torch.sign(w)
    return None


def _f32(value: float) -> float:
    """A hyperparameter rounded to float32, as the JAX step receives it."""
    return float(np.float32(value))


class LogReg:
    """Dense model against a MatrixTable of weights [output, input+1].

    The trailing column is the bias. ``train_minibatch`` is the
    reference's ``Model::Update`` + ``PSModel::UpdateTable`` in one step
    (``LR/src/model/model.cpp:58-123``, ``ps_model.cpp:185``).
    """

    def __init__(self, cfg: LogRegConfig, table) -> None:
        if cfg.objective_type not in ("linear", "sigmoid", "softmax"):
            Log.fatal(f"LogReg: unsupported objective {cfg.objective_type!r} "
                      "(use FTRLLogReg for ftrl)")
        if cfg.output_size < 1:
            Log.fatal("output_size must be >= 1")
        if table.updater.name == "default":
            # the step pre-scales delta = lr*grads; the accumulate updater
            # would ADD it (gradient ascent). The reference pins sgd too
            # (ps_model.cpp:24)
            Log.fatal("LogReg requires a descent updater on its table "
                      "(create it with updater='sgd'/'momentum_sgd'/'adagrad')")
        self.cfg = cfg
        self.table = table
        self._steps = 0

    # -- math --------------------------------------------------------------
    def _scores(self, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return x @ w[:, :-1].t() + w[:, -1]

    @torch.no_grad()
    def _forward(self, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """x: [B, input]; w: [output, input+1] -> predictions [B, output]."""
        scores = self._scores(w, x)
        obj = self.cfg.objective_type
        if obj == "sigmoid":
            return torch.sigmoid(scores)
        if obj == "softmax":
            return torch.softmax(scores, dim=-1)
        return scores

    @torch.no_grad()
    def _loss_grads(self, w: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor):
        """``(loss, d loss / d w)`` of the minibatch mean loss."""
        scores = self._scores(w, x)
        B = x.shape[0]
        obj = self.cfg.objective_type
        if obj == "sigmoid":
            # y: [B, output] in {0, 1}
            loss = torch.mean(torch.sum(F.softplus(scores) - y * scores, -1))
            g = torch.sigmoid(scores) - y
        elif obj == "softmax":
            logp = torch.log_softmax(scores, dim=-1)
            loss = -torch.mean(torch.sum(y * logp, -1))
            g = torch.exp(logp) * y.sum(-1, keepdim=True) - y
        else:  # linear: squared error
            diff = scores - y
            loss = 0.5 * torch.mean(torch.sum(diff * diff, -1))
            g = diff
        g = g / B
        grads = torch.cat([g.t() @ x, g.sum(0)[:, None]], dim=1)
        return loss, grads

    # -- API ---------------------------------------------------------------
    def current_lr(self) -> float:
        cfg = self.cfg
        return cfg.learning_rate / (1.0 + cfg.learning_rate_coef * self._steps)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            self.table.device)

    def train_minibatch(self, x: np.ndarray, y: np.ndarray,
                        option: Optional[AddOption] = None) -> torch.Tensor:
        """One minibatch step; y is [B, output] (one-hot for softmax).
        Returns the loss as a device scalar."""
        cfg = self.cfg
        option = option or AddOption()
        option.learning_rate = self.current_lr()
        x_t, y_t = self._to_device(x), self._to_device(y)
        t = self.table
        with t._lock:
            loss, grads = self._loss_grads(t._data, x_t, y_t)
            reg = _regular_grad(t._data.float(), cfg.regular_type,
                                cfg.regular_coef)
            if reg is not None:
                grads = grads + reg
            delta = grads * _f32(option.learning_rate)
            t._data, t._ustate = t.updater.apply(t._data, t._ustate, delta,
                                                 option)
            t.version += 1
        self._steps += 1
        return loss

    def predict(self, x: np.ndarray) -> np.ndarray:
        x_t = self._to_device(x)
        with self.table._lock:
            out = self._forward(self.table._data, x_t)
        return out.cpu().numpy()

    def test(self, x: np.ndarray, y: np.ndarray) -> float:
        """Accuracy (reference ``LogReg::Test``, ``LR/src/logreg.cpp:118``)."""
        preds = self.predict(x)
        if self.cfg.output_size == 1:
            correct = (preds[:, 0] > 0.5) == (y.ravel() > 0.5)
        else:
            correct = preds.argmax(-1) == y.argmax(-1)
        return float(np.mean(correct))


def _sigmoid(score: float) -> float:
    return 1.0 / (1.0 + np.exp(-np.clip(score, -35, 35)))


def _log_loss(pred: float, label: float) -> float:
    eps = 1e-12
    return -(label * np.log(pred + eps) + (1 - label) * np.log(1 - pred + eps))


class FTRLLogReg:
    """FTRL-proximal binary LR over an FTRLTable of (z, n) state: the
    worker's closed-form weights and the server's (z, n) accumulation
    (``LR/src/objective/ftrl*``, ``util/ftrl_sparse_table.h``), touched
    keys only."""

    def __init__(self, cfg: LogRegConfig, table) -> None:
        self.cfg = cfg
        self.table = table  # FTRLTable of size input_size + 1 (bias key = last)
        self.bias_key = cfg.input_size

    def _weights_from_zn(self, z: np.ndarray, n: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        sign = np.sign(z)
        w = -(z - sign * cfg.ftrl_lambda1) / (
            (cfg.ftrl_beta + np.sqrt(n)) / cfg.ftrl_alpha + cfg.ftrl_lambda2)
        w[np.abs(z) <= cfg.ftrl_lambda1] = 0.0
        return w

    def _with_bias(self, keys, values):
        return (np.concatenate([np.asarray(keys, np.int64), [self.bias_key]]),
                np.concatenate([np.asarray(values, np.float64), [1.0]]))

    def train_sample(self, keys: np.ndarray, values: np.ndarray,
                     label: float) -> float:
        """One sparse sample: keys/values + bias; returns the loss."""
        cfg = self.cfg
        keys, values = self._with_bias(keys, values)
        z, n = self.table.get_keys(keys)
        w = self._weights_from_zn(np.asarray(z, np.float64),
                                  np.asarray(n, np.float64))
        pred = _sigmoid(float(w @ values))
        g = (pred - label) * values
        # n stays the table's float32 here, as in the JAX model
        sigma = (np.sqrt(n + g * g) - np.sqrt(n)) / cfg.ftrl_alpha
        delta_z = g - sigma * w
        delta_n = g * g
        self.table.add_keys(keys, delta_z, delta_n)
        return float(_log_loss(pred, label))

    def predict_sample(self, keys: np.ndarray, values: np.ndarray) -> float:
        keys, values = self._with_bias(keys, values)
        z, n = self.table.get_keys(keys)
        w = self._weights_from_zn(np.asarray(z, np.float64),
                                  np.asarray(n, np.float64))
        return _sigmoid(float(w @ values))


class SparseLogReg:
    """Binary LR over a SparseTable, touched-keys-only traffic (the
    reference's sparse PS path, ``LR/src/model/ps_model.cpp`` with
    ``SparseWorkerTable``): pull the minibatch's keyset, the gradient on
    the host, push keyed deltas (the sgd updater applies ``-=``)."""

    def __init__(self, cfg: LogRegConfig, table) -> None:
        self.cfg = cfg
        self.table = table  # SparseTable(input_size + 1, updater="sgd")
        self.bias_key = cfg.input_size
        self._steps = 0
        # local weight cache: a fresh Get every ``sync_frequency``
        # minibatches (reference DoesNeedSync, ``ps_model.cpp:172``);
        # deltas are pushed every minibatch and mirrored here in between
        self._w_cache: Dict[int, float] = {}
        self._cache_fresh = False

    @property
    def steps(self) -> int:
        """Minibatches trained so far; window phase = ``steps % sync_frequency``."""
        return self._steps

    def current_lr(self) -> float:
        cfg = self.cfg
        return cfg.learning_rate / (1.0 + cfg.learning_rate_coef * self._steps)

    def _fetch_into_cache(self, keys: np.ndarray) -> None:
        values = np.asarray(self.table.get_keys(keys), np.float64)
        for k, v in zip(keys, values):
            self._w_cache[int(k)] = float(v)

    def load_cache(self, keys: np.ndarray, values: np.ndarray) -> None:
        """Install a pipelined pull's result for the coming sync window;
        the next window-boundary refresh in :meth:`train_minibatch` then
        fetches only the keys the pull missed."""
        for k, v in zip(np.asarray(keys, np.int64).tolist(),
                        np.asarray(values, np.float64).tolist()):
            self._w_cache[int(k)] = float(v)
        self._cache_fresh = True

    def _fetch_missing(self, all_keys) -> None:
        missing = np.asarray([k for k in all_keys
                              if k not in self._w_cache], np.int64)
        if missing.size:
            self._fetch_into_cache(missing)

    def train_minibatch(self, samples) -> float:
        """samples: list of (keys, values, label)."""
        all_keys = sorted({int(k) for keys, _, _ in samples for k in keys}
                          | {self.bias_key})
        key_arr = np.asarray(all_keys, np.int64)
        idx = {k: i for i, k in enumerate(all_keys)}
        window_start = self._steps % max(self.cfg.sync_frequency, 1) == 0
        if window_start and not self._cache_fresh:
            self._fetch_into_cache(key_arr)  # full refresh this window
        else:
            if window_start:
                self._cache_fresh = False  # window pre-pulled (load_cache)
            self._fetch_missing(all_keys)
        w = np.asarray([self._w_cache[k] for k in all_keys], np.float64)
        grad = np.zeros_like(w)
        loss = 0.0
        for keys, values, label in samples:
            cols = [idx[int(k)] for k in keys] + [idx[self.bias_key]]
            vals = np.concatenate([np.asarray(values, np.float64), [1.0]])
            pred = _sigmoid(float(w[cols] @ vals))
            grad[cols] += (pred - label) * vals
            loss += _log_loss(pred, label)
        grad /= len(samples)
        delta = self.current_lr() * grad  # sgd updater applies data -= delta
        self.table.add_keys(key_arr, delta.astype(np.float32))
        for k, d in zip(all_keys, delta):  # read-your-writes between syncs
            self._w_cache[k] = self._w_cache.get(k, 0.0) - float(d)
        self._steps += 1
        return loss / len(samples)

    def predict_sample(self, keys, values) -> float:
        key_arr = np.concatenate([np.asarray(keys, np.int64), [self.bias_key]])
        vals = np.concatenate([np.asarray(values, np.float64), [1.0]])
        w = np.asarray(self.table.get_keys(key_arr), np.float64)
        return _sigmoid(float(w @ vals))
