"""Server-side updaters as functions on tensors.

Counterpart of ``multiverso_tpu/updaters.py`` (the reference updater layer,
``include/multiverso/updater/updater.h:113-132``). Each updater folds a
delta into a table's storage: ``apply(data, state, delta, option) ->
(data, state)``, run on the table's device. The JAX versions are pure
jitted functions; these return the new data for the table to install
(AdaGrad updates its accumulator slot in place). ``init_state`` builds
the state on the CPU; the table moves it to its device.

* ``default`` — ``data += delta``; integer tables always use it.
* ``sgd`` — ``data -= delta`` (the caller pre-scales by the learning rate).
* ``adagrad`` — per-worker accumulators ``G[w] += delta**2``;
  ``data -= rho / sqrt(G[w] + eps) * delta / lr``.
* ``momentum_sgd`` — ``s = m*s + (1-m)*delta; data -= s``.

``AddOption`` / ``GetOption`` keep the reference defaults (lr=.01,
momentum=0, rho=.1, lambda=.1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Type

import torch

from . import config
from .log import Log

_ADAGRAD_EPS = 1e-6


@dataclass
class AddOption:
    """Per-Add hyperparameters (``updater.h:10-70``)."""

    worker_id: int = 0
    learning_rate: float = 0.01
    momentum: float = 0.0
    rho: float = 0.1
    lam: float = 0.1


@dataclass
class GetOption:
    """Per-Get options (``updater.h:72-110``)."""

    worker_id: int = 0


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A hyperparameter as a 0-d tensor in the table dtype, rounded through
    float32 as the JAX table step receives it."""
    return torch.tensor(value, dtype=torch.float32).to(like.dtype)


class Updater:
    """Base updater: stateless accumulate (the ``default`` type).

    ``stateless`` + ``sign`` let a table add row deltas with a direct
    scatter: when ``stateless`` is True the update is
    ``data += sign * delta``. Custom subclasses default to
    ``stateless = False`` so their ``apply`` always runs.
    """

    name = "default"
    stateless = True
    sign = 1.0

    def init_state(self, shape: Tuple[int, ...], dtype: torch.dtype,
                   num_workers: int) -> Any:
        return ()

    def apply(self, data: torch.Tensor, state: Any, delta: torch.Tensor,
              option: AddOption) -> Tuple[torch.Tensor, Any]:
        return data + delta.to(data.dtype), state

    def access(self, data: torch.Tensor, state: Any,
               option: GetOption) -> torch.Tensor:
        """Read path (``Updater::Access`` = memcpy)."""
        return data


class SGDUpdater(Updater):
    name = "sgd"
    stateless = True
    sign = -1.0

    def apply(self, data, state, delta, option):
        return data - delta.to(data.dtype), state


class MomentumUpdater(Updater):
    name = "momentum_sgd"
    stateless = False

    def init_state(self, shape, dtype, num_workers):
        return torch.zeros(shape, dtype=dtype)

    def apply(self, data, state, delta, option):
        m = _scalar(option.momentum, data)
        s = m * state + (1.0 - m) * delta.to(data.dtype)
        return data - s, s


class AdaGradUpdater(Updater):
    name = "adagrad"
    stateless = False

    def init_state(self, shape, dtype, num_workers):
        return torch.zeros((num_workers,) + tuple(shape), dtype=dtype)

    def apply(self, data, state, delta, option):
        w = int(option.worker_id)
        delta = delta.to(data.dtype)
        g_sqr = state[w] + delta * delta
        state[w] = g_sqr            # in place: the table owns the state
        scale = _scalar(option.rho, data) / torch.sqrt(g_sqr + _ADAGRAD_EPS)
        lr = _scalar(option.learning_rate, data)
        return data - scale * delta / lr, state


_UPDATERS: Dict[str, Type[Updater]] = {
    "default": Updater,
    "sgd": SGDUpdater,
    "adagrad": AdaGradUpdater,
    "momentum_sgd": MomentumUpdater,
}


def register_updater(name: str, cls: Type[Updater]) -> None:
    _UPDATERS[name] = cls


def get_updater(name: Optional[str] = None,
                dtype: Optional[torch.dtype] = None) -> Updater:
    """Factory keyed by the ``updater_type`` flag (``updater.cpp:33-46``).
    Integer tables always get the default accumulate updater."""
    if dtype is not None and not (dtype.is_floating_point
                                  or dtype.is_complex):
        return Updater()
    if name is None:
        name = config.get_flag("updater_type")
    try:
        return _UPDATERS[name]()
    except KeyError:
        Log.fatal(f"unknown updater_type {name!r}; expected one of "
                  f"{sorted(_UPDATERS)}")
