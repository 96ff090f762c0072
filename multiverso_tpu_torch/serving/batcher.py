"""Typed serving errors and shape buckets.

Counterpart of the part of ``multiverso_tpu/serving/batcher.py`` that the
decode engine uses: the fast-reject error types and the padded shape
buckets. The micro-batcher itself is not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


class OverloadedError(RuntimeError):
    """Typed fast-reject: the model is out of a bounded resource. ``what``
    names the resource; ``retriable`` says whether a retry can succeed."""

    def __init__(self, model: str, depth: int, cap: int,
                 what: str = "queue depth", retriable: bool = True) -> None:
        super().__init__(
            f"serving {what} for {model!r} at cap ({depth}/{cap}); "
            "request shed")
        self.model = model
        self.depth = depth
        self.cap = cap
        self.what = what
        self.retriable = bool(retriable)


class DeadlineExceededError(RuntimeError):
    """The request's deadline passed before it completed."""


def shape_buckets(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to ``max_batch`` (``max_batch`` always included)."""
    buckets: List[int] = []
    b = 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return tuple(buckets)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (callers guarantee n <= max(buckets))."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]
