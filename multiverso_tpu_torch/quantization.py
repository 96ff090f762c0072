"""Wire compression and symmetric int8 quantization (host numpy).

Counterpart of ``multiverso_tpu/quantization.py``:

* :class:`SparseFilter` (JAX :36-147, the reference ``SparseFilter`` of
  ``include/multiverso/util/quantization_util.h``): when a payload is
  sparse enough that (index, value) pairs cost fewer bytes than the
  dense values, it ships as pairs, else dense. A payload is a list of
  blobs; ``filter_in`` appends one trailing int64 size-info blob
  (original element count, or -1 for a blob shipped dense) and
  ``filter_out`` inverts it.
* :func:`quantize_int8` / :func:`dequantize_int8` (JAX :153-182):
  symmetric max-abs int8 with an fp32 scale, for the int8 decode
  parameter pins (``serving/snapshot.py``) and the parameter plane's
  int8 wire codec. ``np.rint`` rounds half to even, as ``torch.round``
  and ``jnp.round`` do.

numpy has no bfloat16, so a bf16 blob is a torch CPU tensor here (the
JAX package's is an ``ml_dtypes`` array): the filter moves its raw
16-bit words, which are the JAX bytes, tests the clip on their exact
float32 widening, and gives bf16 back as a torch tensor. The paged KV
pools' quantize-on-write lives beside the serving programs in
``models/transformer.py``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from .log import Log

_INDEX_DTYPE = np.dtype(np.int32)
_WORD = np.dtype(np.uint16)


def is_bf16(dtype: Any) -> bool:
    """``torch.bfloat16`` or the name ``"bfloat16"``."""
    return dtype is torch.bfloat16 or (isinstance(dtype, str)
                                       and dtype == "bfloat16")


def bf16_words(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor's raw 16-bit words as a flat uint16 ndarray."""
    return (t.detach().contiguous().cpu().view(torch.int16).numpy()
            .view(_WORD).ravel())


def bf16_from_words(words: np.ndarray, shape=None) -> torch.Tensor:
    """Raw 16-bit words -> a torch CPU bf16 tensor (a private copy)."""
    w = np.ascontiguousarray(words, _WORD).view(np.int16).copy()
    t = torch.from_numpy(w).view(torch.bfloat16)
    return t.reshape(shape) if shape is not None else t


def _widen(words: np.ndarray) -> np.ndarray:
    """bf16 words -> their exact float32 values."""
    return (words.astype(np.uint32) << 16).view(np.float32)


def wire_dtype(dtype: Any) -> Any:
    """A table or array dtype as the wire sees it: ``torch.bfloat16``,
    else a numpy dtype (from a torch dtype, a numpy dtype or a name)."""
    if is_bf16(dtype):
        return torch.bfloat16
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def cast_host(values: Any, dtype: Any) -> Any:
    """Host ``values`` (numpy or a tensor) in wire dtype ``dtype``: a
    torch CPU tensor for bf16 (rounded through float32, as the JAX
    package's ``ml_dtypes`` cast of float32 rounds), else numpy."""
    dtype = wire_dtype(dtype)
    if dtype is torch.bfloat16:
        if isinstance(values, torch.Tensor):
            return values.detach().cpu().to(torch.bfloat16)
        return torch.from_numpy(np.array(values, np.float32)).to(
            torch.bfloat16)
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu()
        if values.dtype == torch.bfloat16:
            values = values.float()
        values = values.numpy()
    return np.asarray(values, dtype)


def nbytes(blob: Any) -> int:
    if isinstance(blob, torch.Tensor):
        return blob.numel() * blob.element_size()
    return np.asarray(blob).nbytes


def _numel(blob: Any) -> int:
    if isinstance(blob, torch.Tensor):
        return blob.numel()
    return np.asarray(blob).size


def _host(blob: Any) -> Any:
    """A pass-through blob: numpy as numpy, a tensor on the host."""
    if isinstance(blob, torch.Tensor):
        return blob.detach().cpu()
    return np.asarray(blob)


class SparseFilter:
    """Sparsity-gated (index, value) wire compression (JAX
    ``quantization.py:36``).

    ``clip``: magnitude at or below which a value counts as zero.
    ``skip_option_blob``: the payload's last blob passes through.
    ``dtype``: the value type (a numpy dtype, or ``torch.bfloat16``);
    indices are int32.
    """

    def __init__(self, clip: float = 0.0, skip_option_blob: bool = False,
                 dtype=np.float32) -> None:
        self.clip = float(clip)
        self.skip_option_blob = bool(skip_option_blob)
        self._bf16 = is_bf16(dtype)
        self.dtype = torch.bfloat16 if self._bf16 else np.dtype(dtype)
        self._itemsize = 2 if self._bf16 else self.dtype.itemsize

    def _flat(self, blob: Any):
        """``(stored words or values, their magnitudes)`` of a blob."""
        if self._bf16:
            if isinstance(blob, torch.Tensor):
                words = bf16_words(blob.to(torch.bfloat16))
            else:
                words = bf16_words(torch.from_numpy(np.ascontiguousarray(
                    blob, np.float32)).to(torch.bfloat16))
            return words, np.abs(_widen(words))
        if isinstance(blob, torch.Tensor):
            blob = blob.detach().cpu().numpy()
        flat = np.ascontiguousarray(blob, dtype=self.dtype).ravel()
        return flat, np.abs(flat)

    # -- single-blob primitives (``TryCompress`` / ``DeCompress``) ---------
    def try_compress(self, blob: Any) -> Optional[np.ndarray]:
        """The compressed pair buffer (uint8), or None when the pairs
        would cost at least the dense bytes."""
        flat, mag = self._flat(blob)
        keep = mag > self.clip
        n_keep = int(keep.sum())
        pair_bytes = _INDEX_DTYPE.itemsize + self._itemsize
        if n_keep * pair_bytes >= flat.nbytes:
            return None
        indices = np.nonzero(keep)[0].astype(_INDEX_DTYPE)
        values = flat[keep]
        out = np.empty(indices.nbytes + values.nbytes, np.uint8)
        out[: indices.nbytes] = indices.view(np.uint8)
        out[indices.nbytes:] = values.view(np.uint8)
        return out

    def decompress(self, comp: np.ndarray, count: int) -> Any:
        """Inverse of ``try_compress`` given the original element count
        (a torch bf16 tensor for a bf16 filter)."""
        pair_bytes = _INDEX_DTYPE.itemsize + self._itemsize
        if comp.nbytes % pair_bytes:
            Log.fatal(
                f"corrupt compressed blob: {comp.nbytes} bytes not a multiple "
                f"of pair size {pair_bytes}")
        n_pairs = comp.nbytes // pair_bytes
        buf = np.ascontiguousarray(comp).view(np.uint8)
        indices = buf[: n_pairs * _INDEX_DTYPE.itemsize].view(_INDEX_DTYPE)
        store = _WORD if self._bf16 else self.dtype
        values = buf[n_pairs * _INDEX_DTYPE.itemsize:].view(store)
        if n_pairs and (indices.min() < 0 or indices.max() >= count):
            Log.fatal(
                f"corrupt compressed blob: index out of range for count {count}")
        out = np.zeros(count, store)
        out[indices] = values
        return bf16_from_words(out) if self._bf16 else out

    # -- payload API (``FilterIn`` / ``FilterOut``) ------------------------
    def filter_in(self, blobs: Sequence[Any]) -> List[Any]:
        """Compress a payload; appends the trailing size-info blob."""
        out: List[Any] = []
        size_info = np.empty(len(blobs), np.int64)
        for i, blob in enumerate(blobs):
            if self.skip_option_blob and i == len(blobs) - 1:
                out.append(_host(blob))
                size_info[i] = -1
                continue
            comp = self.try_compress(blob)
            if comp is None:
                out.append(_host(blob))
                size_info[i] = -1
            else:
                out.append(comp)
                size_info[i] = _numel(blob)
        out.append(size_info)
        return out

    def filter_out(self, blobs: Sequence[Any]) -> List[Any]:
        """Invert ``filter_in`` (drops the size-info blob)."""
        if not blobs:
            return []
        size_info = np.asarray(blobs[-1], np.int64)
        payload = blobs[:-1]
        if size_info.size != len(payload):
            Log.fatal(
                f"size-info blob has {size_info.size} entries for "
                f"{len(payload)} payload blobs")
        out: List[Any] = []
        for blob, count in zip(payload, size_info):
            if count < 0:
                out.append(_host(blob))
            else:
                out.append(self.decompress(np.asarray(blob), int(count)))
        return out

    def compressed_ratio(self, blobs: Sequence[Any],
                         filtered: Sequence[Any]) -> float:
        """Wire bytes after / before (diagnostic)."""
        before = sum(nbytes(b) for b in blobs)
        after = sum(nbytes(b) for b in filtered)
        return after / max(before, 1)


# -- int8 symmetric quantization ----------------------------------------------

INT8_QMAX = 127.0


def _as_f32(arr: Any) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().to("cpu", torch.float32).numpy()
    return np.asarray(arr).astype(np.float32, copy=False)


def quantize_int8(arr: Any, axis: Optional[int] = None):
    """Symmetric max-abs int8: ``(q int8, scale fp32)``.

    ``axis=None`` gives one per-tensor scale of shape ``(1,)``; an int
    ``axis`` gives per-slice scales with ``keepdims`` (the per-column
    form for matrices: the scale broadcasts over the quantized axis and
    keeps the tensor's rank). A zero slice gets scale 0 and dequantizes
    to exact zeros. A bf16 tensor is widened to float32 first (exact)."""
    a = _as_f32(arr)
    if axis is None:
        amax = np.max(np.abs(a), initial=0.0)
        scale = np.asarray([amax / INT8_QMAX], np.float32)
        safe = scale[0] if scale[0] > 0 else 1.0
        q = np.clip(np.rint(a / safe), -INT8_QMAX, INT8_QMAX)
        return q.astype(np.int8), scale
    amax = np.max(np.abs(a), axis=axis, keepdims=True)
    scale = (amax / INT8_QMAX).astype(np.float32)
    safe = np.where(scale > 0, scale, 1.0)
    q = np.clip(np.rint(a / safe), -INT8_QMAX, INT8_QMAX)
    return q.astype(np.int8), scale


def dequantize_int8(q: np.ndarray, scale: np.ndarray,
                    dtype=np.float32) -> Any:
    """Inverse of :func:`quantize_int8` (JAX ``quantization.py:174``; the
    scale broadcasts, a ``(1,)`` scale multiplies through). The product
    is float32; ``dtype`` bf16 rounds it to nearest even into a torch
    tensor, as the ``ml_dtypes`` cast does."""
    q = np.asarray(q, np.float32)
    scale = np.asarray(scale, np.float32)
    prod = q * (scale.reshape(()) if scale.size == 1 else scale)
    if is_bf16(dtype):
        return torch.from_numpy(np.ascontiguousarray(prod)).to(
            torch.bfloat16)
    return prod.astype(dtype)
