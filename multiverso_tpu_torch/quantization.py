"""Symmetric max-abs int8 quantization with an fp32 scale (host numpy).

Counterpart of ``multiverso_tpu/quantization.py::quantize_int8``: the
host-side quantizer the serving stack's int8 decode parameter pins use
(``serving/snapshot.py``). The paged KV pools' quantize-on-write and
dequantize-on-gather live beside the serving programs in
``models/transformer.py``. ``np.rint`` rounds half to even, as
``torch.round`` and ``jnp.round`` do.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

INT8_QMAX = 127.0


def quantize_int8(arr: np.ndarray, axis: Optional[int] = None):
    """Symmetric max-abs int8: ``(q int8, scale fp32)``.

    ``axis=None`` gives one per-tensor scale of shape ``(1,)``; an int
    ``axis`` gives per-slice scales with ``keepdims`` (the per-column
    form for matrices: the scale broadcasts over the quantized axis and
    keeps the tensor's rank). A zero slice gets scale 0 and dequantizes
    to exact zeros."""
    arr = np.asarray(arr)
    a = arr.astype(np.float32, copy=False)
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

