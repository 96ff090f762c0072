"""The async-PS record framing and the trainer epoch fence.

Counterpart of the framing half of ``multiverso_tpu/parallel/async_ps.py``
(record kinds and ``_HEADER`` :84-95, ``_serialize``/``_deserialize``
:117-150, ``_kv_get_int`` :152, ``claim_epoch`` :165, ``EpochFence`` :213),
which the parameter plane (``serving/param_plane.py``) rides. The records
are byte-compatible with the JAX package's: a ``_HEADER`` then
``n_arrays`` ``MVTA`` array records (``io/stream.write_array``).

The delta bus itself (``AsyncDeltaBus``: publish, drain thread, acks,
chunking and backpressure) is the distributed slice's (ROADMAP.md Queue 1
item 8); this module starts and offers none.
"""

from __future__ import annotations

import io
import struct
import time
from typing import Optional, Sequence

from .. import trace
from ..log import Log

# record kinds (STATE carries the absolute table value: the fenced
# restart's rebase record, installed, not folded)
DENSE, KEYED, KV, PART, STATE = 0, 1, 2, 3, 4

_HEADER = struct.Struct("<BBiiffffdQQIQ")  # kind, n_arrays, table_id,
#                          worker_id, lr, momentum, rho, lam, send_ts,
#                          trace_id, span_id (0, 0 = untraced publish),
#                          epoch (u32; trainer incarnation, 0 =
#                          unfenced), version (u64; the publisher's
#                          post-apply table version, 0 = unknown)


def _serialize(kind: int, table_id: int, option, arrays: Sequence,
               ctx: Optional[trace.SpanContext] = None, epoch: int = 0,
               version: int = 0) -> bytes:
    """One record: the header (``send_ts`` = ``time.time()``) and the
    arrays (numpy, or torch bf16 tensors) as ``MVTA`` records."""
    from ..io.stream import write_array

    tid, sid = (ctx.trace_id, ctx.span_id) if ctx is not None else (0, 0)
    buf = io.BytesIO()
    buf.write(_HEADER.pack(kind, len(arrays), table_id,
                           int(getattr(option, "worker_id", 0)),
                           float(getattr(option, "learning_rate", 0.0)),
                           float(getattr(option, "momentum", 0.0)),
                           float(getattr(option, "rho", 0.0)),
                           float(getattr(option, "lam", 0.0)),
                           time.time(), tid, sid, int(epoch),
                           int(version)))
    for arr in arrays:
        write_array(buf, arr)
    return buf.getvalue()


def _deserialize(data: bytes):
    """``(kind, table_id, option, arrays, send_ts, ctx, epoch,
    version)``; a ``bfloat16`` array comes back as a torch CPU tensor."""
    from ..io.stream import read_array
    from ..updaters import AddOption

    buf = io.BytesIO(data)
    (kind, n_arrays, table_id, wid, lr, mom, rho, lam, ts, trace_id,
     span_id, epoch, version) = _HEADER.unpack(buf.read(_HEADER.size))
    arrays = [read_array(buf) for _ in range(n_arrays)]
    option = AddOption(worker_id=wid, learning_rate=lr, momentum=mom,
                       rho=rho, lam=lam)
    ctx = trace.SpanContext(trace_id, span_id) if trace_id else None
    return kind, table_id, option, arrays, ts, ctx, epoch, version


def _kv_get_int(client, key: str, default: int = 0) -> int:
    """Best-effort int read from the coordination KV: ``key_value_try_get``
    where the client has it, else a short blocking get."""
    try:
        if hasattr(client, "key_value_try_get"):
            return int(str(client.key_value_try_get(key)))
        return int(str(client.blocking_key_value_get(key, 200)))
    except Exception:
        return default


def claim_epoch(client, key: str = "mvps/epoch") -> int:
    """Claim the next trainer incarnation epoch in the coordination KV.

    The monotonic fencing token of the restart contract: every publish of
    the claiming incarnation carries it, and appliers reject records of a
    lower epoch than the highest seen. A transport error on the read is
    fatal (defaulting to 0 would rewind the key and fence out the
    restarted trainer); only an absent key reads as 0."""
    if hasattr(client, "key_value_try_get"):
        try:
            cur = int(str(client.key_value_try_get(key)))
        except Exception as exc:
            if "NOT_FOUND" not in str(exc) \
                    and not isinstance(exc, KeyError):
                Log.fatal(f"claim_epoch: cannot read fence key {key!r} "
                          f"({exc}) — claiming blindly could regress "
                          f"the epoch and fence out this trainer")
            cur = 0
    else:
        # a client without try-get: a short blocking get whose timeout
        # means "absent" (the first claim)
        try:
            cur = int(str(client.blocking_key_value_get(key, 2_000)))
        except Exception as exc:
            msg = str(exc)
            if (isinstance(exc, TimeoutError) or "DEADLINE" in msg
                    or "NOT_FOUND" in msg):
                cur = 0
            else:
                Log.fatal(f"claim_epoch: cannot read fence key {key!r} "
                          f"({exc}) — claiming blindly could regress "
                          f"the epoch and fence out this trainer")
    nxt = cur + 1
    client.key_value_set(key, str(nxt), allow_overwrite=True)
    return nxt


class EpochFence:
    """Highest-epoch-wins admission check for fenced publishes.

    ``admit(epoch)`` returns False for a record of a lower incarnation
    than the highest seen (and counts it); epoch 0 (unfenced) always
    passes and never advances the fence. Callers are single applier
    threads."""

    def __init__(self, name: str = "fence") -> None:
        from ..dashboard import Dashboard

        self.epoch = 0
        self.rejections = 0
        self._counter = Dashboard.get_or_create_counter(
            f"EPOCH_FENCE_REJECTIONS[{name}]")

    def admit(self, epoch: int) -> bool:
        if not epoch:
            return True
        if epoch < self.epoch:
            self.rejections += 1
            self._counter.inc()
            return False
        self.epoch = epoch
        return True
