"""KV-block transfer plane for disaggregated prefill/decode serving.

Counterpart of ``multiverso_tpu/serving/kv_transfer.py``, with the same
payload schema and the same base64 records byte for byte. numpy has no
bfloat16, so a bf16 block packs from its raw 16-bit words and its header
dtype names ``bfloat16``, as the JAX payload's does; blocks are torch
tensors (or numpy arrays) going in and CPU torch tensors coming out.

A disaggregated fleet splits the two phases of generation onto
specialized replicas (DistServe / Splitwise): throughput-bound PREFILL
replicas chunk-prefill prompts into paged KV blocks, latency-bound
DECODE replicas run the per-token steps. What crosses between them is
not tokens but *cache state*: the finished KV blocks of the prompt,
shipped over the existing ``mvserve`` wire and spliced into the decode
replica's block pool so admission lands on the prefix cache's full-hit path
(lookup -> CoW on the last block -> live at position P-1) and emits
tokens bit-identical to unified serving.

This module is the wire format and the byte accounting — deliberately
small and engine-free, so both ends (and the router, which carries the
payload between stages) agree on one schema:

* **one payload per prefilled prompt** (:func:`new_payload`): header
  (``prompt_len``, ``block_size``, ``snapshot_version``, the per-block
  ``shape``/``dtype``) + the prompt's full-block **chain hashes in
  chain order** + a sparse ``blocks`` map of the hashes whose K/V bytes
  actually ride the wire. Only FULL blocks transfer — a trailing
  partial block has no chain identity (block_pool.chain_hashes) and the
  decode side re-prefills the tail locally, which is also what makes a
  lost transfer a performance event rather than a correctness event.
* **dedup at the source** (:func:`add_block` with ``k=None``): a hash
  the decode side already advertised (router-tracked shipped set +
  heartbeat ``cached_chains``) rides as metadata only — the hash holds
  its place in the chain so arrival-side splicing can still claim the
  warm prefix, but zero K/V bytes move. ``dedup_blocks`` counts them.
* **dedup on arrival**: the decode engine checks its pool's content
  index per hash before splicing; a block that landed since the
  advertisement is skipped there too. Both ends count into the same
  ``KV_XFER_DEDUP`` ledger.

Transfer-unit math: one block costs
``2 * n_layers * block_size * d_model * itemsize`` bytes across both
pools (:func:`block_nbytes` — the same arithmetic as
``block_pool.kv_bytes_per_block``, restated over the payload's shape
tuple so the wire accounting cannot drift from the device accounting).
Bytes are base64 in the JSON record (the ``mvserve`` wire is one JSON
object per transport record); ``payload_bytes`` reports the RAW K/V
bytes moved, which is what ``kv_bytes_moved`` gates on — encoding
overhead is a wire detail, not a capacity number.

Versioning: ``snapshot_version`` scopes the chain hashes (cached K/V
bytes are a function of (token prefix, params version) — the engine
seeds its hash chain with the pinned snapshot version). A payload whose
version disagrees with the receiver's pinned snapshot is dropped whole
at splice time: splicing stale-params KV would poison the receiver's
content index. Correctness survives because stage-2 dispatch always
carries the full prompt — the decode side re-prefills whatever the
splice did not provide (docs/SERVING.md "Disaggregated prefill/decode").
"""

from __future__ import annotations

import base64
from typing import Any, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

#: payload schema version; a receiver rejects (skips) other versions
WIRE_VERSION = 1

# header dtype name -> (torch dtype, bytes per element)
_DTYPES = {"float32": (torch.float32, 4), "bfloat16": (torch.bfloat16, 2),
           "float16": (torch.float16, 2), "int8": (torch.int8, 1)}


def dtype_name(dtype) -> str:
    """The header name of a torch dtype, numpy dtype or name string
    (``bfloat16`` for torch's bf16, as numpy-with-ml_dtypes names it)."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).rpartition(".")[2]
    elif isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name
    if name not in _DTYPES:
        raise ValueError(f"kv_transfer: unsupported block dtype {name!r}")
    return name


def _raw(x) -> bytes:
    """C-order bytes of a block (a bf16 tensor as its 16-bit words)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, np.float32)


def block_nbytes(shape: Sequence[int], dtype) -> int:
    """Raw bytes ONE block moves across both pools (K and V) given the
    payload's per-block ``shape`` — ``(n_layers, block_size, d_model)``
    as the engine fetches it. An int8 (quantized-source) payload also
    carries each pool's per-layer fp32 scales, counted here for the
    same reason ``block_pool.kv_bytes_per_block`` counts them: the wire
    accounting must not flatter quantization by forgetting its scales."""
    n = 1
    for d in shape:
        n *= int(d)
    name = dtype_name(dtype)
    raw = 2 * n * _DTYPES[name][1]
    if name == "int8":
        raw += 2 * int(shape[0]) * 4          # [L] fp32 scales per pool
    return raw


def pack_block(k: np.ndarray, v: np.ndarray,
               k_scale: Optional[np.ndarray] = None,
               v_scale: Optional[np.ndarray] = None) -> Dict[str, str]:
    """One block's K/V slices as a JSON-safe record: base64 of the raw
    C-order bytes. Shape/dtype ride ONCE in the payload header — every
    block of a payload shares them by construction. A quantized source
    pool additionally ships each pool's per-layer fp32 scale column
    (``k_scale``/``v_scale`` [n_layers]) under ``ks``/``vs`` — the K/V
    bytes themselves stay int8, which is where the ~4x
    ``kv_bytes_moved`` drop comes from."""
    rec = {
        "k": base64.b64encode(_raw(k)).decode("ascii"),
        "v": base64.b64encode(_raw(v)).decode("ascii"),
    }
    if k_scale is not None:
        rec["ks"] = base64.b64encode(_f32(k_scale).tobytes()).decode("ascii")
        rec["vs"] = base64.b64encode(_f32(v_scale).tobytes()).decode("ascii")
    return rec


def unpack_block(rec: Dict[str, str], shape: Sequence[int], dtype):
    """Inverse of :func:`pack_block` -> ``(k, v)`` CPU tensors of the
    header dtype, shaped per the payload header. Raises ``ValueError``
    when the byte count does not factor into the declared shape (a
    truncated/corrupt record must fail loudly, not splice garbage)."""
    shape = tuple(int(d) for d in shape)
    tdtype, item = _DTYPES[dtype_name(dtype)]
    want = 1
    for d in shape:
        want *= d
    out = []
    for key in ("k", "v"):
        raw = base64.b64decode(rec[key])
        if len(raw) != want * item:
            raise ValueError(
                f"kv_transfer: block record has {len(raw)} bytes for "
                f"{key}, shape {shape} wants {want * item}")
        out.append(torch.frombuffer(bytearray(raw), dtype=tdtype)
                   .reshape(shape))
    return out[0], out[1]


def new_payload(prompt_len: int, block_size: int, snapshot_version: int,
                shape: Sequence[int], dtype) -> Dict[str, Any]:
    """Empty transfer payload (header only); fill with :func:`add_block`
    in chain order."""
    return {
        "v": WIRE_VERSION,
        "prompt_len": int(prompt_len),
        "block_size": int(block_size),
        "snapshot_version": int(snapshot_version),
        "shape": [int(d) for d in shape],
        "dtype": dtype_name(dtype),
        "hashes": [],           # every full block's chain hash, in order
        "blocks": {},           # hex hash -> pack_block record (shipped)
        "dedup_blocks": 0,      # source-side skips (receiver had them)
        "dropped": False,       # chaos kv_xfer_drop stripped the bytes
    }


def add_block(payload: Dict[str, Any], hex_hash: str,
              k: Optional[np.ndarray] = None,
              v: Optional[np.ndarray] = None,
              k_scale: Optional[np.ndarray] = None,
              v_scale: Optional[np.ndarray] = None) -> None:
    """Append one full block to the chain. ``k``/``v`` given = ship the
    bytes; ``k=None`` = source-side dedup (the receiver advertised this
    chain prefix) — the hash still holds its chain position so
    arrival-side splicing can claim the warm prefix past it. A
    quantized source passes its per-layer scale columns too
    (:func:`pack_block`)."""
    payload["hashes"].append(hex_hash)
    if k is None:
        payload["dedup_blocks"] += 1
    else:
        payload["blocks"][hex_hash] = pack_block(k, v, k_scale, v_scale)


def unpack_scales(rec: Dict[str, str], n_layers: int):
    """The quantized record's per-layer fp32 scale columns ->
    ``(k_scale, v_scale)`` each ``[n_layers]``, or ``None`` when the
    record shipped unquantized. Size-checked for the same reason
    :func:`unpack_block` is: a truncated scale blob must fail loudly."""
    if "ks" not in rec:
        return None
    ks = np.frombuffer(base64.b64decode(rec["ks"]), dtype=np.float32)
    vs = np.frombuffer(base64.b64decode(rec["vs"]), dtype=np.float32)
    if ks.size != int(n_layers) or vs.size != int(n_layers):
        raise ValueError(
            f"kv_transfer: scale record has {ks.size}/{vs.size} entries, "
            f"expected {int(n_layers)}")
    return ks, vs


def payload_bytes(payload: Dict[str, Any]) -> int:
    """RAW K/V bytes this payload moves (shipped blocks only — dedup'd
    hashes are metadata). The ``kv_bytes_moved`` unit of account."""
    return len(payload.get("blocks") or {}) * block_nbytes(
        payload["shape"], payload["dtype"])


def shipped_hashes(payload: Dict[str, Any]) -> Set[str]:
    """Hex hashes whose bytes ride this payload (the router folds these
    into its per-decode-replica shipped set for future source dedup)."""
    return set(payload.get("blocks") or {})


def drop_blocks(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Chaos ``kv_xfer_drop``: strip every shipped block mid-flight,
    keeping the header + hashes (the metadata that makes the loss
    OBSERVABLE). The receiver splices nothing new and re-prefills — a
    dropped transfer must cost latency, never correctness."""
    payload = dict(payload)
    payload["blocks"] = {}
    payload["dropped"] = True
    return payload


def validate(payload: Dict[str, Any]) -> Optional[str]:
    """Schema check -> reason string, or None when the payload is
    well-formed. The splice path skips (never raises on) a bad payload:
    the full prompt is in the stage-2 request, so degrading to a local
    re-prefill is always available."""
    if not isinstance(payload, dict):
        return "payload is not a dict"
    if payload.get("v") != WIRE_VERSION:
        return f"wire version {payload.get('v')!r} != {WIRE_VERSION}"
    for key in ("prompt_len", "block_size", "snapshot_version",
                "shape", "dtype", "hashes"):
        if key not in payload:
            return f"missing {key!r}"
    if len(payload["shape"]) != 3:
        return f"shape {payload['shape']!r} is not (L, block, D)"
    blocks = payload.get("blocks") or {}
    stray = set(blocks) - set(payload["hashes"])
    if stray:
        return f"{len(stray)} shipped block(s) not in the hash chain"
    return None
