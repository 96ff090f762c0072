"""The port's row gather and row scatter-add against the JAX package's, on
the CPU.

On CPU tensors ``embedding_lookup`` and ``scatter_add_rows`` run their plain
versions, which the card's kernels are held to by ``chip_smoke.py``: the
gather bitwise, the scatter-add bitwise on data whose every running sum is
exact and within the duplicate-order bound on data at the path's scale.
Here the plain
versions are held against ``jnp.take`` / ``.at[].add`` and against the
TPU kernels themselves, K1 (``pallas_gather``) and K2 (``pallas_rmw``) of
``tools/w2v_kernel_probe.py`` in Pallas interpret mode, at shrunken shapes
(``CHUNK``/``DEPTH`` monkeypatched as ``tests/test_kernel_probe.py`` does),
plus K1b's 8-row shape. Tolerances: gathers are bitwise (NaN rows
included). Scatter-adds: f32 1e-6 absolute (a different order of the
duplicate sums); bf16 rows within (hits + 1) bf16 ulps of the row's
magnitude, because XLA on the CPU accumulates a bf16 scatter in f32 and
rounds once while the port rounds after every add, as the card's bf16
atomics do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.w2v_kernel_probe as kp
from multiverso_tpu.ops import embedding as jemb
from multiverso_tpu_torch.ops import embedding as temb

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture()
def small_shapes(monkeypatch):
    monkeypatch.setattr(kp, "CHUNK", 32)
    monkeypatch.setattr(kp, "DEPTH", 4)
    return 96, 128          # vocab rows (multiple of TILE), n indices


def _table(rng, V, D, name):
    host = rng.standard_normal((V, D)).astype(np.float32)
    tdt, jdt = DTYPES[name]
    # a private copy each: jnp.asarray may alias the numpy buffer, and the
    # port's scatter-add writes its table in place
    return torch.from_numpy(host.copy()).to(tdt), jnp.asarray(host, jdt)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _ids(rng, V, n):
    """Zipf-hot duplicates, negative ids that wrap, ids out of range both
    ways."""
    p = 1.0 / np.arange(1, V + 1)
    ids = rng.choice(V, size=n, p=p / p.sum()).astype(np.int32)
    ids[:5] = [-1, -V, V, V + 7, -V - 3]
    return ids


@pytest.mark.parametrize("name", DTYPES)
def test_gather_matches_take(name):
    rng = np.random.default_rng(0)
    V, D = 50, 12
    tt, jt = _table(rng, V, D, name)
    ids = _ids(rng, V, 200)
    got = temb.embedding_lookup(tt, torch.from_numpy(ids))
    want = jemb.embedding_lookup(jt, jnp.asarray(ids))
    assert got.dtype == tt.dtype and got.shape == (200, D)
    np.testing.assert_array_equal(_host(got), _host(want))   # NaN rows too
    assert np.isnan(_host(got)[2:5]).all()


def test_gather_keeps_the_ids_shape():
    rng = np.random.default_rng(1)
    tt, jt = _table(rng, 30, 8, "float32")
    ids = rng.integers(0, 30, (6, 4)).astype(np.int32)
    got = temb.embedding_lookup(tt, torch.from_numpy(ids))
    assert got.shape == (6, 4, 8)
    np.testing.assert_array_equal(
        _host(got), _host(jnp.take(jt, jnp.asarray(ids), axis=0)))


def test_gather_matches_pallas_k1(small_shapes):
    vocab, n = small_shapes
    rng = np.random.default_rng(0)
    tt, jt = _table(rng, vocab, kp.DIM, "float32")
    ids = np.concatenate([rng.integers(0, vocab, n - 8),
                          np.full(8, 3)]).astype(np.int32)
    want = kp.pallas_gather(jt, jnp.asarray(ids), interpret=True)
    got = temb.embedding_lookup(tt, torch.from_numpy(ids))
    np.testing.assert_array_equal(_host(got), _host(want))


def test_gather_at_k1b_shape(monkeypatch):
    """K1b (``subtile_rejected``): 8 one-row gathers from a [64, 256] f32
    table; the JAX side is K1 run at that shape (one chunk of 8)."""
    monkeypatch.setattr(kp, "CHUNK", 8)
    monkeypatch.setattr(kp, "DEPTH", 4)
    rng = np.random.default_rng(2)
    tt, jt = _table(rng, 64, kp.DIM, "float32")
    ids = rng.integers(0, 64, 8).astype(np.int32)
    got = temb.embedding_lookup(tt, torch.from_numpy(ids))
    np.testing.assert_array_equal(
        _host(got), _host(kp.pallas_gather(jt, jnp.asarray(ids),
                                           interpret=True)))
    np.testing.assert_array_equal(
        _host(got), _host(jnp.take(jt, jnp.asarray(ids), axis=0)))


def _assert_scatter_close(got, want, before, ids, name):
    got, want, before = _host(got), _host(want), _host(before)
    if name == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        return
    V = before.shape[0]
    w = np.where(ids < 0, ids + V, ids)
    hits = np.bincount(w[(w >= 0) & (w < V)], minlength=V)
    mag = np.max(np.maximum(np.maximum(np.abs(before), np.abs(want)),
                            np.abs(got)), axis=1, keepdims=True)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    excess = np.abs(got - want) / ((hits[:, None] + 1) * ulp)
    assert excess.max() <= 1.0, excess.max()


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("delta_dtype", ["float32", "table"])
def test_scatter_add_matches_at_add(name, delta_dtype):
    rng = np.random.default_rng(3)
    V, D, n = 40, 10, 300
    tt, jt = _table(rng, V, D, name)
    ids = _ids(rng, V, n)
    deltas = (rng.standard_normal((n, D)) * 0.1).astype(np.float32)
    td = torch.from_numpy(deltas)
    if delta_dtype == "table":
        td = td.to(tt.dtype)
    before = tt.clone()
    out = temb.scatter_add_rows(tt, torch.from_numpy(ids), td)
    assert out is tt                                  # updated in place
    want = jemb.scatter_add_rows(jt, jnp.asarray(ids),
                                 jnp.asarray(_host(td)))
    _assert_scatter_close(tt, want, before, ids, name)


@pytest.mark.parametrize("name", DTYPES)
def test_scatter_add_without_duplicates_is_exact(name):
    """Each row hit once: one rounding on both sides, so bitwise equal
    (the bf16 delta is rounded to the table dtype first, as JAX's
    ``upd.astype(w.dtype)`` does)."""
    rng = np.random.default_rng(4)
    V, D = 64, 6
    tt, jt = _table(rng, V, D, name)
    ids = rng.permutation(V)[:40].astype(np.int32)
    deltas = (rng.standard_normal((40, D)) * 0.3).astype(np.float32)
    temb.scatter_add_rows(tt, torch.from_numpy(ids), torch.from_numpy(deltas))
    want = jt.at[jnp.asarray(ids)].add(jnp.asarray(deltas).astype(jt.dtype))
    np.testing.assert_array_equal(_host(tt), _host(want))


def test_scatter_add_matches_pallas_k2(small_shapes):
    vocab, n = small_shapes
    rng = np.random.default_rng(1)
    tt, jt = _table(rng, vocab, kp.DIM, "float32")
    # every update lands in a handful of rows: the serial RMW's workload
    ids = rng.integers(0, 16, n).astype(np.int32)
    grads = rng.standard_normal((n, kp.DIM)).astype(np.float32)
    want = kp.pallas_rmw(jt, jnp.asarray(ids), jnp.asarray(grads),
                         interpret=True)
    temb.scatter_add_rows(tt, torch.from_numpy(ids), torch.from_numpy(grads))
    np.testing.assert_allclose(_host(tt), _host(want), rtol=0, atol=1e-4)


def test_segment_mean_rows_matches_jax():
    rng = np.random.default_rng(5)
    vals = rng.standard_normal((20, 4)).astype(np.float32)
    seg = rng.integers(0, 6, 20).astype(np.int32)
    seg[seg == 5] = 4                                 # an empty segment
    got = temb.segment_mean_rows(torch.from_numpy(vals),
                                 torch.from_numpy(seg), 6)
    want = jemb.segment_mean_rows(jnp.asarray(vals), jnp.asarray(seg), 6)
    np.testing.assert_allclose(_host(got), _host(want), rtol=1e-6,
                               atol=1e-6)


def test_wrappers_count_no_launch_on_the_cpu_and_refuse_other_devices():
    temb.reset_launches()
    t = torch.zeros((4, 2))
    temb.embedding_lookup(t, torch.tensor([1], dtype=torch.int32))
    temb.scatter_add_rows(t, torch.tensor([1], dtype=torch.int32),
                          torch.ones((1, 2)))
    assert temb.LAUNCHES == {"row_gather": 0, "row_scatter_add": 0}
    meta = torch.zeros((4, 2), device="meta")
    ids = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        temb.embedding_lookup(meta, ids)
    with pytest.raises(ValueError, match="unsupported device"):
        temb.scatter_add_rows(meta, ids, torch.zeros((1, 2), device="meta"))
