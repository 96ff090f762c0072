"""The port's row gather and row scatter-add against the JAX package's, on
the CPU.

On CPU tensors ``embedding_lookup`` and ``scatter_add_rows`` run their plain
versions, which the card's kernels are held to by ``chip_smoke.py``: the
gather bitwise, the scatter-add bitwise on data whose every running sum is
exact and within the duplicate-order bound on data at the path's scale.
Here the plain versions are held against ``jnp.take`` / ``.at[].add`` and
against the TPU kernels themselves, K1 (``pallas_gather``) and K2
(``pallas_rmw``) of ``tools/w2v_kernel_probe.py`` in Pallas interpret mode,
at shrunken shapes (``CHUNK``/``DEPTH`` monkeypatched as
``tests/test_kernel_probe.py`` does), plus K1b's 8-row shape. Tolerances:
gathers are bitwise (NaN rows included). Scatter-adds against
``.at[].add`` are bitwise, duplicates included: XLA's scatter on the CPU
rounds after every add, a row's adds in index order, and so does the
plain version (the card's kernel rounds after every add too, in an order
that is not fixed). Against the Pallas RMW, f32 1e-4 absolute (it sums in
another order).
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


@pytest.mark.parametrize("shape,view", [((7, 12), False),
                                        ((5, 3, 4), False),
                                        ((12, 1), True)],
                         ids=["rows", "rows-of-3x4", "one-row-view"])
def test_row_width_is_what_the_kernels_are_given(shape, view):
    """The row width both CUDA wrappers pass their kernel is the row's
    element count, also for a contiguous ``[1, D]`` view whose size-1 dim
    has stride 1 (a ``[D, 1]`` tensor transposed), where ``stride(0)``
    would give 1; the plain gather of such a view is ``jnp.take``'s."""
    rng = np.random.default_rng(8)
    host = rng.standard_normal(shape).astype(np.float32)
    table = torch.from_numpy(host)
    if view:
        table, host = table.t(), host.T
    assert table.is_contiguous()
    assert temb._row_elems(table) == int(np.prod(host.shape[1:]))
    ids = np.array([0, -1, host.shape[0], 0], np.int32)
    np.testing.assert_array_equal(
        _host(temb.embedding_lookup(table, torch.from_numpy(ids))),
        _host(jemb.embedding_lookup(jnp.asarray(host), jnp.asarray(ids))))


def _assert_scatter_close(got, want, before, ids, name):
    """Bitwise: both sides round each add on its own, in index order."""
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _bits(x) -> np.ndarray:
    """The f32 bits of a table (a bf16 value widens exactly)."""
    return _host(x).view(np.int32)


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


@pytest.mark.parametrize("hits,delta,want", [(2, 0.004, 1.015625),
                                             (8, 0.004, 1.0625),
                                             (1000, 1e-3, 1.0)])
def test_scatter_add_rounds_every_add_as_jax_does(hits, delta, want):
    """bf16 1.0 plus ``hits`` adds of bf16(delta) on one row: XLA rounds
    after every add, so 1,000 adds of 1e-3 (under half an ulp of 1.0) leave
    1.0, where one rounding of the f32 sum would give 2.0."""
    table = torch.ones((3, 4), dtype=torch.bfloat16)
    ids = np.ones(hits, np.int32)
    d = np.full((hits, 4), delta, np.float32)
    temb.scatter_add_rows(table, torch.from_numpy(ids), torch.from_numpy(d))
    jt = jnp.ones((3, 4), jnp.bfloat16).at[jnp.asarray(ids)].add(
        jnp.asarray(d).astype(jnp.bfloat16))
    np.testing.assert_array_equal(_bits(table), _bits(jt))
    assert _host(table)[1, 0] == want
    assert (_host(table)[[0, 2]] == 1.0).all()


@pytest.mark.parametrize("name", DTYPES)
def test_gather_to_float32_matches_take_astype(name):
    """``out_dtype=torch.float32``: ``jnp.take(...).astype(f32)`` bit for
    bit, NaN rows of wrapped-out ids included."""
    rng = np.random.default_rng(6)
    V, D = 50, 16
    tt, jt = _table(rng, V, D, name)
    ids = _ids(rng, V, 200).reshape(20, 10)
    got = temb.embedding_lookup(tt, torch.from_numpy(ids),
                                out_dtype=torch.float32)
    want = jnp.take(jt, jnp.asarray(ids), axis=0).astype(jnp.float32)
    assert got.dtype == torch.float32 and got.shape == (20, 10, D)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    assert np.isnan(got.numpy()[0, 2:5]).all()


def _scaled_at_add(jt, ids, grads, lr, scale):
    """The JAX step's update (``multiverso_tpu/models/word2vec.py``
    ``apply_sgd``, ``update_impl="scatter"``) on the same inputs."""
    g = jnp.asarray(grads)
    upd = -lr * g if scale is None else \
        (-lr) * jnp.take(jnp.asarray(scale), jnp.asarray(ids), axis=0)[
            :, None] * g
    return jt.at[jnp.asarray(ids)].add(upd.astype(jt.dtype))


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("delta_dtype", ["float32", "table"])
@pytest.mark.parametrize("scaled", [False, True], ids=["alpha",
                                                       "alpha+row_scale"])
def test_scatter_add_with_alpha_and_row_scale_matches_jax(name, delta_dtype,
                                                          scaled):
    """``alpha = -lr`` and a ``[V]`` f32 scale table against the JAX step's
    ``w.at[rows].add(((-lr) * scale[rows][:, None] * grads)
    .astype(w.dtype))``, bit for bit: zipf duplicates, negative ids that
    wrap (and read the scale of the row they wrap to) and out-of-range ids
    that are dropped (and read no scale)."""
    rng = np.random.default_rng(7)
    V, D, n = 40, 10, 300
    tt, jt = _table(rng, V, D, name)
    ids = _ids(rng, V, n)
    grads = (rng.standard_normal((n, D)) * 0.1).astype(np.float32)
    td = torch.from_numpy(grads)
    if delta_dtype == "table":
        td = td.to(tt.dtype)
    scale = (rng.random(V) + 0.05).astype(np.float32) if scaled else None
    lr = float(np.float32(0.025))
    temb.scatter_add_rows(tt, torch.from_numpy(ids), td, alpha=-lr,
                          row_scale=None if scale is None
                          else torch.from_numpy(scale))
    want = _scaled_at_add(jt, ids, _host(td), np.float32(lr), scale)
    np.testing.assert_array_equal(_bits(tt), _bits(want))
    # the scaling was applied: the unscaled update is another table
    plain = _table(np.random.default_rng(7), V, D, name)[0]
    temb.scatter_add_rows(plain, torch.from_numpy(ids), td)
    assert not np.array_equal(_bits(plain), _bits(tt))
