"""The port's sparse, FTRL and kv tables, table store/load and the local
streams, against the JAX package's on the CPU.

Same inputs (numpy, from a seed) through ``multiverso_tpu.tables`` and
their ports. Sizes are multiples of the JAX test mesh's 8 servers, so the
JAX tables have no pad rows: with pads, a JAX key of -1 or one past the
logical size addresses a pad row, a sharding artefact the port (one
device, no pads) does not have. Tolerances: the stateless updaters and
FTRL's accumulation are held bitwise (repeated keys included: both
scatters add in index order on the CPU); the stateful updaters within
1e-6 absolute, the bound ``tests/test_torch_tables.py`` holds their
dense applies to. Store/load records are byte-equal across packages.
"""

import io

import numpy as np
import pytest
import torch

from multiverso_tpu_torch.log import FatalError

ATOL = 1e-6
SIZE = 40          # a multiple of the JAX mesh's 8 servers: no pad rows
# keys with repeats, a negative key (wraps), size and size + 5 (a Get
# clamps them to the last key, an Add drops them)
KEYS = np.array([3, 7, 7, 0, -1, SIZE, SIZE + 5, 39, 12, 3], np.int32)


@pytest.fixture()
def port():
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.dashboard import Dashboard
    from multiverso_tpu_torch.runtime import Session

    Session._instance = None
    Dashboard.reset()
    mv.set_flag("updater_type", "default")
    mv.init(["test", "-device=cpu"])
    yield mv
    mv.shutdown()
    Session._instance = None
    mv.set_flag("device", "cuda")


def _opt(mod, i):
    return mod.updaters.AddOption(worker_id=0, learning_rate=0.1 + 0.05 * i,
                                  momentum=0.9, rho=0.2)


@pytest.mark.parametrize("updater", ["default", "sgd", "momentum_sgd",
                                     "adagrad"])
def test_sparse_table_matches_jax(mv_session, port, updater):
    import multiverso_tpu as jmv
    import multiverso_tpu_torch as tmv

    rng = np.random.default_rng(0)
    init = rng.standard_normal(SIZE).astype(np.float32)
    j = mv_session.create_table("sparse", SIZE, updater=updater,
                                init_value=init, name="s")
    t = port.create_table("sparse", SIZE, updater=updater, init_value=init,
                          name="s", device="cpu")
    assert (t.shape, t.name, t.updater.name) == ((SIZE,), "s", updater)
    np.testing.assert_array_equal(t.get_keys(KEYS), j.get_keys(KEYS))
    for i in range(4):
        vals = rng.standard_normal(KEYS.shape[0]).astype(np.float32)
        j.add_keys(KEYS, vals, _opt(jmv, i))
        if i % 2:
            t.add_keys(KEYS, vals, _opt(tmv, i))
        else:
            t.add_keys_async(KEYS, vals, _opt(tmv, i)).wait()
        got, want = t.get_keys(KEYS), np.asarray(j.get_keys(KEYS))
        if t.updater.stateless:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(t.get(), j.get())
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
            np.testing.assert_allclose(t.get(), j.get(), rtol=0, atol=ATOL)
    assert t.version == j.version == 4


@pytest.mark.parametrize("updater", ["default", "sgd"])
def test_bf16_sparse_table_matches_jax(mv_session, port, updater):
    """A bf16 [size] vector (2-byte rows): every Get and stateless Add
    bitwise equal to the JAX table's, repeated and out-of-range keys
    included."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    init = rng.standard_normal(SIZE).astype(np.float32)
    j = mv_session.create_table("sparse", SIZE, dtype=jnp.bfloat16,
                                updater=updater, init_value=init)
    t = port.create_table("sparse", SIZE, dtype=torch.bfloat16,
                          updater=updater, init_value=init, device="cpu")
    for _ in range(3):
        vals = rng.standard_normal(KEYS.shape[0]).astype(np.float32)
        j.add_keys(KEYS, vals)
        t.add_keys(KEYS, vals)
        np.testing.assert_array_equal(
            t.get_keys(KEYS), np.asarray(j.get_keys(KEYS), np.float32))
    np.testing.assert_array_equal(t.get(), np.asarray(j.get(), np.float32))
    assert not np.array_equal(t.get(), np.asarray(init, np.float32))


def test_sparse_table_out_of_range_keys_follow_jax(mv_session, port):
    """A Get of -1 reads the last key and of size / size + 5 the last key
    (clamped); an Add wraps -1 and drops size / size + 5. The kernels
    give NaN for, and drop, an id out of range: the table clamps first."""
    j = mv_session.create_table("sparse", SIZE)
    t = port.create_table("sparse", SIZE)
    odd = np.array([-1, SIZE, SIZE + 5, -SIZE, -SIZE - 3], np.int32)
    vals = np.array([1.0, 2.0, 4.0, 8.0, 16.0], np.float32)
    j.add_keys(odd, vals)
    t.add_keys(odd, vals)
    np.testing.assert_array_equal(t.get(), j.get())
    assert t.get()[SIZE - 1] == 1.0 and t.get()[0] == 8.0
    np.testing.assert_array_equal(t.get_keys(odd), j.get_keys(odd))
    np.testing.assert_array_equal(t.get_keys(odd), [1.0, 1.0, 1.0, 8.0, 8.0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ftrl_table_matches_jax(mv_session, port, dtype):
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    j = mv_session.create_table("ftrl", SIZE, dtype=jdt, name="f")
    t = port.create_table("ftrl", SIZE, dtype=dtype, name="f")
    assert t.updater.name == "default" and t.shape == (SIZE, 2)
    for _ in range(3):
        dz = rng.standard_normal(KEYS.shape[0])
        dn = rng.random(KEYS.shape[0])
        j.add_keys(KEYS, dz, dn)
        t.add_keys(KEYS, dz, dn)
        for got, want in zip(t.get_keys(KEYS), j.get_keys(KEYS)):
            np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    np.testing.assert_array_equal(t.get(), np.asarray(j.get(), np.float32))
    assert t.version == j.version == 3


def test_ftrl_remote_keyed_apply(port):
    """The parameter plane's keyed apply on an FTRL table: [n, 2] rows."""
    from multiverso_tpu_torch.updaters import AddOption

    t = port.create_table("ftrl", 8)
    t._apply_remote_keyed(np.array([1, 1, 6], np.int32),
                          np.array([[1, 2], [3, 4], [5, 6]], np.float32),
                          AddOption())
    z, n = t.get_keys([1, 6])
    np.testing.assert_array_equal(z, [4, 5])
    np.testing.assert_array_equal(n, [6, 6])


def test_kv_table_matches_jax(mv_session, port):
    j = mv_session.create_table("kv", name="counts")
    t = port.create_table("kv", name="counts")
    assert t.name == "counts" and t.table_id == 0
    for keys, vals in (([0, 5, 5], [1.5, 2, 3]), ([np.int64(-7), 5], [1, 1]),
                       ([2**40], [0.25])):
        j.add(keys, vals)
        t.add(keys, vals)
    probe = [5, 0, 9, -7, 2**40]
    assert t.get(probe) == j.get(probe)
    assert t.raw() == j.raw() and len(t) == len(j) == 4
    assert t.version == j.version == 3
    (tk, tv), tver = t._state_arrays()
    (jk, jv), jver = j._state_arrays()
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tv, jv)
    assert tver == jver and tk.dtype == np.int64 and tv.dtype == np.float64
    # a peer's adds and a rebase, as the parameter plane applies them
    t._apply_remote_kv(np.array([0, 3], np.int64), np.array([1.0, 2.0]))
    j._apply_remote_kv(np.array([0, 3], np.int64), np.array([1.0, 2.0]))
    assert t.get([0, 3]) == j.get([0, 3]) and t.version == 4
    t._install_state_arrays([np.array([1, 2]), np.array([0.5, 0.75])], 17,
                            epoch=2)
    assert (t.get([1, 2, 3]), t.version, t.epoch) == ([0.5, 0.75, 0], 17, 2)
    t.sync()   # one process: nothing to merge
    t.flush()


def test_kv_sync_across_processes_raises(port, monkeypatch):
    from multiverso_tpu_torch.runtime import Session

    t = port.create_table("kv")
    monkeypatch.setattr(Session, "size", 2, raising=False)
    with pytest.raises(FatalError, match="item 8"):
        t.sync()


@pytest.mark.parametrize("kind", ["array", "matrix", "sparse", "ftrl", "kv"])
def test_store_load_across_packages(mv_session, port, kind):
    """A record stored by either package loads into the other, byte for
    byte the same record, and each load bumps the version."""
    rng = np.random.default_rng(2)
    args = {"array": (SIZE,), "matrix": (8, 5), "sparse": (SIZE,),
            "ftrl": (SIZE,), "kv": ()}[kind]
    j = mv_session.create_table(kind, *args)
    t = port.create_table(kind, *args)
    if kind == "kv":
        for tab in (j, t):
            tab.add([4, 1, 9], [0.5, 1.5, -2.0])
    elif kind == "ftrl":
        dz, dn = rng.standard_normal(5), rng.random(5)
        for tab in (j, t):
            tab.add_keys([1, 4, 4, 9, 30], dz, dn)
    else:
        delta = rng.standard_normal(t.shape).astype(np.float32)
        for tab in (j, t):
            tab.add(delta)
    jb, tb = io.BytesIO(), io.BytesIO()
    jver, tver = j.store(jb), t.store(tb)
    assert jver == tver == 1
    assert tb.getvalue() == jb.getvalue()
    # JAX's record into a fresh port table, the port's into a fresh JAX one
    t2 = port.create_table(kind, *args)
    j2 = mv_session.create_table(kind, *args)
    t2.load(io.BytesIO(jb.getvalue()))
    j2.load(io.BytesIO(tb.getvalue()))
    if kind == "kv":
        assert t2.get([1, 4, 9]) == j2.get([1, 4, 9]) == [1.5, 0.5, -2.0]
    else:
        np.testing.assert_array_equal(t2.get(), t.get())
        np.testing.assert_array_equal(np.asarray(j2.get()), t.get())
        assert t2.version == 1


def test_table_load_rejects_another_shape(port):
    t = port.create_table("sparse", 8)
    buf = io.BytesIO()
    port.create_table("sparse", 9).store(buf)
    buf.seek(0)
    with pytest.raises(FatalError, match="shape"):
        t.load(buf)


def test_bf16_matrix_store_matches_jax(mv_session, port):
    import jax.numpy as jnp

    j = mv_session.create_table("matrix", 8, 4, init_value="random", seed=5,
                                dtype=jnp.bfloat16)
    t = port.create_table("matrix", 8, 4, init_value="random", seed=5,
                          dtype=torch.bfloat16)
    jb, tb = io.BytesIO(), io.BytesIO()
    j.store(jb)
    t.store(tb)
    assert tb.getvalue() == jb.getvalue()
    t2 = port.create_table("matrix", 8, 4, dtype=torch.bfloat16)
    t2.load(io.BytesIO(jb.getvalue()))
    assert torch.equal(t2.array, t.array)


def test_streams_and_text_reader_match_jax(tmp_path):
    from multiverso_tpu.io import stream as jstream
    from multiverso_tpu_torch.io import stream as tstream

    path = tmp_path / "sub" / "dir" / "lines.txt"
    with tstream.open_stream(f"file://{path}", "w") as f:   # makes dirs
        f.write(b"alpha\r\nbeta \xff\n\ngamma")
    for uri in (str(path), f"file://{path}"):
        u, v = tstream.URI(uri), jstream.URI(uri)
        assert (u.scheme, u.host, u.path) == (v.scheme, v.host, v.path)
        with tstream.TextReader(uri, buf_size=4) as r, \
                jstream.TextReader(uri, buf_size=4) as q:
            assert list(r) == list(q) == ["alpha", "beta �", "",
                                          "gamma"]
    with tstream.open_stream(str(path)) as f:
        assert f.read(5) == b"alpha"
    u = tstream.URI("hdfs://nn:9000/a/b")
    assert (u.scheme, u.host, u.path) == ("hdfs", "nn:9000", "/a/b")
    for uri in ("gs://bucket/x", "hdfs://nn/x"):
        with pytest.raises(FatalError, match="item 7b"):
            tstream.open_stream(uri)
    # memory:// opens: the in-process object store, one object a write
    with tstream.open_stream("memory://x/lines.txt", "wb") as f:
        f.write(path.read_bytes())
    with tstream.TextReader("memory://x/lines.txt", buf_size=4) as r:
        assert list(r) == ["alpha", "beta �", "", "gamma"]
