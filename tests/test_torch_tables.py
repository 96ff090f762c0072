"""The port's updaters and tables against the JAX package's, on the CPU.

Same inputs (numpy, from a seed) through ``multiverso_tpu.updaters`` /
``tables`` and their ports. Tolerances: float32 results 1e-6 absolute
(they should be bitwise; the tolerance only absorbs a different duplicate
summation order); the random initial tables are held BITWISE in float32
and bfloat16; bfloat16 row adds without duplicates are bitwise too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu import updaters as jupd
from multiverso_tpu_torch import updaters as tupd
from multiverso_tpu_torch.log import FatalError

ATOL = 1e-6
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


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


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("name", ["default", "sgd", "momentum_sgd",
                                  "adagrad"])
def test_updaters_match_jax(name):
    rng = np.random.default_rng(0)
    shape, workers = (7, 5), 2
    data = rng.standard_normal(shape).astype(np.float32)
    ju = jupd.get_updater(name)
    tu = tupd.get_updater(name)
    assert (tu.name, tu.stateless, tu.sign) == (ju.name, ju.stateless,
                                                ju.sign)
    jd, js = jnp.asarray(data), ju.init_state(shape, jnp.float32, workers)
    td, ts = torch.from_numpy(data.copy()), tu.init_state(
        shape, torch.float32, workers)
    for i in range(4):
        delta = rng.standard_normal(shape).astype(np.float32)
        jopt = jupd.AddOption(worker_id=i % workers, learning_rate=0.1,
                              momentum=0.9, rho=0.2)
        topt = tupd.AddOption(worker_id=i % workers, learning_rate=0.1,
                              momentum=0.9, rho=0.2)
        jd, js = ju.apply(jd, js, jnp.asarray(delta), jopt)
        td, ts = tu.apply(td, ts, torch.from_numpy(delta), topt)
        np.testing.assert_allclose(td.numpy(), _f32(jd), rtol=0, atol=ATOL)
    if not ju.stateless:
        np.testing.assert_allclose(ts.numpy(), _f32(js), rtol=0, atol=ATOL)


def test_integer_tables_get_the_default_updater():
    assert type(tupd.get_updater("sgd", dtype=torch.int32)) is tupd.Updater
    with pytest.raises(FatalError):
        tupd.get_updater("no_such_updater")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", [0, 7])
def test_random_init_is_bit_identical(mv_session, port, dtype, seed):
    j = mv_session.create_table("matrix", 1000, 200, init_value="random",
                                seed=seed, dtype=JDT[dtype])
    t = port.create_table("matrix", 1000, 200, init_value="random",
                          seed=seed, dtype=dtype)
    assert t.array.dtype == dtype and t.array.shape == (1000, 200)
    np.testing.assert_array_equal(t.get().view(np.uint32),
                                  _f32(j.get()).view(np.uint32))


@pytest.mark.parametrize("updater", ["default", "sgd"])
def test_array_table_matches_jax(mv_session, port, updater):
    rng = np.random.default_rng(1)
    init = rng.standard_normal(10).astype(np.float32)
    j = mv_session.create_table("array", 10, updater=updater,
                                init_value=init)
    t = port.create_table("array", 10, updater=updater, init_value=init)
    for _ in range(3):
        delta = rng.standard_normal(10).astype(np.float32)
        j.add(delta)
        h = t.add_async(delta)
        h.wait()
    np.testing.assert_allclose(t.get(), _f32(j.get()), rtol=0, atol=ATOL)
    assert t.version == 3 and t.size == 10
    out = np.zeros(10, np.float32)
    t.get_into(out)
    np.testing.assert_array_equal(out, t.get())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("updater", ["default", "sgd", "momentum_sgd"])
def test_matrix_table_rows_match_jax(mv_session, port, dtype, updater):
    V, D = 24, 6
    rng = np.random.default_rng(2)
    j = mv_session.create_table("matrix", V, D, init_value="random", seed=3,
                                dtype=JDT[dtype], updater=updater)
    t = port.create_table("matrix", V, D, init_value="random", seed=3,
                          dtype=dtype, updater=updater)
    # get_rows keeps data[ids]: negative ids wrap, out of range clamps
    ids = np.array([0, 5, -1, -V, V + 3, -V - 2, 7, 7], np.int32)
    np.testing.assert_array_equal(t.get_rows(ids), _f32(j.get_rows(ids)))
    np.testing.assert_array_equal(t.get_row(4), _f32(j.get_row(4)))
    # add_rows keeps .at[].add: duplicates sum, a negative id wraps, an
    # id out of range is dropped. bf16 without duplicates (bitwise);
    # f32 with them.
    if dtype == torch.float32:
        ids = np.array([1, 1, 3, -2, V, 9, 1], np.int32)
    else:
        ids = np.array([1, 3, -2, V, 9], np.int32)
    vals = (rng.standard_normal((ids.size, D)) * 0.1).astype(np.float32)
    j.add_rows(ids, vals)
    t.add_rows(ids, vals)
    j.add_row(2, vals[0])
    t.add_row(2, vals[0])
    whole = (rng.standard_normal((V, D)) * 0.1).astype(np.float32)
    j.add(whole)
    t.add(whole)
    np.testing.assert_allclose(t.get(), _f32(j.get()), rtol=0, atol=ATOL)
    assert t.version == j.version == 3


def test_dirty_rows_match_jax(mv_session, port):
    V, D = 12, 3
    kw = dict(is_sparse=True, num_sim_workers=2)
    j = mv_session.create_table("matrix", V, D, **kw)
    t = port.create_table("matrix", V, D, **kw)
    vals = np.ones((3, D), np.float32)
    for tab, opt in ((j, jupd.AddOption), (t, tupd.AddOption)):
        tab.add_rows([2, 5, 5], vals, opt(worker_id=0))
    for w in (0, 1):
        jr, jv = j.get_dirty_rows(w)
        tr, tv = t.get_dirty_rows(w)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tv, _f32(jv))
    assert t.get_dirty_rows(1)[0].size == 0          # cleared by the read
    t.add(np.zeros((V, D), np.float32), tupd.AddOption(worker_id=1))
    assert t.get_dirty_rows(0)[0].tolist() == list(range(V))
    with pytest.raises(FatalError):
        t.add_rows([0], np.ones((1, D)), tupd.AddOption(worker_id=2))


def test_table_reads_snapshot_and_install(port):
    t = port.create_table("matrix", 4, 2)
    snap, version = t.snapshot_array()
    t.add(np.ones((4, 2), np.float32))
    h = t.get_async()
    t.add(np.ones((4, 2), np.float32))
    assert version == 0 and float(snap.sum()) == 0.0     # copies, not views
    np.testing.assert_array_equal(h.wait(), np.ones((4, 2)))
    t.set_array(torch.full((4, 2), 3.0))
    assert t.version == 3 and float(t.array.sum()) == 24.0
    assert t.logical(t.array) is t.array and t.pad_rows == 0
    with pytest.raises(FatalError):
        t.set_array(torch.zeros((5, 2)))


def test_session_surface(port):
    mv = port
    assert (mv.num_workers(), mv.num_servers()) == (1, 1)
    assert (mv.worker_id(), mv.server_id()) == (0, 0)
    assert mv.is_worker() and mv.is_server()
    buf = np.arange(4.0)
    assert mv.aggregate(buf) is buf
    a = mv.create_table("array", 3)
    m = mv.create_table("matrix", 2, 2)
    assert (a.table_id, m.table_id) == (0, 1)
    assert mv.session().table(1) is m
    with pytest.raises(FatalError, match="unknown table kind"):
        mv.create_table("tensor", 3)
    for kind in ("kv", "sparse", "ftrl"):
        with pytest.raises(FatalError, match="not ported"):
            mv.create_table(kind)


def test_tables_need_a_session():
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.runtime import Session
    from multiverso_tpu_torch.tables import MatrixTable

    Session._instance = None
    with pytest.raises(FatalError, match="init"):
        MatrixTable(2, 2)
    with pytest.raises(FatalError):
        mv.num_workers()
    Session._instance = None
