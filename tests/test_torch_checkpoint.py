"""The port's session checkpoints (``io/checkpoint.py``) against the JAX
package's, on the CPU.

Same tables, same seeded adds, in both packages: a checkpoint written by
either package restores in the other (the manifests equal, the table
files byte-equal, the versions and bytes restored equal);
``restore_latest`` skips the same torn step directories and falls back to
a fresh start where JAX does; ``Autosaver``'s retention, its ignoring of
``.tmp`` directories and its journal reaping match; checkpoint + journal
replay reaches the exact pre-crash version, also across packages; the
orbax entry points raise. Sizes are multiples of the JAX test mesh's 8
servers. Everything is compared bitwise (stateless updaters on the CPU).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from multiverso_tpu.io import checkpoint as jck
from multiverso_tpu.io import wal as jwal
from multiverso_tpu_torch.io import checkpoint as tck
from multiverso_tpu_torch.io import wal as twal
from multiverso_tpu_torch.log import FatalError

ROWS, COLS, SIZE = 16, 4, 16


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
    sess = Session.get()
    if sess.wal is not None:
        sess.wal.close()
        sess.wal = None
    mv.shutdown()
    Session._instance = None
    mv.set_flag("device", "cuda")


def _tables(mod, bf16):
    return {"arr": mod.create_table("array", SIZE),
            "mat": mod.create_table("matrix", ROWS, COLS),
            "bf": mod.create_table("matrix", ROWS, COLS, dtype=bf16),
            "kv": mod.create_table("kv"),
            "sp": mod.create_table("sparse", SIZE),
            "ft": mod.create_table("ftrl", SIZE)}


def _both(mv_session, port):
    import jax.numpy as jnp

    return _tables(mv_session, jnp.bfloat16), _tables(port, torch.bfloat16)


def _drive(tables, seed, n=3):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        ids = rng.integers(0, ROWS, 5).astype(np.int32)
        tables["arr"].add(rng.standard_normal(SIZE).astype(np.float32))
        tables["mat"].add_rows(ids, rng.standard_normal(
            (5, COLS)).astype(np.float32))
        tables["bf"].add_rows(ids, rng.standard_normal(
            (5, COLS)).astype(np.float32))
        tables["kv"].add(rng.integers(0, 4, 2).tolist(),
                         rng.standard_normal(2).tolist())
        tables["sp"].add_keys(ids, rng.standard_normal(5).astype(
            np.float32))
        tables["ft"].add_keys(ids, rng.standard_normal(5), rng.random(5))


def _state(t):
    if hasattr(t, "_store"):
        return dict(t._store), t.version
    return np.asarray(t.get(), np.float32), t.version


def _assert_same(a, b):
    for name in a:
        sa, sb = _state(a[name]), _state(b[name])
        assert sa[1] == sb[1], name
        if isinstance(sa[0], dict):
            assert sa[0] == sb[0], name
        else:
            np.testing.assert_array_equal(sa[0], sb[0], err_msg=name)


def test_table_class_names_match_jax():
    """The manifest holds ``type(table).__name__``: the port's classes
    must carry the JAX names, or checkpoints would not cross-restore."""
    import multiverso_tpu.tables as jt
    import multiverso_tpu_torch.tables as tt

    for name in ("ArrayTable", "MatrixTable", "SparseTable", "FTRLTable",
                 "KVTable"):
        assert getattr(tt, name).__name__ == getattr(jt, name).__name__


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_restore(mv_session, port, tmp_path, writer):
    """Both packages save the same state: the manifests are equal and each
    table file is the same bytes. The reader, after adds of its own,
    restores the writer's checkpoint to the writer's versions and bytes."""
    jt, tt = _both(mv_session, port)
    _drive(jt, seed=1)
    _drive(tt, seed=1)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jm, tm = jck.save(jdir), tck.save(tdir)
    assert jm == tm
    assert [e["version"] for e in tm["tables"]] == [3] * 6
    for entry in tm["tables"]:
        with open(os.path.join(jdir, entry["file"]), "rb") as a, \
                open(os.path.join(tdir, entry["file"]), "rb") as b:
            assert a.read() == b.read(), entry
    src, dst = (jt, tt) if writer == "jax" else (tt, jt)
    restore = tck.restore if writer == "jax" else jck.restore
    _drive(dst, seed=2, n=2)                       # state to overwrite
    restore(jdir if writer == "jax" else tdir)
    _assert_same(src, dst)


def _torn_root(root, tables, save):
    """step_1 complete, step_2's table file truncated, step_3 without a
    manifest, step_4 with a garbage manifest."""
    tables["arr"].add(np.full(SIZE, 1.0, np.float32))
    save(os.path.join(root, "step_1"))
    tables["arr"].add(np.full(SIZE, 1.0, np.float32))
    save(os.path.join(root, "step_2"))
    victim = os.path.join(root, "step_2", "table_0.bin")
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) - 7)
    os.makedirs(os.path.join(root, "step_3"))
    os.makedirs(os.path.join(root, "step_4"))
    with open(os.path.join(root, "step_4", "manifest.json"), "w") as f:
        f.write("{not json")
    tables["arr"].add(np.full(SIZE, 50.0, np.float32))


def test_restore_latest_skips_torn_steps(mv_session, port, tmp_path):
    """The port writes the torn root; both packages' ``restore_latest``
    skip the same three step dirs and restore step 1 at its watermark,
    and each ``verify_step`` gives the same verdicts."""
    jt, tt = _both(mv_session, port)
    root = str(tmp_path / "auto")
    _torn_root(root, tt, tck.save)
    jt["arr"].add(np.full(SIZE, 9.0, np.float32))
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        assert (tck.verify_step(path) is None) == \
            (jck.verify_step(path) is None) == (name == "step_1"), name
    assert tck.list_steps(root) == jck.list_steps(root) == [1, 2, 4]
    assert tck.restore_latest(root) == jck.restore_latest(root) == 1
    for t in (tt["arr"], jt["arr"]):
        np.testing.assert_array_equal(t.get(), np.full(SIZE, 1.0))
        assert t.version == 1
    _assert_same(tt, jt)


def test_restore_latest_fresh_start(mv_session, port, tmp_path):
    """No root, or only torn steps: a fresh start (None) in both."""
    tt = port.create_table("array", 8)
    mv_session.create_table("array", 8)
    assert tck.restore_latest(str(tmp_path / "empty")) is None
    root = str(tmp_path / "auto")
    tt.add(np.ones(8, np.float32))
    tck.save(os.path.join(root, "step_1"))
    os.remove(os.path.join(root, "step_1", "table_0.bin"))
    assert tck.restore_latest(root) is None
    assert jck.restore_latest(root) is None
    assert tck.LAST_WAL_REPLAY is None


def test_autosaver_retention_tmp_and_reap(mv_session, port, tmp_path):
    """Every 2 steps, keep 2: the same saves and survivors in both
    packages; a crashed ``.tmp`` dir is never a step; with a journal, each
    completed checkpoint reaps the closed segments it covers."""
    from multiverso_tpu.runtime import Session as JSession
    from multiverso_tpu_torch.runtime import Session as TSession

    out = {}
    for name, mod, ck, wal_mod, sess in (
            ("jax", mv_session, jck, jwal, JSession.get()),
            ("port", port, tck, twal, TSession.get())):
        arr = mod.create_table("array", 8)
        root = str(tmp_path / name / "auto")
        sess.wal = wal_mod.DeltaWAL(str(tmp_path / name / "wal"),
                                    segment_bytes=1024)
        saver = ck.Autosaver(root, every_steps=2, keep=2)
        saved = []
        for step in range(1, 9):
            arr.add(np.ones(8, np.float32))
            if saver.step(step):
                saved.append(step)
        os.makedirs(os.path.join(root, "step_99.tmp"))
        stats = sess.wal.stats()
        left = [v for _, v, _, _ in wal_mod.iter_records(
            sess.wal.directory, 0)]
        sess.wal.close()
        sess.wal = None
        arr.add(np.full(8, 100.0, np.float32))
        step = ck.restore_latest(root)
        out[name] = (saved, ck.list_steps(root), step, arr.version,
                     stats["reaped_segments"], stats["rotations"], left)
        np.testing.assert_array_equal(arr.get(), np.full(8, 8.0))
    assert out["jax"] == out["port"]
    saved, steps, step, version, reaped, rotations, left = out["port"]
    assert (saved, steps, step, version) == ([2, 4, 6, 8], [6, 8], 8, 8)
    assert rotations == reaped == 1 and left == []


@pytest.mark.parametrize("recoverer", ["port", "jax"])
def test_checkpoint_plus_replay_reaches_the_exact_version(
        mv_session, port, tmp_path, recoverer):
    """The port's tables, journaled, checkpointed at add 5 of 9, then
    clobbered: ``restore_latest`` + replay reaches the exact pre-crash
    versions and bytes, in the port and in JAX tables alike."""
    from multiverso_tpu_torch.runtime import Session as TSession

    jt, tt = _both(mv_session, port)
    sess = TSession.get()
    wal_dir = str(tmp_path / "wal")
    sess.wal = twal.DeltaWAL(wal_dir)
    ck = str(tmp_path / "ckpt")
    rng = np.random.default_rng(3)
    for i in range(9):
        ids = rng.integers(0, ROWS, 4).astype(np.int32)
        tt["mat"].add_rows(ids, rng.standard_normal((4, COLS)).astype(
            np.float32))
        tt["bf"].add_rows(ids, rng.standard_normal((4, COLS)).astype(
            np.float32))
        tt["arr"].add(rng.standard_normal(SIZE).astype(np.float32))
        tt["kv"].add([i % 4], [float(i)])
        tt["sp"].add_keys(ids, rng.standard_normal(4).astype(np.float32))
        tt["ft"].add_keys(ids, rng.standard_normal(4), rng.random(4))
        if i == 4:
            tck.save(os.path.join(ck, "step_1"))
    sess.wal.close()
    sess.wal = None
    want = {name: _state(t) for name, t in tt.items()}
    if recoverer == "port":
        tables, ck_mod = tt, tck
        for name, t in tt.items():
            if name == "kv":
                t._store.clear()
                t.version = 0
            else:
                t._install_state(np.zeros(t.shape, np.float32), 0)
    else:
        tables, ck_mod = jt, jck
    step = ck_mod.restore_latest(ck, wal_dir=wal_dir, wal_rank=0)
    assert step == 1
    assert ck_mod.LAST_WAL_REPLAY == {"replayed": 24, "skipped": 30,
                                      "gaps": 0, "dropped": 0,
                                      "unknown_tables": 0}
    for name, t in tables.items():
        got = _state(t)
        assert got[1] == want[name][1] == 9, name
        if name == "kv":
            assert got[0] == want[name][0]
        else:
            np.testing.assert_array_equal(got[0], want[name][0],
                                          err_msg=name)


def test_restore_errors_match(mv_session, port, tmp_path):
    """A missing manifest and a type mismatch are fatal in both."""
    from multiverso_tpu.log import FatalError as JFatal

    port.create_table("array", 8)
    mv_session.create_table("array", 8)
    with pytest.raises(FatalError, match="manifest"):
        tck.restore(str(tmp_path / "nope"))
    with pytest.raises(JFatal, match="manifest"):
        jck.restore(str(tmp_path / "nope"))
    d = str(tmp_path / "ckpt")
    tck.save(d)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    manifest["tables"][0]["type"] = "MatrixTable"
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(FatalError, match="MatrixTable"):
        tck.restore(d)
    with pytest.raises(JFatal, match="MatrixTable"):
        jck.restore(d)
    shutil.rmtree(d)


def test_orbax_entry_points_raise(port, tmp_path):
    port.create_table("array", 8)
    for fn in (tck.save_orbax, tck.restore_orbax):
        with pytest.raises(FatalError, match="item 8"):
            fn(str(tmp_path / "orbax"))
    assert not os.path.exists(tmp_path / "orbax")
