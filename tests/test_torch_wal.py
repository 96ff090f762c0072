"""The port's write-ahead delta journal (``io/wal.py``) against the JAX
package's, on the CPU.

Same appends, made from a numpy seed, through ``multiverso_tpu.io.wal``
and its port: the segment files are byte-identical (records serialized by
either package's ``async_ps._serialize`` at one fixed ``send_ts``), a
journal written by either package replays into the other's tables to the
writer's version and bytes, recovery truncates torn and bad-CRC tails at
the same offset, rotation and reaping against watermarks agree, and a
version gap stops replay with equal stats. The port's table hook refuses
stateful updaters, journals before an add's handle exists, and the
session opens and closes the journal from ``-wal``/``-wal_dir``. Table
sizes are multiples of the JAX test mesh's 8 servers (no pad rows).
Everything is compared bitwise: a replay applies the same records through
the same stateless updaters on the CPU.
"""

import os
import types

import numpy as np
import pytest
import torch

from multiverso_tpu.io import wal as jwal
from multiverso_tpu.parallel import async_ps as jps
from multiverso_tpu_torch.io import wal as twal
from multiverso_tpu_torch.log import FatalError
from multiverso_tpu_torch.parallel import async_ps as tps

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
    for flag, off in (("device", "cuda"), ("wal", False), ("wal_dir", ""),
                      ("wal_segment_mb", 64), ("wal_fsync", False)):
        mv.set_flag(flag, off)


@pytest.fixture()
def fixed_ts(monkeypatch):
    """Both packages' record header stamps ``send_ts`` from the clock; pin
    it so equal records are equal bytes."""
    clock = types.SimpleNamespace(time=lambda: 1234.5)
    monkeypatch.setattr(jps, "time", clock)
    monkeypatch.setattr(tps, "time", clock)


def _payloads(mod, n, seed=0):
    """``n`` DENSE/KEYED/KV records of one seeded stream, through ``mod``'s
    ``_serialize`` (f32 arrays; int32 ids; int64 keys, float64 values)."""
    from multiverso_tpu.updaters import AddOption

    rng = np.random.default_rng(seed)
    out = []
    for v in range(1, n + 1):
        kind = (mod.DENSE, mod.KEYED, mod.KV)[v % 3]
        if kind == mod.DENSE:
            arrays = [rng.standard_normal((ROWS, COLS)).astype(np.float32)]
        elif kind == mod.KEYED:
            arrays = [rng.integers(0, ROWS, 5).astype(np.int32),
                      rng.standard_normal((5, COLS)).astype(np.float32)]
        else:
            arrays = [rng.integers(0, 9, 3).astype(np.int64),
                      rng.standard_normal(3)]
        opt = AddOption(worker_id=0, learning_rate=0.1)
        out.append((v % 2, v, mod._serialize(kind, v % 2, opt, arrays,
                                              version=v)))
    return out


def _fill(wal_mod, directory, records, segment_bytes=64 << 20):
    w = wal_mod.DeltaWAL(directory, rank=0, segment_bytes=segment_bytes)
    for table_id, version, payload in records:
        w.append(table_id, version, payload)
    w.close()
    return w


def _segment_bytes(wal_mod, directory):
    return [(os.path.basename(p), open(p, "rb").read())
            for _, p in wal_mod.segments(directory, 0)]


@pytest.mark.parametrize("segment_bytes", [64 << 20, 1024])
def test_segment_files_are_byte_identical(tmp_path, fixed_ts, segment_bytes):
    """The same appends give the same segment files, rotation included;
    each package's records are the other's bytes, and each reads the
    other's journal back record for record."""
    jrec, trec = _payloads(jps, 30), _payloads(tps, 30)
    assert [p for *_, p in jrec] == [p for *_, p in trec]
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jw, tw = _fill(jwal, jd, jrec, segment_bytes), \
        _fill(twal, td, trec, segment_bytes)
    assert (jw.rotations, jw.appended) == (tw.rotations, tw.appended)
    assert (tw.rotations > 1) == (segment_bytes == 1024)
    assert _segment_bytes(jwal, jd) == _segment_bytes(twal, td)
    assert list(twal.iter_records(jd, 0)) == list(jwal.iter_records(td, 0))


def _tables(mod, dtype_bf16):
    """The same registry in either package: array, matrix f32, matrix bf16,
    kv, sparse, ftrl (ids 0-5)."""
    return {"arr": mod.create_table("array", SIZE),
            "mat": mod.create_table("matrix", ROWS, COLS),
            "bf": mod.create_table("matrix", ROWS, COLS, dtype=dtype_bf16),
            "kv": mod.create_table("kv"),
            "sp": mod.create_table("sparse", SIZE),
            "ft": mod.create_table("ftrl", SIZE)}


def _drive(tables, seed=7, n=6):
    """One seeded stream of local adds of every kind (duplicate keys
    included)."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        tables["arr"].add(rng.standard_normal(SIZE).astype(np.float32))
        ids = rng.integers(0, ROWS, 6).astype(np.int32)
        tables["mat"].add_rows(ids, rng.standard_normal(
            (6, COLS)).astype(np.float32))
        tables["mat"].add(rng.standard_normal((ROWS, COLS)).astype(
            np.float32))
        tables["bf"].add_rows(ids, rng.standard_normal(
            (6, COLS)).astype(np.float32))
        tables["kv"].add(rng.integers(0, 5, 3).tolist(),
                         rng.standard_normal(3).tolist())
        tables["sp"].add_keys(ids, rng.standard_normal(6).astype(
            np.float32))
        tables["ft"].add_keys(ids, rng.standard_normal(6),
                              rng.random(6))


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


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_replays_across_packages(mv_session, port, tmp_path, writer):
    """A journal written by either package's tables replays into the
    other's fresh tables to the writer's versions and bytes (and into the
    writer's own package the same way)."""
    import jax.numpy as jnp

    from multiverso_tpu.runtime import Session as JSession
    from multiverso_tpu_torch.runtime import Session as TSession

    d = str(tmp_path / "wal")
    jt = _tables(mv_session, jnp.bfloat16)
    tt = _tables(port, torch.bfloat16)
    src, dst, sess = ((jt, tt, JSession.get()) if writer == "jax"
                      else (tt, jt, TSession.get()))
    sess.wal = (jwal if writer == "jax" else twal).DeltaWAL(d)
    _drive(src)
    assert sess.wal.appended == 6 * 7
    sess.wal.close()
    sess.wal = None
    replay = twal.replay if writer == "jax" else jwal.replay
    stats = replay(d, 0, tables={t.table_id: t for t in dst.values()})
    assert stats == {"replayed": 42, "skipped": 0, "gaps": 0, "dropped": 0,
                     "unknown_tables": 0}
    _assert_same(src, dst)


def _cuts(path, n, seed):
    size = os.path.getsize(path)
    return sorted(np.random.default_rng(seed).integers(0, size, n).tolist())


@pytest.mark.parametrize("kind", ["torn_tail", "bad_crc"])
def test_recovery_truncates_at_the_same_offset(tmp_path, fixed_ts, kind):
    """The chaos helper's torn tail / bad CRC, and byte cuts at seeded
    points: both packages' recovery truncates at the same offset, with the
    same stats, leaving the same bytes."""
    recs = _payloads(tps, 12, seed=3)
    out = {}
    for name, mod in (("jax", jwal), ("port", twal)):
        d = str(tmp_path / name)
        w = mod.DeltaWAL(d, rank=0)
        for r in recs:
            w.append(*r)
        w.corrupt_tail(kind)
        w.close()
        w2 = mod.DeltaWAL(d, rank=0)
        w2.close()
        out[name] = (w2.recovery, [v for _, v, _, _ in
                                   mod.iter_records(d, 0)],
                     _segment_bytes(mod, d)[0])
    assert out["jax"] == out["port"]
    assert out["port"][0]["truncated_at"] > 0
    assert out["port"][1] == list(range(1, 12))
    # arbitrary cuts of one segment
    base = str(tmp_path / "base")
    _fill(twal, base, recs)
    (_, path), = twal.segments(base, 0)
    blob = open(path, "rb").read()
    for cut in _cuts(path, 8, seed=11):
        got = {}
        for name, mod in (("jax", jwal), ("port", twal)):
            d = tmp_path / f"cut_{name}"
            d.mkdir(exist_ok=True)
            (d / os.path.basename(path)).write_bytes(blob[:cut])
            got[name] = (mod.recover(str(d), 0),
                         [v for _, v, _, _ in mod.iter_records(str(d), 0)])
        assert got["jax"] == got["port"], cut


def test_rotation_and_reap_against_watermarks(tmp_path, fixed_ts):
    """Tiny segments, then a new incarnation reaping by watermarks: the
    same segments go in both packages, nothing above a watermark is lost,
    and a table the watermarks do not cover keeps its segments."""
    recs = [(0, v, p) for _, v, p in _payloads(tps, 30, seed=5)]
    reaped = {}
    for name, mod in (("jax", jwal), ("port", twal)):
        d = str(tmp_path / name)
        _fill(mod, d, recs, segment_bytes=1024)
        w = mod.DeltaWAL(d, rank=0)
        assert w.reap({7: 100}) == []          # table 0 not watermarked
        first = [os.path.basename(p) for p in w.reap({0: 15})]
        left = [v for _, v, _, _ in mod.iter_records(d, 0)]
        assert [v for v in left if v > 15] == list(range(16, 31))
        second = [os.path.basename(p) for p in w.reap({0: 30})]
        assert all(v > 30 for _, v, _, _ in mod.iter_records(d, 0))
        reaped[name] = (first, second, w.stats()["reaped_segments"])
        w.close()
    assert reaped["jax"] == reaped["port"]
    assert reaped["port"][0] and reaped["port"][1]


def test_version_gap_stops_replay_with_equal_stats(mv_session, port,
                                                   tmp_path, fixed_ts):
    """Versions 1, 2, 4: both packages replay the consecutive prefix and
    report one gap and one dropped record."""
    from multiverso_tpu.updaters import AddOption

    d = str(tmp_path / "wal")
    w = twal.DeltaWAL(d)
    for v in (1, 2, 4):
        w.append(0, v, tps._serialize(
            tps.DENSE, 0, AddOption(worker_id=0),
            [np.full(SIZE, float(v), np.float32)], version=v))
    w.close()
    jt, tt = mv_session.create_table("array", SIZE), \
        port.create_table("array", SIZE)
    sj = jwal.replay(d, 0, tables={0: jt})
    st = twal.replay(d, 0, tables={0: tt})
    assert sj == st == {"replayed": 2, "skipped": 0, "gaps": 1,
                        "dropped": 1, "unknown_tables": 0}
    assert jt.version == tt.version == 2
    np.testing.assert_array_equal(tt.get(), np.full(SIZE, 3.0))
    np.testing.assert_array_equal(tt.get(), jt.get())


@pytest.mark.parametrize("updater", ["sgd", "momentum_sgd", "adagrad"])
def test_stateful_updaters_are_refused(mv_session, port, tmp_path, updater):
    """Replay cannot rebuild updater state: a journaled add on a stateful
    updater's table raises in both packages; sgd journals."""
    from multiverso_tpu.log import FatalError as JFatal
    from multiverso_tpu.runtime import Session as JSession
    from multiverso_tpu_torch.runtime import Session as TSession

    delta = np.ones((ROWS, COLS), np.float32)
    for sess, mod, wal_mod, fatal in (
            (JSession.get(), mv_session, jwal, JFatal),
            (TSession.get(), port, twal, FatalError)):
        sess.wal = wal_mod.DeltaWAL(str(tmp_path / type(sess).__module__))
        t = mod.create_table("matrix", ROWS, COLS, updater=updater)
        if updater == "sgd":
            t.add(delta)
            t.add_rows([1, 1], delta[:2])
            assert sess.wal.appended == 2
        else:
            with pytest.raises(fatal, match="STATEFUL"):
                t.add(delta)
            with pytest.raises(fatal, match="STATEFUL"):
                t.add_rows([1, 1], delta[:2])
            assert sess.wal.appended == 0
        sess.wal.close()
        sess.wal = None


def test_journal_is_written_before_the_handle(port, tmp_path):
    """An add is journaled inside ``add_async``, before its handle exists:
    whatever ``add`` acknowledged is in the journal."""
    from multiverso_tpu_torch.runtime import Session

    sess = Session.get()
    sess.wal = twal.DeltaWAL(str(tmp_path / "wal"))
    t = port.create_table("matrix", ROWS, COLS)
    sp = port.create_table("sparse", SIZE)
    kv = port.create_table("kv")
    h = t.add_async(np.ones((ROWS, COLS), np.float32))
    assert sess.wal.appended == 1
    h.wait()
    h = t.add_rows_async([2], np.ones((1, COLS), np.float32))
    assert sess.wal.appended == 2
    h.wait()
    h = sp.add_keys_async([3, 3], np.ones(2, np.float32))
    assert sess.wal.appended == 3
    h.wait()
    kv.add([1], [2.0])
    assert sess.wal.appended == 4
    assert [(tid, v) for tid, v, _, _ in
            twal.iter_records(sess.wal.directory, 0)] == [
                (0, 1), (0, 2), (1, 1), (2, 1)]


def test_wal_flags(tmp_path):
    """``-wal`` opens the journal at init (``-wal_dir``, ``-wal_segment_mb``,
    ``-wal_fsync``) and ``shutdown`` closes it; ``-wal`` without
    ``-wal_dir`` is fatal and leaves no session started."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.runtime import Session

    d = str(tmp_path / "wal")
    Session._instance = None
    try:
        with pytest.raises(FatalError, match="wal_dir"):
            mv.init(["t", "-device=cpu", "-wal=true"])
        assert not Session.get().started
        mv.init(["t", "-device=cpu", "-wal=true", f"-wal_dir={d}",
                 "-wal_segment_mb=1", "-wal_fsync=true"])
        w = Session.get().wal
        assert isinstance(w, twal.DeltaWAL)
        assert (w.directory, w.rank, w.segment_bytes, w.fsync) == (
            d, 0, 1 << 20, True)
        t = mv.create_table("array", SIZE)
        t.add(np.ones(SIZE, np.float32))
        assert w.appended == 1
        mv.shutdown()
        assert Session.get().wal is None and w._fd is None
        assert [v for _, v, _, _ in twal.iter_records(d, 0)] == [1]
    finally:
        Session._instance = None
        for flag, off in (("device", "cuda"), ("wal", False),
                          ("wal_dir", ""), ("wal_segment_mb", 64),
                          ("wal_fsync", False)):
            mv.set_flag(flag, off)
