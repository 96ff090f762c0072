"""The port's ``memory://`` scheme (``io/remote.py``) and scheme registry
(``io/stream.py``) against the JAX package's, on the CPU.

The JAX package keeps ``memory://`` objects in tensorstore's memory driver;
the port in a process-wide dict. Each case does the same thing in both
stores, with data from a numpy seed: a record round trip (the committed
objects are the same bytes), ``TextReader`` lines (and word2vec's
dictionary from a ``memory://`` corpus), a missing object, a write
aborted by an exception or by ``abort()``, ``exists``, and a checkpoint
on a ``memory://`` root (``Autosaver`` retention and pruning,
``restore_latest``, the same manifest). ``gs://`` and ``hdfs://`` raise
a ``FatalError`` that names their roadmap item.
"""

import json

import numpy as np
import pytest

from multiverso_tpu.io import remote as jremote
from multiverso_tpu.io import stream as jstream
from multiverso_tpu_torch.io import remote as tremote
from multiverso_tpu_torch.io import stream as tstream
from multiverso_tpu_torch.log import FatalError

PACKAGES = (("jax", jstream, jremote), ("port", tstream, tremote))


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


def _read(stream_mod, uri):
    with stream_mod.open_stream(uri, "rb") as s:
        return s.read()


def test_memory_round_trip():
    arr = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    uri = "memory://bucket/dir/rec.bin"
    blobs = {}
    for name, st, _ in PACKAGES:
        with st.open_stream(uri, "wb") as s:
            st.write_array(s, arr)
        with st.open_stream(uri, "rb") as s:
            np.testing.assert_array_equal(st.read_array(s), arr)
        blobs[name] = _read(st, uri)
    assert blobs["jax"] == blobs["port"]
    # the namespace is the host part: another host is another object
    with pytest.raises(FileNotFoundError):
        tstream.open_stream("memory://other/dir/rec.bin", "rb")


def test_memory_text_reader_and_word2vec_corpus(tmp_path):
    from multiverso_tpu.apps import wordembedding as jwe
    from multiverso_tpu_torch.apps import wordembedding as twe

    rng = np.random.default_rng(1)
    words = [f"w{i}" for i in rng.integers(0, 12, 200)]
    text = "\n".join(" ".join(words[i:i + 9])
                     for i in range(0, 200, 9)).encode() + b"\r\nlast \xff"
    uri = "memory://corpora/text.txt"
    lines = {}
    for name, st, _ in PACKAGES:
        with st.open_stream(uri, "wb") as s:
            s.write(text)
        with st.TextReader(uri, buf_size=16) as r:
            lines[name] = list(r)
    assert lines["jax"] == lines["port"]
    assert lines["port"][-1] == "last �"
    assert list(twe._read_lines(uri)) == lines["port"]
    # word2vec's dictionary from the memory:// corpus equals the JAX
    # package's from the same bytes in a file (its native vocab builder
    # reads local files only)
    local = tmp_path / "text.txt"
    local.write_bytes(text)
    td = twe.Dictionary.build(uri, min_count=1)
    jd = jwe.Dictionary.build(str(local), min_count=1)
    assert (td.words, td.counts) == (jd.words, jd.counts)


def test_missing_object_raises():
    for _, st, _ in PACKAGES:
        with pytest.raises(FileNotFoundError):
            st.open_stream("memory://bucket/nope.bin", "rb")


def test_write_aborts_on_exception():
    """A ``with`` block that raises, or ``abort()``, commits nothing."""
    for _, st, rem in PACKAGES:
        uri = "memory://bucket/partial.bin"
        with pytest.raises(RuntimeError):
            with st.open_stream(uri, "wb") as s:
                s.write(b"half-written")
                raise RuntimeError("mid-write failure")
        assert not rem.exists(uri)
        s = st.open_stream("memory://bucket/aborted.bin", "wb")
        s.write(b"junk")
        s.abort()
        s.close()
        assert not rem.exists("memory://bucket/aborted.bin")


def test_exists_probe():
    for _, st, rem in PACKAGES:
        uri = "memory://probe/p.bin"
        assert not rem.exists(uri)
        with st.open_stream(uri, "wb") as s:
            s.write(b"x")
        assert rem.exists(uri)
        assert not rem.exists("memory://probe/p.bin.tmp")


def test_unported_schemes_raise():
    """``gs://`` and ``hdfs://`` never open (not even as a local path) and
    name the roadmap item that ports them; an unknown scheme raises."""
    for uri in ("gs://bucket/x", "hdfs://nn:9000/x"):
        for mode in ("rb", "wb"):
            with pytest.raises(FatalError, match="item 7b"):
                tstream.open_stream(uri, mode)
        assert tstream.is_remote(uri) and jstream.is_remote(uri)
    with pytest.raises(FatalError, match="no stream handler"):
        tstream.open_stream("s3://bucket/x")
    assert not tstream.is_remote("/tmp/x") and not tstream.is_remote(
        "file:///tmp/x")


def test_checkpoint_on_a_memory_root(mv_session, port):
    """``Autosaver`` on a ``memory://`` root in both packages: the same
    steps survive pruning, the manifests are equal, ``restore_latest``
    restores the newest step, and a restore reads the committed
    objects."""
    from multiverso_tpu.io import checkpoint as jck
    from multiverso_tpu_torch.io import checkpoint as tck

    rng = np.random.default_rng(2)
    deltas = rng.standard_normal((3, 8)).astype(np.float32)
    rows = rng.standard_normal((2, 3)).astype(np.float32)
    out = {}
    for name, mod, st, rem, ck in (
            ("jax", mv_session, jstream, jremote, jck),
            ("port", port, tstream, tremote, tck)):
        t = mod.create_table("array", 8)
        m = mod.create_table("matrix", 8, 3)
        root = "memory://asave/ckpts"
        saver = ck.Autosaver(root, every_steps=1, keep=2)
        for step in (1, 2, 3):
            t.add(deltas[step - 1])
            m.add_rows([1, 4], rows)
            assert saver.step(step)
        assert ck.list_steps(root) == [2, 3]
        assert not rem.exists(root + "/step_1/manifest.json")
        assert rem.list_subdirs_with(root, "manifest.json") == [
            "step_2", "step_3"]
        manifest = json.loads(_read(st, root + "/step_3/manifest.json"))
        want = (t.get().copy(), m.get().copy())
        t.add(np.full(8, 50.0, np.float32))
        m.add(np.ones((8, 3), np.float32))
        assert ck.restore_latest(root) == 3
        np.testing.assert_array_equal(t.get(), want[0])
        np.testing.assert_array_equal(m.get(), want[1])
        assert (t.version, m.version) == (3, 3)
        rem.delete_prefix(root)
        assert ck.list_steps(root) == []
        out[name] = (manifest, want[0], want[1])
    assert out["jax"][0] == out["port"][0]
    np.testing.assert_array_equal(out["jax"][1], out["port"][1])
    np.testing.assert_array_equal(out["jax"][2], out["port"][2])
