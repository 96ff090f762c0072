"""The port's parameter server across real processes, on the CPU.

Counterparts of ``tests/test_multiprocess.py``'s scenarios for
``multiverso_tpu_torch``: each test starts a group of fresh interpreters
(``MV_COORDINATOR_ADDRESS``/``MV_NUM_PROCESSES``/``MV_PROCESS_ID``, or
``net_bind``/``net_connect``), every one with ``-device=cpu``, and checks
the group's contracts: the group's size and ranks, BSP aggregation
(dense, keyed, ``KVTable.sync``) and ``-ma``; the async delta bus (dense,
keyed, KV and a bit-exact f64 table); the bus's chunking and
backpressure over KV payloads; SSP bounded staleness; the failure
detector and survivor mode with a SIGKILLed rank; and multi-process
word2vec learning the planted clusters. Each group gets at most 120 s.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HEAD = textwrap.dedent("""
    import os, sys, time
    import numpy as np
    sys.path.insert(0, %r)
    import multiverso_tpu_torch as mv
    rank = int(os.environ.get("MV_PROCESS_ID", os.environ.get("NET_RANK",
                                                             "0")))
""") % REPO


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(tmp_path, body: str, n: int = 2, extra_env=None,
              timeout: float = 120, env_group: bool = True):
    """Run ``body`` (after a common header) in ``n`` fresh interpreters
    joined as one group; returns ``(procs, outputs)``."""
    script = tmp_path / f"worker_{abs(hash(body)) % 10 ** 8}.py"
    script.write_text(_HEAD + textwrap.dedent(body))
    port = _free_port()
    procs = []
    for rank in range(n):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("MV_") and k != "PYTHONPATH"}
        if env_group:
            env.update({"MV_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                        "MV_NUM_PROCESSES": str(n),
                        "MV_PROCESS_ID": str(rank)})
        else:
            env["NET_RANK"] = str(rank)
        env["MV_TEST_OUT"] = str(tmp_path)
        # one intra-op thread a process: several processes share the cores
        env["OMP_NUM_THREADS"] = "1"
        env.update(extra_env or {})
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for rank, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            pytest.fail(f"rank {rank} timed out")
        outs.append(out)
    return procs, outs


def assert_ok(procs, outs, tag, ranks=None):
    for rank in (range(len(procs)) if ranks is None else ranks):
        assert procs[rank].returncode == 0, \
            f"rank {rank}:\n{outs[rank][-3000:]}"
        assert f"RANK{rank}_{tag}_OK" in outs[rank], outs[rank][-3000:]


def test_two_processes_form_one_group(tmp_path):
    """MV_NUM_PROCESSES=2 gives one group of two: each process reports
    size 2 and its own rank (the session used to report rank 0 of 1 in
    each and train alone)."""
    procs, outs = run_group(tmp_path, """
        mv.init(["w", "-device=cpu"])
        assert mv.size() == 2, mv.size()
        assert mv.rank() == rank and mv.worker_id() == rank
        assert mv.num_workers() == 2
        mv.barrier()
        mv.shutdown()
        print(f"RANK{rank}_GROUP_OK", flush=True)
    """)
    assert_ok(procs, outs, "GROUP")


def test_group_that_cannot_form_is_fatal(tmp_path):
    """A group asked for that cannot form raises FatalError: rank 0 cannot
    host its store on a port already taken, a rank outside the group, a
    group without a coordinator address and a net_connect without its
    net_bind are refused, and the session never starts as one process of
    one."""
    with socket.socket() as busy:
        busy.bind(("127.0.0.1", 0))
        busy.listen(1)
        port = busy.getsockname()[1]
        procs, outs = run_group(tmp_path, """
            from multiverso_tpu_torch.log import FatalError
            try:
                mv.init(["w", "-device=cpu"])
            except FatalError as exc:
                assert not mv.session().started
                print(f"RANK0_REFUSED_OK {exc}", flush=True)
        """, n=1, extra_env={"MV_NUM_PROCESSES": "2",
                             "MV_COORDINATOR_ADDRESS": f"127.0.0.1:{port}"},
            env_group=False)
        assert_ok(procs, outs, "REFUSED")
        assert "could not join" in outs[0]
    for case, env in (("rank", {"MV_PROCESS_ID": "2"}),
                      ("no_coordinator", {}), ("net_connect_only", {})):
        procs, outs = run_group(tmp_path, """
            from multiverso_tpu_torch.log import FatalError
            if os.environ["CASE"] == "no_coordinator":
                del os.environ["MV_COORDINATOR_ADDRESS"]
            if os.environ["CASE"] == "net_connect_only":
                mv.net_connect([0, 1], ["127.0.0.1:1", "127.0.0.1:2"])
            try:
                mv.init(["w", "-device=cpu"])
            except FatalError:
                print("RANK0_REFUSED_OK", flush=True)
        """, n=1, extra_env={"MV_NUM_PROCESSES": "2",
                             "MV_COORDINATOR_ADDRESS": "127.0.0.1:1",
                             "CASE": case, **env}, env_group=False)
        assert_ok(procs, outs, "REFUSED")


def test_two_process_obs_plane_and_journal_per_rank(tmp_path):
    """-obs_plane runs an agent per process with rank 0 collecting over
    the group's KV (both nodes in its fleet view, each rank's archive
    under its own suffix), and -wal opens each process's journal under its
    own rank, so two processes sharing a -wal_dir write distinct
    segments."""
    procs, outs = run_group(tmp_path, """
        out = os.environ["MV_TEST_OUT"]
        mv.init(["w", "-device=cpu", "-obs_plane=true", "-obs_report_ms=100",
                 f"-obs_jsonl={out}/obs.jsonl", "-wal=true",
                 f"-wal_dir={out}/wal", "-log_level=error"])
        t = mv.create_table("array", 8)
        t.add(np.ones(8, np.float32))
        agent = mv.session().obs_agent
        if rank == 0:
            deadline = time.monotonic() + 30
            while agent.collector.fleet()["nodes"] < 2:
                assert time.monotonic() < deadline, agent.collector.fleet()
                time.sleep(0.05)
        mv.barrier()
        mv.shutdown()
        print(f"RANK{rank}_OBSWAL_OK", flush=True)
    """)
    assert_ok(procs, outs, "OBSWAL")
    segs = sorted(os.listdir(tmp_path / "wal"))
    assert any(n.startswith("wal-r000-") for n in segs), segs
    assert any(n.startswith("wal-r001-") for n in segs), segs
    assert (tmp_path / "obs.jsonl.0").exists()
    assert (tmp_path / "obs.jsonl.1").exists()


def test_two_process_sync_contracts(tmp_path):
    """Sync mode: aggregate, whole-table and keyed adds obey the
    SyncServer invariant (every replica folds the sum over workers), a
    bf16 table's BSP add rounds like the JAX package's, KVTable.sync
    merges every process's pending adds; then -ma in a new session of the
    same processes: aggregate only, no bus."""
    procs, outs = run_group(tmp_path, """
        import torch
        mv.init(["w", "-sync=true", "-device=cpu"])
        assert mv.session().async_bus is None
        agg = mv.aggregate(np.full(4, float(rank + 1), np.float32))
        assert np.all(agg == 3.0), agg
        t = mv.create_table("array", 16)
        t.add(np.full(16, float(rank + 1), np.float32))
        assert np.all(t.get() == 3.0), t.get()
        # keyed: ragged per-rank keysets (rank r adds rows 0..r)
        m = mv.create_table("matrix", 6, 3)
        ids = list(range(rank + 1))
        m.add_rows(ids, np.full((len(ids), 3), 1.0, np.float32))
        got = m.get()
        assert np.all(got[0] == 2.0) and np.all(got[1] == 1.0), got
        assert np.all(got[2:] == 0.0), got
        s = mv.create_table("sparse", 16)
        s.add_keys([rank, 15], [1.0, 0.5])
        assert np.all(s.get_keys([15]) == 1.0), s.get_keys([15])
        f = mv.create_table("ftrl", 8)
        f.add_keys([3], [rank + 1.0], [1.0])
        z, n_ = f.get_keys([3])
        assert z[0] == 3.0 and n_[0] == 2.0, (z, n_)
        b = mv.create_table("array", 4, dtype=torch.bfloat16)
        b.add(np.full(4, 1.0 + 2.0 ** -7 * (rank + 1), np.float32))
        want = torch.tensor(1.0 + 2 ** -7).bfloat16().float() + \\
            torch.tensor(1.0 + 2 * 2 ** -7).bfloat16().float()
        assert np.all(b.get() == want.bfloat16().float().item()), b.get()
        kv = mv.create_table("kv")
        kv.add([7, 10 + rank, -3], [1.0, 0.5, 0.25])
        assert kv.get([7]) == [1.0]          # not merged before sync()
        kv.sync()
        assert kv.get([7]) == [2.0] and kv.get([-3]) == [0.5], kv.get([7])
        assert kv.get([10, 11]) == [0.5, 0.5]
        kv.sync()                            # nothing pending: no change
        assert kv.get([7]) == [2.0]
        mv.barrier()
        mv.shutdown()
        mv.init(["w", "-sync=false", "-ma=true", "-device=cpu"])
        assert mv.size() == 2 and mv.session().async_bus is None
        agg = mv.aggregate(np.full(8, float(rank), np.float64))
        assert np.all(agg == 1.0), agg
        t = mv.create_table("array", 4)
        t.add(np.full(4, float(rank + 1), np.float32))   # local only
        assert np.all(t.get() == rank + 1.0), t.get()
        mv.barrier()
        mv.shutdown()
        print(f"RANK{rank}_SYNC_OK", flush=True)
    """)
    assert_ok(procs, outs, "SYNC")


def test_two_process_async_delta_propagation(tmp_path):
    """Async mode: dense, keyed (matrix rows), KV and f64 adds made
    concurrently land on every replica after barrier(), the f64 table bit
    for bit (the wire does not downcast); a second phase after the
    quiesce keeps working; the bus carried p2p payloads."""
    procs, outs = run_group(tmp_path, """
        mv.init(["w", "-sync=false", "-device=cpu"])
        bus = mv.session().async_bus
        assert bus is not None and bus._p2p is not None
        t = mv.create_table("array", 32)
        for i in range(7):
            t.add(np.full(32, float(rank + 1), np.float32))
        m = mv.create_table("matrix", 10, 4)
        m.add_rows([rank, 9], np.full((2, 4), float(rank + 1), np.float32))
        kv = mv.create_table("kv")
        kv.add([7, rank], [1.0, 0.5])
        d = mv.create_table("array", 8, dtype=np.float64)
        precise = 0.1234567890123456
        d.add(np.full(8, precise * (rank + 1), np.float64))
        mv.barrier()
        assert np.all(t.get() == 7 * 3.0), t.get()[:4]
        gm = m.get()
        assert np.all(gm[9] == 3.0) and np.all(gm[0] == 1.0), gm
        assert np.all(gm[1] == 2.0) and np.all(gm[2:9] == 0.0), gm
        assert kv.get([7]) == [2.0] and kv.get([0, 1]) == [0.5, 0.5]
        gd = d.get()
        assert gd.dtype == np.float64 and np.all(gd == precise * 3), gd[0]
        t.add(np.full(32, 1.0, np.float32))
        mv.barrier()
        assert np.all(t.get() == 7 * 3.0 + 2.0), t.get()[:4]
        st = bus.stats()
        assert st["applied"] >= 11 and st["inflight_bytes"] == 0, st
        mv.shutdown()
        print(f"RANK{rank}_ASYNC_OK", flush=True)
    """)
    assert_ok(procs, outs, "ASYNC")


def test_two_process_bigbus_chunked_backpressure(tmp_path):
    """KV payloads (-async_p2p=false) with a 64 KB record cap and a 1 MB
    in-flight watermark: 1 MB dense records travel as PART records, the
    publisher hits backpressure, a half-touched matrix add travels keyed,
    and after barrier() every delta landed once and nothing is in
    flight."""
    procs, outs = run_group(tmp_path, """
        mv.init(["w", "-sync=false", "-async_p2p=false", "-device=cpu",
                 "-async_max_record_kb=64", "-async_max_inflight_mb=1",
                 "-log_level=error"])
        bus = mv.session().async_bus
        assert bus is not None and bus._p2p is None
        rows, cols, iters = 512, 512, 4          # 1 MB dense records
        m = mv.create_table("matrix", rows, cols)
        for i in range(iters):
            m.add(np.full((rows, cols), 0.125 * (rank + 1), np.float32))
        k = mv.create_table("matrix", rows, cols)
        half = np.arange(0, rows, 2, dtype=np.int32)
        delta = np.zeros((rows, cols), np.float32)
        delta[half] = 0.25
        k.add(delta)                             # published keyed
        mv.barrier()
        assert np.all(m.get() == iters * 0.125 * 3.0), m.get()[0, 0]
        gk = k.get()
        assert np.all(gk[::2] == 0.5) and np.all(gk[1::2] == 0.0)
        st = bus.stats()
        assert st["inflight_bytes"] == 0, st
        assert st["published"] >= iters * 16, st   # parts of 64 KB
        assert st["backpressure_waits"] > 0, st
        mv.shutdown()
        print(f"RANK{rank}_BIGBUS_OK", flush=True)
    """)
    assert_ok(procs, outs, "BIGBUS")


def test_two_process_ssp_bounded_staleness(tmp_path):
    """SSP with staleness 2 and one slow worker: the fast worker is gated
    by the bound and both replicas hold every delta after finish() and
    barrier()."""
    procs, outs = run_group(tmp_path, """
        from multiverso_tpu_torch.parallel import SSPClock
        mv.init(["w", "-sync=false", "-device=cpu"])
        t = mv.create_table("array", 8)
        clock = SSPClock(staleness=2)
        rounds, gated = 8, 0.0
        for r in range(rounds):
            t0 = time.monotonic()
            clock.wait()
            gated += time.monotonic() - t0
            if rank == 1 and r < 3:
                time.sleep(0.3)              # a deliberately slow worker
            t.add(np.full(8, 1.0, np.float32))
            clock.tick()
        clock.finish()
        if rank == 0:
            assert gated > 0.4, f"fast worker never gated ({gated:.2f}s)"
        mv.barrier()
        assert np.all(t.get() == rounds * 2.0), t.get()
        mv.shutdown()
        print(f"RANK{rank}_SSP_OK", flush=True)
    """)
    assert_ok(procs, outs, "SSP")


def test_two_process_ssp_unequal_shards_no_deadlock(tmp_path):
    """word2vec's host stream at -ssp_staleness=0 on a corpus whose line
    shards give the two processes unequal batch counts: the per-epoch
    clock's finish() releases the laggard, two epochs complete, and the
    word-count table holds each process's words."""
    rng = np.random.default_rng(5)
    corpus = tmp_path / "uneq.txt"
    with open(corpus, "w") as f:
        for i in range(151):                     # odd: the shards differ
            n = 4 + (i * 7) % 9
            f.write(" ".join(f"w{j}" for j in rng.integers(0, 30, n)) +
                    "\n")
    procs, outs = run_group(tmp_path, """
        from multiverso_tpu_torch.apps.wordembedding import Dictionary, train
        from multiverso_tpu_torch.models.word2vec import Word2VecConfig
        corpus = os.environ["MV_TEST_CORPUS"]
        mv.init(["w", "-sync=false", "-ssp_staleness=0", "-device=cpu",
                 "-log_level=error"])
        d = Dictionary.build(corpus, min_count=1)
        cfg = Word2VecConfig(embedding_size=8, window=2, negative=2,
                             batch_size=64, steps_per_call=1, seed=13)
        res = train(corpus, cfg=cfg, epochs=2, min_count=1, dictionary=d,
                    device_corpus=False, log_every=0)
        assert res.pairs_trained > 0 and np.isfinite(res.final_loss)
        wc = mv.session().tables[2].get([0])[0]
        print(f"RANK{rank}_SSPUNEQ_OK words={res.words_trained} wc={wc}",
              flush=True)
        mv.shutdown()
    """, extra_env={"MV_TEST_CORPUS": str(corpus)})
    assert_ok(procs, outs, "SSPUNEQ")
    words = [int(o.split("words=")[1].split()[0]) for o in outs]
    total = sum(len(line.split()) for line in open(corpus))
    assert words[0] != words[1] and sum(words) == 2 * total, words
    # the word-count table is merged across processes by the bus
    assert all(f"wc={2.0 * total}" in o for o in outs), outs


def test_failure_detector_flags_dead_peer(tmp_path):
    """A process that vanishes without shutdown is named dead by its peer
    within the heartbeat timeout; a peer that stopped cleanly is not."""
    procs, outs = run_group(tmp_path, """
        from multiverso_tpu_torch.parallel import FailureDetector
        mv.init(["hb", "-sync=false", "-device=cpu"])
        det = FailureDetector(interval_s=0.2)
        mv.barrier()
        if rank == 1:
            print("RANK1_HB_DIES", flush=True)
            os._exit(0)                 # a crash: the heartbeat stops
        deadline = time.monotonic() + 30
        dead = []
        while time.monotonic() < deadline and not dead:
            dead = det.dead_peers(timeout_s=1.5)
            time.sleep(0.2)
        assert dead == [1], dead
        det.stop()
        print("RANK0_HB_OK", flush=True)
        os._exit(0)     # the peer is gone: a collective shutdown would hang
    """)
    assert "RANK1_HB_DIES" in outs[1]
    assert_ok(procs, outs, "HB", ranks=[0])


def test_three_process_sigkill_survivors_converge(tmp_path):
    """Survivor mode (-failure_timeout_s=3): rank 2 of 3 is SIGKILLed
    mid-training; the survivors declare it dead, drop it from the ack
    quorum and the drain, keep training, hold each other's every delta
    (their own row blocks exact), at most what the dead rank published of
    its block, and both end with exit code 0 (rank 0 hosts the store)."""
    procs, outs = run_group(tmp_path, """
        import signal
        mv.init(["w", "-sync=false", "-failure_timeout_s=3", "-device=cpu",
                 "-log_level=error"])
        N, iters, kill_at = 8, 24, 5
        t = mv.create_table("matrix", 3 * N, 4)
        t0 = time.monotonic()
        for i in range(iters):
            delta = np.zeros((3 * N, 4), np.float32)
            delta[rank * N:(rank + 1) * N] = 1.0
            t.add(delta)
            if rank == 2 and i == kill_at:
                os.kill(os.getpid(), signal.SIGKILL)
            time.sleep(0.25)
        mv.barrier()          # the survivors' drain: a live-set rendezvous
        got = t.get()
        for r in (0, 1):
            assert np.all(got[r * N:(r + 1) * N] == iters), (r, got)
        dead = got[2 * N:3 * N]
        assert dead.max() <= kill_at + 1, dead.max()
        assert mv.session().async_bus._dead == {2}
        print(f"RANK{rank}_SURVIVOR_OK dead_rows={dead.max():.0f}",
              flush=True)
        mv.shutdown()
    """, n=3)
    assert procs[2].returncode == -9, outs[2][-2000:]
    assert_ok(procs, outs, "SURVIVOR", ranks=[0, 1])


def test_explicit_net_bind_connect(tmp_path):
    """net_bind/net_connect instead of the environment: rank 0's endpoint
    hosts the store, the group forms, a sync add sums."""
    endpoints = f"127.0.0.1:{_free_port()},127.0.0.1:{_free_port()}"
    procs, outs = run_group(tmp_path, """
        endpoints = os.environ["NET_ENDPOINTS"].split(",")
        mv.net_bind(rank, endpoints[rank])
        mv.net_connect(list(range(len(endpoints))), endpoints)
        mv.init(["netapi", "-sync=true", "-device=cpu"])
        assert mv.size() == 2 and mv.rank() == rank
        t = mv.create_table("array", 8)
        t.add(np.full(8, 1.0, np.float32))
        assert np.all(t.get() == 2.0)
        mv.barrier()
        mv.shutdown()
        print(f"RANK{rank}_NET_OK", flush=True)
    """, extra_env={"NET_ENDPOINTS": endpoints}, env_group=False)
    assert_ok(procs, outs, "NET")


def test_two_process_async_word2vec_learns(tmp_path):
    """Two async processes train disjoint shards of a clustered corpus
    (the JAX test's corpus and config) and must recover the clusters:
    nearest-neighbour purity at least 0.8 and a gap over 0.1; after the
    final drain the replicas agree within rtol 1e-4 and atol 1e-5 (a
    dropped bus would leave each with its own shard's movement only)."""
    sys.path.insert(0, REPO)
    from tools.embedding_quality import (load_vectors,
                                         make_clustered_corpus, probe)

    corpus = tmp_path / "clustered.txt"
    labels = make_clustered_corpus(str(corpus), n_clusters=4,
                                   words_per_cluster=15, n_stop=5,
                                   n_sentences=4000, sent_len=10)
    procs, outs = run_group(tmp_path, """
        from multiverso_tpu_torch.apps.wordembedding import (
            Dictionary, save_embeddings, train)
        from multiverso_tpu_torch.models.word2vec import Word2VecConfig
        out_dir, corpus = os.environ["MV_TEST_OUT"], os.environ["MV_TEST_CORPUS"]
        mv.init(["w2vq", "-sync=false", "-device=cpu", "-log_level=error"])
        d = Dictionary.build(corpus, min_count=1)
        cfg = Word2VecConfig(embedding_size=16, window=3, negative=3,
                             batch_size=512, init_lr=0.08, seed=3)
        res = train(corpus, cfg=cfg, epochs=3, min_count=1, sample=0,
                    dictionary=d, device_corpus=False, log_every=0,
                    output_path=os.path.join(out_dir, "q.vec"))
        assert np.isfinite(res.final_loss)
        np.save(os.path.join(out_dir, f"qw_{rank}.npy"),
                mv.session().tables[0].get())
        mv.barrier()
        mv.shutdown()
        print(f"RANK{rank}_W2VQ_OK", flush=True)
    """, extra_env={"MV_TEST_CORPUS": str(corpus)})
    assert_ok(procs, outs, "W2VQ")
    words, vecs = load_vectors(str(tmp_path / "q.vec"))
    purity, gap = probe(words, vecs, labels)
    assert purity >= 0.8, (purity, gap)
    assert gap > 0.1, (purity, gap)
    w0 = np.load(tmp_path / "qw_0.npy")
    w1 = np.load(tmp_path / "qw_1.npy")
    np.testing.assert_allclose(w0, w1, rtol=1e-4, atol=1e-5)
