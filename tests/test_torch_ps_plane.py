"""The parameter server's control plane, and the port's group against the
JAX package's on the same deltas.

Unit tests run in one process over an in-process ``TCPStore``: the KV
client (``topology.StoreKV``, the JAX coordination client's method names),
``parallel.SSPClock`` and ``parallel.FailureDetector`` (two fake sessions
on two threads, each with its own client). The parity test runs one
seeded scenario (deltas made with numpy from a seed) as a 2-process JAX
group and as a 2-process port group, each in sync mode and then in async
mode: the final tables, the aggregate and the KV table must be bitwise
equal across the packages and across the replicas (async on the exact
grid: small dyadic values, whose sums any order gives the same bits).
"""

import os
import socket
import subprocess
import sys
import textwrap
import threading
import time
from datetime import timedelta

import numpy as np
import pytest
import torch.distributed as dist

from multiverso_tpu_torch.topology import StoreKV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def store():
    return dist.TCPStore("127.0.0.1", 0, world_size=1, is_master=True,
                         timeout=timedelta(seconds=30),
                         wait_for_workers=False)


class _Session:
    """What SSPClock and FailureDetector read of a session."""

    def __init__(self, client):
        self.started = True
        self.rank, self.size, self.client = client.rank, client.size, client


def test_store_kv_client_calls(store):
    kv = StoreKV(store, 0, 2)
    kv.key_value_set("a", "1")
    kv.key_value_set("a", "2", allow_overwrite=True)
    assert kv.key_value_try_get("a") == "2"
    assert kv.blocking_key_value_get("a", 100) == "2"
    kv.key_value_set_bytes("b", b"\x00\xff")
    assert kv.blocking_key_value_get_bytes("b", 100) == b"\x00\xff"
    with pytest.raises(KeyError, match="NOT_FOUND"):
        kv.key_value_try_get("nope")
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="DEADLINE_EXCEEDED"):
        kv.blocking_key_value_get("nope", 150)
    assert 0.14 < time.monotonic() - t0 < 5
    assert kv.key_value_increment("n", 0) == 0
    assert kv.key_value_increment("n", 3) == 3
    assert kv.key_value_try_get("n") == "3"    # counters read as text
    # a blocking get returns once another thread sets the key
    threading.Timer(0.1, kv.key_value_set, ("late", "x")).start()
    assert kv.blocking_key_value_get("late", 5000) == "x"
    # delete removes the one key, not the keys below it
    kv.key_value_set("d", "1")
    kv.key_value_set("d/a", "1")
    kv.key_value_delete("d")
    with pytest.raises(KeyError):
        kv.key_value_try_get("d")
    assert kv.key_value_try_get("d/a") == "1"


def test_store_kv_barrier(store):
    clients = [StoreKV(store, r, 3) for r in range(3)]
    done = []

    def arrive(c, participants):
        c.wait_at_barrier("b1", 5000, participants)
        done.append(c.rank)

    threads = [threading.Thread(target=arrive, args=(c, [0, 2]))
               for c in (clients[0], clients[2])]
    threads[0].start()
    time.sleep(0.1)
    assert done == []          # rank 0 waits for rank 2
    threads[1].start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert sorted(done) == [0, 2]
    # a wait that runs out raises, naming the missing rank; its arrival
    # stays, so the late rank passes at once
    with pytest.raises(TimeoutError, match=r"missing rank\(s\) \[1\]"):
        clients[0].wait_at_barrier("b2", 100, [0, 1])
    clients[1].wait_at_barrier("b2", 100, [0, 1])


def test_ssp_clock_gates_the_fast_worker(store):
    from multiverso_tpu_torch.parallel import SSPClock

    sessions = [_Session(StoreKV(store, r, 2)) for r in range(2)]
    fast, slow = (SSPClock(staleness=1, poll_s=0.005, session=s)
                  for s in sessions)
    fast.wait()
    fast.tick()                # round 1: one ahead of the slow worker
    fast.wait()                # allowed: 1 - 0 <= staleness
    fast.tick()                # round 2
    released = threading.Event()

    def gated():
        fast.wait()
        released.set()

    th = threading.Thread(target=gated)
    th.start()
    assert not released.wait(0.3)       # 2 - 0 > staleness: blocked
    slow.wait()
    slow.tick()
    assert released.wait(5)             # 2 - 1 <= staleness
    th.join(timeout=5)
    for _ in range(5):
        fast.tick()
    fast.finish()
    for _ in range(10):                 # the finished peer never gates
        slow.wait(timeout_s=1)
        slow.tick()
    # a second clock in the same group reads fresh rounds
    again = [SSPClock(staleness=0, poll_s=0.005, session=s)
             for s in sessions]
    assert again[0]._gen == again[1]._gen == 2
    again[0].wait(timeout_s=1)


def test_failure_detector_names_the_silent_peer(store):
    from multiverso_tpu_torch.parallel import FailureDetector

    sessions = [_Session(StoreKV(store, r, 3)) for r in range(3)]
    dets = [FailureDetector(interval_s=0.05, session=s) for s in sessions]
    fired = []
    dets[0].start_watchdog(1.0, fired.append)
    time.sleep(0.3)
    assert dets[0].dead_peers(1.0) == []
    dets[2]._stop.set()                 # a crash: rank 2's beat stops
    dets[1].stop()                      # a clean exit: never named
    deadline = time.monotonic() + 10
    while not fired and time.monotonic() < deadline:
        time.sleep(0.05)
    assert fired == [[2]]
    time.sleep(0.5)
    assert fired == [[2]]               # reported once
    dets[0].stop()


_PARITY = textwrap.dedent("""
    import os, sys
    import numpy as np
    sys.path.insert(0, %(repo)r)
    if os.environ["PKG"] == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import multiverso_tpu as mv
        dev = []
    else:
        import multiverso_tpu_torch as mv
        dev = ["-device=cpu"]
    rank = int(os.environ["MV_PROCESS_ID"])
    out = {}

    def vals(rng, shape, grid):
        if grid:   # dyadic: every sum exact in any order
            return (rng.integers(-64, 65, shape) / 256.0).astype(np.float32)
        return rng.standard_normal(shape).astype(np.float32)

    for mode in ("sync", "async"):
        grid = mode == "async"
        mv.init(["parity", f"-sync={str(mode == 'sync').lower()}",
                 "-log_level=error", *dev])
        assert mv.size() == 2 and mv.rank() == rank
        rng = np.random.default_rng(1000 + rank)
        out[mode + "_agg"] = mv.aggregate(
            rng.standard_normal(32).astype(np.float32))
        a = mv.create_table("array", 64)
        m = mv.create_table("matrix", 16, 4)
        s = mv.create_table("sparse", 32)
        d = mv.create_table("array", 8, dtype=np.float64)
        kv = mv.create_table("kv")
        for i in range(3):
            a.add(vals(rng, 64, grid))
            ids = rng.integers(0, 16, 12).astype(np.int32)
            m.add_rows(ids, vals(rng, (12, 4), grid))
            s.add_keys(rng.integers(0, 32, 6), vals(rng, 6, grid))
            kv.add(rng.integers(0, 5, 3).tolist(), (rng.integers(1, 9, 3)
                                                    / 8.0).tolist())
        dense = vals(rng, (16, 4), grid)
        dense[rng.integers(0, 16, 8)] = 0.0     # rows left untouched
        m.add(dense)
        d.add(np.full(8, 0.1234567890123456 * (rank + 1)))
        if mode == "sync":
            kv.sync()
        mv.barrier()
        out[mode + "_array"] = np.asarray(a.get(), np.float32)
        out[mode + "_matrix"] = np.asarray(m.get(), np.float32)
        out[mode + "_sparse"] = np.asarray(s.get(), np.float32)
        out[mode + "_f64"] = np.asarray(d.get())
        out[mode + "_kv"] = np.array(kv.get(range(5)), np.float64)
        mv.barrier()
        mv.shutdown()
    np.savez(os.path.join(os.environ["OUT"], os.environ["PKG"] +
                          f"_{rank}.npz"), **out)
    print(f"RANK{rank}_PARITY_OK", flush=True)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(tmp_path, pkg: str):
    script = tmp_path / "parity.py"
    script.write_text(_PARITY % {"repo": REPO})
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("MV_") and k != "PYTHONPATH"}
        env.update({"MV_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                    "MV_NUM_PROCESSES": "2", "MV_PROCESS_ID": str(rank),
                    "PKG": pkg, "OUT": str(tmp_path), "JAX_PLATFORMS": "cpu",
                    "OMP_NUM_THREADS": "1",
                    "XLA_FLAGS": "--xla_force_host_platform_device_count=1"})
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def test_two_process_groups_match_the_jax_package(tmp_path):
    groups = {pkg: _run_pair(tmp_path, pkg) for pkg in ("jax", "torch")}
    for pkg, procs in groups.items():
        for rank, proc in enumerate(procs):
            try:
                out, _ = proc.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                for p in sum(groups.values(), []):
                    p.kill()
                pytest.fail(f"{pkg} rank {rank} timed out")
            assert proc.returncode == 0, f"{pkg} rank {rank}:\n{out[-3000:]}"
            assert f"RANK{rank}_PARITY_OK" in out
    res = {(pkg, r): dict(np.load(tmp_path / f"{pkg}_{r}.npz"))
           for pkg in ("jax", "torch") for r in range(2)}
    keys = sorted(res[("jax", 0)])
    assert len(keys) == 12
    for key in keys:
        want = res[("jax", 0)][key]
        for who in (("jax", 1), ("torch", 0), ("torch", 1)):
            got = res[who][key]
            assert got.dtype == want.dtype, (key, who)
            np.testing.assert_array_equal(got, want, err_msg=f"{key} {who}")
    # the scenario moved every table (a dropped add would show above)
    assert np.abs(res[("torch", 0)]["async_matrix"]).sum() > 0
    assert res[("torch", 0)]["sync_kv"].sum() > 0
