"""The port's paged-KV block allocator against the JAX package's.

One seeded random sequence of alloc / free / decref / register / lookup /
peek / flush drives a JAX ``BlockPool`` and the port's side by side: every
call returns the same block ids and the same value, and after every call
the two give the same ``stats()`` and ``drift()`` verdict, also after the
same corruption of both books. ``chain_hashes`` gives byte-identical
digests. Then the JAX file's own cases run on the port's class: ids and
guards, sizing, the churn properties, refcounts and the cached tier, LRU
eviction, tail-first release, and the Dashboard instruments.
"""

import numpy as np
import pytest

from multiverso_tpu.serving import block_pool as jbp
from multiverso_tpu_torch.dashboard import Dashboard
from multiverso_tpu_torch.serving import block_pool as tbp


def _pool(n=16, bs=4, name=""):
    return tbp.BlockPool(n, bs, name=name)


@pytest.mark.parametrize("seed", [b"", b"0", b"7"])
def test_chain_hashes_byte_identical(seed):
    rng = np.random.default_rng(len(seed))
    for bs in (1, 4, 16):
        for n in (0, 3, 16, 37, 512):
            toks = rng.integers(0, 70000, n)
            assert tbp.chain_hashes(toks, bs, seed) == \
                jbp.chain_hashes(toks, bs, seed)
            assert tbp.chain_hashes(toks.tolist(), bs, seed) == \
                jbp.chain_hashes(toks.astype(np.int32), bs, seed)


def test_sizing_helpers_match_jax():
    for L, D, bs in ((2, 32, 4), (12, 768, 16)):
        per = tbp.kv_bytes_per_block(L, D, bs)
        assert per == jbp.kv_bytes_per_block(L, D, bs)
        assert tbp.kv_bytes_per_block(L, D, bs, np.float16) == \
            jbp.kv_bytes_per_block(L, D, bs, np.float16)
        for budget in (2 * per, 5 * per + 3, 801 * per):
            assert tbp.blocks_for_bytes(budget, L, D, bs) == \
                jbp.blocks_for_bytes(budget, L, D, bs)


def test_twin_pools_agree_on_a_random_sequence():
    rng = np.random.default_rng(11)
    n, bs = 12, 4
    jp, tp = jbp.BlockPool(n, bs, name="twin_j"), tbp.BlockPool(
        n, bs, name="twin_t")
    chains = [jbp.chain_hashes(rng.integers(1, 9, 12), bs, b"3")
              for _ in range(5)]
    held = []                          # block lists, one per holder

    def both(name, *args):
        try:
            want = getattr(jp, name)(*args)
        except RuntimeError as exc:
            with pytest.raises(RuntimeError):
                getattr(tp, name)(*args)
            return exc
        got = getattr(tp, name)(*args)
        assert got == want, (name, args, got, want)
        return want

    for step in range(700):
        op = rng.random()
        if op < 0.25:
            k = int(rng.integers(1, 5))
            got = both("alloc", k)
            if isinstance(got, list):
                held.append(got)
        elif op < 0.35 and held:
            blocks = held[int(rng.integers(0, len(held)))]
            chain = chains[int(rng.integers(0, len(chains)))]
            for b, h in zip(blocks, chain):
                both("register", b, h)
        elif op < 0.5:
            chain = chains[int(rng.integers(0, len(chains)))]
            got = both("lookup", chain)
            if got:
                held.append(got)
            both("peek_counts", chain)
        elif op < 0.75 and held:
            blocks = held.pop(int(rng.integers(0, len(held))))
            both("decref", list(reversed(blocks)))
        elif op < 0.78 and held:
            # the strict free: refused for a shared or cached block
            both("free", held.pop(int(rng.integers(0, len(held)))))
        elif op < 0.85:
            both("flush_cache")
        else:
            both("can_alloc", int(rng.integers(1, n + 2)))
        assert tp.stats() == jp.stats(), step
        assert tp.drift() == jp.drift() is None
    # the same corruption of both books gives the same verdict
    for pool in (jp, tp):
        pool._free.append(pool._free[0] if pool._free else 1)
    assert tp.drift() == jp.drift() is not None
    for pool in (jp, tp):
        pool._free.pop()
        pool._n_shared += 1
    assert tp.drift() == jp.drift() is not None


def test_alloc_free_roundtrip_and_ids():
    pool = _pool(n=8)
    got = pool.alloc(8)
    assert sorted(got) == list(range(1, 9))      # 0 is scratch, never issued
    assert tbp.SCRATCH_BLOCK not in got
    assert pool.n_free == 0 and pool.n_live == 8
    pool.free(got)
    assert pool.n_free == 8 and pool.n_live == 0
    pool.check()


def test_over_alloc_and_double_free_raise():
    pool = _pool(n=4)
    blocks = pool.alloc(3)
    assert not pool.can_alloc(2)
    with pytest.raises(RuntimeError):
        pool.alloc(2)
    pool.check()                                 # failed alloc took nothing
    pool.free(blocks[:1])
    with pytest.raises(RuntimeError):
        pool.free(blocks[:1])                    # double-free
    with pytest.raises(RuntimeError):
        pool.free([0])                           # scratch was never live
    pool.check()


def test_sizing_helpers():
    pool = _pool(n=16, bs=4)
    assert pool.blocks_needed(1) == 1
    assert pool.blocks_needed(4) == 1
    assert pool.blocks_needed(5) == 2
    assert pool.covers(64) and not pool.covers(65)
    per = tbp.kv_bytes_per_block(n_layers=2, d_model=32, block_size=4)
    assert per == 2 * 2 * 4 * 32 * 4             # K+V, f32
    import torch

    assert tbp.kv_bytes_per_block(2, 32, 4, torch.bfloat16) == per // 2
    assert tbp.blocks_for_bytes(5 * per, 2, 32, 4) == 4
    with pytest.raises(ValueError):
        tbp.blocks_for_bytes(per - 1, 2, 32, 4)
    with pytest.raises(ValueError):
        tbp.blocks_for_bytes(2 * per - 1, 2, 32, 4)


def test_property_randomized_churn_no_leak_no_double_alloc():
    rng = np.random.default_rng(0)
    pool = _pool(n=24)
    live: dict = {}
    next_seq = 0
    for _ in range(500):
        if live and (rng.random() < 0.45 or not pool.can_alloc(1)):
            seq = list(live)[int(rng.integers(0, len(live)))]
            pool.free(live.pop(seq))
        else:
            n = int(rng.integers(1, 6))
            if not pool.can_alloc(n):
                with pytest.raises(RuntimeError):
                    pool.alloc(n)
                continue
            blocks = pool.alloc(n)
            assert len(set(blocks)) == n
            for held in live.values():           # no double-allocation
                assert not set(blocks) & set(held)
            live[next_seq] = blocks
            next_seq += 1
        pool.check()
        assert pool.n_live == sum(len(b) for b in live.values())
    for blocks in live.values():
        pool.free(blocks)
    pool.check()
    assert pool.n_free == pool.capacity
    assert pool.allocs == pool.frees


def test_occupancy_metrics_registered():
    Dashboard.reset()
    pool = _pool(n=6, name="t_bp")
    blocks = pool.alloc(4)
    assert Dashboard.stats("KV_BLOCKS_FREE[t_bp]") == {"value": 2.0}
    assert Dashboard.stats("KV_BLOCKS_LIVE[t_bp]") == {"value": 4.0}
    pool.free(blocks[:1])
    assert Dashboard.stats("KV_BLOCKS_LIVE[t_bp]") == {"value": 3.0}
    assert Dashboard.stats("BLOCK_ALLOC[t_bp]") == {"value": 4}
    assert Dashboard.stats("BLOCK_FREE[t_bp]") == {"value": 1}


def test_chain_hashes_prefix_identity_and_divergence():
    a = tbp.chain_hashes([1, 2, 3, 4, 5, 6, 7, 8, 9], 4)
    assert len(a) == 2                            # trailing partial: no id
    b = tbp.chain_hashes([1, 2, 3, 4, 5, 6, 7, 8], 4)
    assert a == tbp.chain_hashes(np.array([1, 2, 3, 4, 5, 6, 7, 8]), 4)
    assert a[0] == b[0] and a[1] == b[1]
    c = tbp.chain_hashes([1, 2, 3, 99, 5, 6, 7, 8], 4)
    assert c[0] != a[0] and c[1] != a[1]
    assert tbp.chain_hashes([1, 2, 3, 4], 4, seed=b"v1") != \
        tbp.chain_hashes([1, 2, 3, 4], 4, seed=b"v2")
    assert tbp.chain_hashes([1, 2, 3], 4) == []


def test_refcount_share_decref_and_cached_reactivation():
    pool = _pool(n=4, bs=4, name="t_rc")
    h = tbp.chain_hashes([1, 2, 3, 4], 4)
    (b0,) = pool.alloc(1)
    assert pool.register(b0, h[0]) is True
    assert pool.register(b0, h[0]) is False       # identical content: no-op
    assert pool.lookup(h) == [b0]                 # live block gains a holder
    assert pool.n_shared == 1
    with pytest.raises(RuntimeError):
        pool.free([b0])                           # shared: free() refuses
    pool.decref([b0])
    assert pool.n_shared == 0 and pool.n_live == 1
    pool.decref([b0])                             # last holder out -> cached
    assert pool.n_live == 0 and pool.n_cached == 1 and pool.n_free == 3
    pool.check()
    assert pool.lookup(h) == [b0]                 # the same block returns
    assert pool.n_cached == 0 and pool.n_live == 1
    with pytest.raises(RuntimeError):
        pool.decref([99])                         # foreign id
    pool.decref([b0])
    with pytest.raises(RuntimeError):
        pool.decref([b0])                         # double-decref (cached now)
    assert pool.stats()["prefix_hits"] == 2
    pool.check()


def test_eviction_is_lru_and_flush_clears_identity():
    pool = _pool(n=3, bs=2, name="t_ev")
    hs = tbp.chain_hashes([1, 2, 3, 4, 5, 6], 2)
    blocks = pool.alloc(3)
    for b, h in zip(blocks, hs):
        pool.register(b, h)
    pool.decref([blocks[1]])
    pool.decref([blocks[0]])
    pool.decref([blocks[2]])
    assert pool.n_cached == 3 and pool.n_free == 0
    assert pool.can_alloc(2)                      # cached IS reclaimable
    got = pool.alloc(2)                           # evicts blocks[1], [0]
    assert pool.evictions == 2
    assert pool.peek(hs) == 0
    assert pool.peek(hs[2:]) == 1                 # blocks[2] survived (MRU)
    pool.decref(got)                  # unregistered: straight back to free
    assert pool.n_cached == 1
    assert pool.flush_cache() == 1
    assert pool.n_cached == 0 and pool.n_free == 3
    assert pool.peek(hs) == 0
    pool.check()


def test_release_order_evicts_chain_tail_first():
    """The engine releases a sequence's blocks tail first, so pressure
    shrinks a cached chain from its end and its head keeps hitting."""
    pool = tbp.BlockPool(4, 2, name="t_tail")
    hs = tbp.chain_hashes([1, 2, 3, 4, 5, 6], 2)
    blocks = pool.alloc(3)
    for b, h in zip(blocks, hs):
        pool.register(b, h)
    pool.decref(reversed(blocks))
    assert pool.can_alloc(2)
    pool.alloc(2)                    # free list held 1: evicts ONE block
    assert pool.evictions == 1
    assert pool.peek(hs) == 2
    pool.alloc(1)
    assert pool.peek(hs) == 1
    pool.check()


def test_property_refcount_churn_never_leaks_or_double_frees():
    rng = np.random.default_rng(2)
    pool = _pool(n=16, bs=4, name="t_pc_churn")
    seqs: dict = {}
    next_seq = 0
    identities = [tbp.chain_hashes(rng.integers(1, 9, 8).tolist(), 4)
                  for _ in range(6)]
    for _ in range(600):
        op = rng.random()
        if op < 0.35 and pool.can_alloc(2):
            blocks = pool.alloc(2)
            chain = identities[int(rng.integers(0, len(identities)))]
            for b, h in zip(blocks, chain):
                pool.register(b, h)
            seqs[next_seq] = blocks
            next_seq += 1
        elif op < 0.55:
            chain = identities[int(rng.integers(0, len(identities)))]
            matched = pool.lookup(chain)
            if matched:
                seqs[next_seq] = matched
                next_seq += 1
        elif op < 0.9 and seqs:
            k = list(seqs)[int(rng.integers(0, len(seqs)))]
            pool.decref(seqs.pop(k))
        elif op < 0.95:
            pool.flush_cache()
        elif not pool.can_alloc(2):
            with pytest.raises(RuntimeError):
                pool.alloc(pool.capacity + 1)
        assert pool.drift() is None, pool.drift()
        held = sum(len(b) for b in seqs.values())
        assert pool.n_live <= held
        assert pool.n_live + pool.n_free + pool.n_cached == pool.capacity
    for blocks in seqs.values():
        pool.decref(blocks)
    pool.flush_cache()
    pool.check()
    assert pool.n_free == pool.capacity
    assert pool.allocs == pool.frees


def test_prefix_metrics_registered():
    Dashboard.reset()
    pool = _pool(n=4, bs=2, name="t_pm")
    hs = tbp.chain_hashes([5, 6, 7, 8], 2)
    blocks = pool.alloc(2)
    for b, h in zip(blocks, hs):
        pool.register(b, h)
    pool.lookup(hs)
    assert Dashboard.stats("KV_BLOCKS_SHARED[t_pm]") == {"value": 2.0}
    assert Dashboard.stats("PREFIX_HITS[t_pm]") == {"value": 2}
    pool.lookup(tbp.chain_hashes([9, 9, 9, 9], 2))
    assert Dashboard.stats("PREFIX_MISSES[t_pm]") == {"value": 2}
    pool.decref(blocks)
    pool.decref(blocks)
    pool.alloc(4)
    assert Dashboard.stats("PREFIX_EVICTIONS[t_pm]") == {"value": 2}
    assert Dashboard.stats("KV_BLOCKS_SHARED[t_pm]") == {"value": 0.0}
    pool.check()
