"""Sequence-parallel attention and the collectives across real processes.

The port's ``ops.ring_attention`` (both impls, forward and grads),
``ops.ulysses_attention``, ``parallel.collectives`` and
``parallel.allreduce_engine`` run in groups of 2, 3 and 4 fresh
interpreters on the CPU (gloo), and ``KVTable.sync`` in a group of 2;
each result is held against the JAX function on the conftest's virtual
CPU mesh of the same size (the Pallas impl in interpret mode), on the
same inputs made with numpy from a seed.

Every test that forms a group is in this file, so that under
``--dist loadfile`` the groups run one after another on one worker.
Each group size is spawned once, by a module-scoped fixture: its
processes run every case and save the results, and each case is its own
test that reads them. A case that raises in the group fails only its
own test.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from test_torch_multiprocess import run_group

from multiverso_tpu._compat import shard_map
from multiverso_tpu.ops import (reference_attention as jax_reference,
                                ring_attention as jax_ring,
                                ulysses_attention as jax_ulysses)
from multiverso_tpu.parallel import collectives as jax_collectives
from multiverso_tpu.parallel.allreduce_engine import \
    AllreduceEngine as JaxEngine
from multiverso_tpu.topology import SEQ_AXIS, WORKER_AXIS, make_mesh

SIZES = (2, 3, 4)
# the JAX tests' tolerances: tests/test_ops.py:43 (the xla ring),
# tests/test_flash_attention.py:142-190 (the Pallas ring, its grads and
# the kernel-dispatched Ulysses), tests/test_ulysses.py:21-60
RING_XLA_TOL = 2e-5
RING_GRAD_TOL = 1e-4        # f32 grads (tests/test_flash_attention.py)
RING_PALLAS_TOL = 1e-3
ULYSSES_RTOL, ULYSSES_ATOL, ULYSSES_GRAD_TOL = 1e-4, 1e-5, 1e-4
ENGINE_TOL = 1e-4           # tests/test_allreduce_engine.py
# per-shard rows above the Pallas kernels' block_k (1024): the JAX
# kernels take several key blocks, the port's card kernels K4 and K6+K7
LONG_BLOCK = 1152


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _inputs(n: int) -> dict:
    """Every case's global inputs for a group of ``n``, from seeds."""
    rng = np.random.default_rng(100 + n)
    x = {}
    for name, shape in (("x", (16 * n, 2, 8)),          # the xla ring
                        ("p", (16 * n, 2, 16)),         # the Pallas ring
                        ("u", (16 * n, 2 * n, 16)),     # Ulysses
                        ("h", (8 * n, n + 1, 8))):      # heads error
        for part in "qkv":
            x[f"{name}{part}"] = _normal(rng, shape)
    if n == 2:
        for part in "qkv":
            x[f"l{part}"] = _normal(rng, (LONG_BLOCK * n, 1, 16))
    x["c"] = _normal(rng, (3 * n, 5))                   # shards of 3 rows
    x["rep"] = _normal(rng, (4, 3))                     # one replicated
    x["rs"] = _normal(rng, (n, 4 * n, 2))               # row r: rank r's
    x["a2a"] = _normal(rng, (4 * n, 2 * n, 3))          # all_to_all
    x["eag"] = _normal(rng, (3 * n, 2))                 # engine allgather
    x["ers"] = _normal(rng, (n, 4 * n))                 # engine RS
    x["ebig"] = _normal(rng, (n, n * 512))              # over 4 KB
    x["esmall"] = _normal(rng, (n, 8))                  # under 4 KB
    x["emd"] = _normal(rng, (n, 3, 512))                # 3 doesn't divide
    x["end"] = _normal(rng, (n, n * 512 + 3))           # count doesn't
    return x


_CHILD = """
    os.nice(10)
    import json, traceback
    import torch
    out_dir = os.environ["MV_TEST_OUT"]
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    mv.init(["seqpar", "-sync=true", "-device=cpu", "-log_level=error"])
    from multiverso_tpu_torch.ops import ring_attention, ulysses_attention
    from multiverso_tpu_torch.parallel import AllreduceEngine
    from multiverso_tpu_torch.parallel import collectives as C
    n = mv.size()
    res, errors = {}, {}

    def row(name):
        return torch.from_numpy(inp[name][rank]).clone()

    def shard(name):
        x = torch.from_numpy(inp[name])
        b = x.shape[0] // n
        return x[rank * b:(rank + 1) * b].clone()

    def case(name, fn):
        try:
            for key, val in fn().items():
                res[f"{name}/{key}"] = np.asarray(val)
        except Exception:
            errors[name] = traceback.format_exc()

    def attn(fn, prefix, causal, grads, **kw):
        def run():
            q, k, v = (shard(prefix + p).requires_grad_(grads)
                       for p in "qkv")
            out = fn(q, k, v, causal=causal, **kw)
            r = {"out": out.detach().numpy()}
            if grads:
                g = torch.autograd.grad((out ** 2).sum(), (q, k, v))
                r.update(dq=g[0].numpy(), dk=g[1].numpy(),
                         dv=g[2].numpy())
            return r
        return run

    for causal in (False, True):
        case(f"ring_xla_{causal:d}", attn(ring_attention, "x", causal, True,
                                          impl="xla"))
        if n != 3:
            case(f"ring_pallas_{causal:d}", attn(ring_attention, "p", causal,
                                                 True, impl="pallas"))
            case(f"ulysses_{causal:d}", attn(ulysses_attention, "u", causal,
                                             True))
    if n != 3:
        case("ulysses_flash", attn(ulysses_attention, "u", True, True,
                                   impl="flash", min_flash_seq=1))
    if n == 2:
        case("ring_long", attn(ring_attention, "l", True, True,
                               impl="pallas"))

    def heads_error():
        try:
            attn(ulysses_attention, "h", False, False)()
        except ValueError as exc:
            return {"error": str(exc)}
        return {}
    case("ulysses_heads", heads_error)

    bf16 = lambda t: t.to(torch.bfloat16).view(torch.int16).numpy()
    case("allreduce", lambda: {"sum": C.allreduce(shard("c")).numpy(),
                               "mean": C.allreduce(shard("c"),
                                                   mean=True).numpy()})
    case("allreduce_replicated", lambda: {
        "sum": C.allreduce_replicated(torch.from_numpy(inp["rep"])).numpy()})
    case("all_gather", lambda: {
        "f32": C.all_gather(shard("c")).numpy(),
        "bf16": bf16(C.all_gather(shard("c").to(torch.bfloat16)))})
    case("reduce_scatter", lambda: {
        "out": C.reduce_scatter(row("rs")).numpy()})
    case("ring_shift", lambda: {
        f"s{s}": C.ring_shift(shard("c"), shift=s).numpy()
        for s in (1, -1, 2)})
    case("all_to_all", lambda: {
        "out": C.all_to_all(shard("a2a"), 1, 0).numpy()})
    eng = AllreduceEngine()
    case("engine_allgather", lambda: {
        "out": eng.allgather(shard("eag")).numpy()})
    case("engine_reduce_scatter", lambda: {
        "out": eng.reduce_scatter(row("ers")).numpy()})
    for name in ("ebig", "esmall", "emd", "end"):
        case(f"engine_allreduce_{name}", lambda: {
            "out": eng.allreduce(row(name)).numpy()})

    if n == 2:
        def kv_sync(dtype, value):
            def run():
                kv = mv.create_table("kv", value_dtype=dtype)
                if rank == 1:
                    kv.add([7], [value])
                kv.sync()
                got = kv.get([7])[0]
                return {"value": float(got), "type": type(got).__name__}
            return run
        case("kv_float32", kv_sync(np.float32, 0.1))
        case("kv_int64", kv_sync(np.int64, 3))

    mv.shutdown()
    np.savez(os.path.join(out_dir, f"res_{rank}.npz"), **res)
    with open(os.path.join(out_dir, f"errors_{rank}.json"), "w") as f:
        json.dump(errors, f)
    print(f"RANK{rank}_SEQPAR_OK", flush=True)
"""


class GroupResults:
    """One group's saved results: ``get(case)`` gives each rank's arrays
    by key, and fails the test with the group's traceback where the case
    raised."""

    def __init__(self, n: int, out_dir, procs, outs) -> None:
        self.n = n
        self.inputs = _inputs(n)
        for rank, (proc, out) in enumerate(zip(procs, outs)):
            assert proc.returncode == 0 and f"RANK{rank}_SEQPAR_OK" in out, \
                f"rank {rank}:\n{out[-3000:]}"
        self.res, self.errors = [], []
        for rank in range(n):
            with np.load(out_dir / f"res_{rank}.npz") as f:
                self.res.append(dict(f))
            self.errors.append(json.loads(
                (out_dir / f"errors_{rank}.json").read_text()))

    def get(self, case: str) -> list:
        for rank, errors in enumerate(self.errors):
            assert case not in errors, f"rank {rank}: {errors[case]}"
        out = [{k.split("/", 1)[1]: v for k, v in r.items()
                if k.startswith(case + "/")} for r in self.res]
        assert out[0], f"case {case} left no result"
        return out

    def gathered(self, case: str, key: str) -> np.ndarray:
        """Every rank's ``key`` concatenated along dim 0 in rank order."""
        return np.concatenate([r[key] for r in self.get(case)])


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Each group size spawned once (at first use), at most 120 s."""
    cache = {}

    def get(n: int) -> GroupResults:
        if n not in cache:
            out_dir = tmp_path_factory.mktemp(f"seqpar{n}")
            np.savez(out_dir / "inputs.npz", **_inputs(n))
            procs, outs = run_group(out_dir, _CHILD, n=n, timeout=120)
            cache[n] = GroupResults(n, out_dir, procs, outs)
        return cache[n]
    return get


# -- the JAX side ------------------------------------------------------------

def _mesh(n: int, axis: str = SEQ_AXIS):
    return make_mesh((n,), axis_names=(axis,))


_jax_cache = {}


def _jax_attn(n: int, fn, prefix: str, causal: bool, **kw):
    """JAX's (out, dq, dk, dv) of ``fn`` on the group's global inputs,
    the grads of ``sum(out ** 2)`` through ``jax.vjp``."""
    key = (n, fn.__name__, prefix, causal, tuple(sorted(kw.items())))
    if key not in _jax_cache:
        x = _inputs(n)
        q, k, v = (jnp.asarray(x[prefix + p]) for p in "qkv")
        mesh = _mesh(n)
        out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, mesh, causal=causal,
                                              **kw), q, k, v)
        grads = vjp(2 * out)
        _jax_cache[key] = [np.asarray(a) for a in (out, *grads)]
    return _jax_cache[key]


def _hold(got, ref, rtol, atol):
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def _hold_attn(groups, n, case, ref, tol):
    """A case's gathered output and grads against JAX's ``ref``."""
    res = groups(n)
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        _hold(res.gathered(case, name), ref[i], tol, tol)


# -- ring attention -----------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_ring_attention_xla(groups, n, causal):
    """The plain block math's forward against JAX's xla ring
    (tests/test_ops.py:29-43's tolerance)."""
    x = _inputs(n)
    ref = np.asarray(jax_ring(*(jnp.asarray(x["x" + p]) for p in "qkv"),
                              _mesh(n), causal=causal))
    _hold(groups(n).gathered(f"ring_xla_{causal:d}", "out"), ref,
          RING_XLA_TOL, RING_XLA_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_ring_attention_xla_grads(groups, n, causal):
    """Autograd through the ring's shifts against the grads of JAX's
    unsharded oracle (JAX's own test of its xla ring's grads checks only
    that they are finite; its Pallas ring's are held to the oracle)."""
    x = _inputs(n)
    q, k, v = (jnp.asarray(x["x" + p]) for p in "qkv")
    out, vjp = jax.vjp(lambda q, k, v: jax_reference(q, k, v,
                                                     causal=causal),
                       q, k, v)
    res = groups(n)
    for name, ref in zip(("dq", "dk", "dv"), vjp(2 * out)):
        _hold(res.gathered(f"ring_xla_{causal:d}", name), np.asarray(ref),
              RING_GRAD_TOL, RING_GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", (2, 4))
def test_ring_attention_pallas(groups, n, causal):
    """The kernel impl's forward and its backward ring against JAX's
    Pallas ring and its custom VJP (interpret mode)."""
    ref = _jax_attn(n, jax_ring, "p", causal, impl="pallas")
    _hold_attn(groups, n, f"ring_pallas_{causal:d}", ref, RING_PALLAS_TOL)


def test_ring_attention_pallas_long_blocks(groups):
    """Shards of 1,152 rows, over the Pallas kernels' 1,024-key block:
    JAX takes its multi-block kernels, the card the K4 and K6 + K7
    regime."""
    ref = _jax_attn(2, jax_ring, "l", True, impl="pallas")
    _hold_attn(groups, 2, "ring_long", ref, RING_PALLAS_TOL)


# -- Ulysses ------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", (2, 4))
def test_ulysses_attention(groups, n, causal):
    """Forward (tests/test_ulysses.py:21-30) and grads (:44-60)."""
    ref = _jax_attn(n, jax_ulysses, "u", causal)
    res = groups(n)
    case = f"ulysses_{causal:d}"
    _hold(res.gathered(case, "out"), ref[0], ULYSSES_RTOL, ULYSSES_ATOL)
    for i, name in enumerate(("dq", "dk", "dv")):
        _hold(res.gathered(case, name), ref[1 + i], ULYSSES_GRAD_TOL,
              ULYSSES_GRAD_TOL)


@pytest.mark.parametrize("n", (2, 4))
def test_ulysses_flash_impl(groups, n):
    """``impl="flash"`` through the crossover dispatch with
    ``min_flash_seq=1``, against JAX's with the Pallas kernel in
    interpret mode (tests/test_ulysses.py:63-81)."""
    ref = _jax_attn(n, jax_ulysses, "u", True, impl="flash",
                    interpret=True, min_flash_seq=1)
    _hold_attn(groups, n, "ulysses_flash", ref, RING_PALLAS_TOL)


@pytest.mark.parametrize("n", SIZES)
def test_ulysses_heads_error(groups, n):
    """n + 1 heads do not divide over n ranks: both packages refuse."""
    x = _inputs(n)
    with pytest.raises(ValueError, match="heads"):
        jax_ulysses(*(jnp.asarray(x["h" + p]) for p in "qkv"), _mesh(n))
    for rank, r in enumerate(groups(n).get("ulysses_heads")):
        assert "heads" in str(r.get("error", "")), (rank, r)


# -- the collectives ----------------------------------------------------------

def _shards(a: np.ndarray, n: int) -> list:
    return np.split(a, n)


@pytest.mark.parametrize("n", SIZES)
def test_allreduce(groups, n):
    x = groups(n).inputs["c"]
    mesh = _mesh(n, WORKER_AXIS)
    for key, mean in (("sum", False), ("mean", True)):
        ref = _shards(np.asarray(jax_collectives.allreduce(
            x, mesh=mesh, mean=mean)), n)
        for rank, r in enumerate(groups(n).get("allreduce")):
            _hold(r[key], ref[rank], 1e-6, 1e-6)


@pytest.mark.parametrize("n", SIZES)
def test_allreduce_replicated(groups, n):
    x = groups(n).inputs["rep"]
    ref = np.asarray(jax_collectives.allreduce_replicated(
        x, mesh=_mesh(n, WORKER_AXIS)))
    for r in groups(n).get("allreduce_replicated"):
        _hold(r["sum"], ref, 1e-6, 1e-6)


@pytest.mark.parametrize("n", SIZES)
def test_all_gather(groups, n):
    """f32 against JAX's gather, and bf16 bytes through the host intact."""
    x = groups(n).inputs["c"]
    ref = np.asarray(jax_collectives.all_gather(x,
                                                mesh=_mesh(n, WORKER_AXIS)))
    bf = np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.int16)
    for r in groups(n).get("all_gather"):
        np.testing.assert_array_equal(r["f32"], ref)
        np.testing.assert_array_equal(r["bf16"], bf)


@pytest.mark.parametrize("n", SIZES)
def test_reduce_scatter(groups, n):
    x = groups(n).inputs["rs"]
    ref = _shards(np.asarray(jax_collectives.reduce_scatter(
        x, mesh=_mesh(n, WORKER_AXIS))), n)
    for rank, r in enumerate(groups(n).get("reduce_scatter")):
        _hold(r["out"], ref[rank], 1e-6, 1e-6)


@pytest.mark.parametrize("n", SIZES)
def test_ring_shift(groups, n):
    x = groups(n).inputs["c"]
    mesh = _mesh(n, WORKER_AXIS)
    for s in (1, -1, 2):
        ref = _shards(np.asarray(jax_collectives.ring_shift(
            x, WORKER_AXIS, mesh=mesh, shift=s)), n)
        for rank, r in enumerate(groups(n).get("ring_shift")):
            np.testing.assert_array_equal(r[f"s{s}"], ref[rank])


@pytest.mark.parametrize("n", SIZES)
def test_all_to_all(groups, n):
    """Split dim 1, concatenate dim 0: JAX's tiled ``lax.all_to_all``
    inside ``shard_map``."""
    x = groups(n).inputs["a2a"]
    spec = P(WORKER_AXIS, None, None)
    fn = shard_map(lambda s: jax.lax.all_to_all(s, WORKER_AXIS, 1, 0,
                                                tiled=True),
                   mesh=_mesh(n, WORKER_AXIS), in_specs=(spec,),
                   out_specs=spec, check_vma=False)
    ref = _shards(np.asarray(fn(jnp.asarray(x))), n)
    for rank, r in enumerate(groups(n).get("all_to_all")):
        np.testing.assert_array_equal(r["out"], ref[rank])


# -- the allreduce engine -----------------------------------------------------

def _jax_engine(n):
    return JaxEngine(axis=WORKER_AXIS, mesh=_mesh(n, WORKER_AXIS))


@pytest.mark.parametrize("n", SIZES)
def test_engine_allgather(groups, n):
    x = groups(n).inputs["eag"]
    ref = np.asarray(_jax_engine(n).allgather(x))
    for r in groups(n).get("engine_allgather"):
        np.testing.assert_array_equal(r["out"], ref)


@pytest.mark.parametrize("n", SIZES)
def test_engine_reduce_scatter(groups, n):
    """Recursive halving at 2 and 4, the ring at 3."""
    x = groups(n).inputs["ers"]
    ref = _shards(np.asarray(_jax_engine(n).reduce_scatter(x)), n)
    for rank, r in enumerate(groups(n).get("engine_reduce_scatter")):
        _hold(r["out"], ref[rank], ENGINE_TOL, ENGINE_TOL)


@pytest.mark.parametrize("name", ["ebig", "esmall", "emd", "end"])
@pytest.mark.parametrize("n", SIZES)
def test_engine_allreduce(groups, n, name):
    """Over 4 KB (reduce-scatter + allgather), under it (allgather then
    sum), a trailing shape whose dim does not divide n, and an element
    count that does not (padded)."""
    x = groups(n).inputs[name]
    ref = np.asarray(_jax_engine(n).allreduce(x))
    for rank, r in enumerate(groups(n).get(f"engine_allreduce_{name}")):
        _hold(r["out"], ref[rank], ENGINE_TOL, ENGINE_TOL)


# -- KVTable.sync -------------------------------------------------------------

@pytest.mark.parametrize("dtype,value", [("float32", 0.1), ("int64", 3)])
def test_kv_sync_folds_peer_values_uncast(groups, dtype, value):
    """Rank 1 adds, both sync. JAX's ``add`` casts the value to the
    table's dtype (multiverso_tpu/tables/kv_table.py:61-62) and pends the
    cast value; its ``sync`` gathers the pending values as float64 and
    adds a peer's as it is (:129-134). So rank 0 reads an np.float64 of
    the cast value, rank 1 its own add as ``add`` cast it."""
    res = groups(2).get(f"kv_{dtype}")
    own = np.dtype(dtype).type(value).item()
    peer = 0 + np.array([own], np.float64)[0]
    assert str(res[0]["type"]) == type(peer).__name__ == "float64", res[0]
    assert float(res[0]["value"]) == peer, res[0]
    assert str(res[1]["type"]) == type(own).__name__, res[1]
    assert float(res[1]["value"]) == own, res[1]
