"""The port's mesh against the JAX package's, on the CPU.

``topology.make_mesh``, ``discover``, ``sharding_for`` and the
``-mesh_shape`` parse, the session's mesh queries, the LM trainer's
dp x tp layout (``param_shardings``, ``shard_params``, ``gather_params``
and ``TransformerLM`` over a mesh) and ``parallel.make_sync_step``, each
held against the JAX function on the conftest's virtual CPU mesh of the
same shape, on the same inputs made with numpy from a seed.

A port mesh is a grid of process ranks, so everything past a (1, 1) mesh
runs in one group of 4 fresh interpreters (gloo on the CPU), spawned once
by a module-scoped fixture as ``tests/test_torch_seqpar.py`` does: its
processes run every case and save the results, and each case is its own
test that reads them. Tolerance: ``tests/test_torch_lm_training.py``'s
1e-4 for f32 losses, parameters and momentum after three steps.
"""

import json

import jax
import numpy as np
import pytest

from test_torch_multiprocess import run_group

import multiverso_tpu as jmv
from multiverso_tpu import topology as jtopo
from multiverso_tpu.models import transformer as jtf
from multiverso_tpu.parallel import make_sync_step as jax_sync_step
from multiverso_tpu.updaters import AddOption as JaxAddOption
from multiverso_tpu_torch import topology as ttopo
from multiverso_tpu_torch.log import FatalError

N = 4
TOL = dict(rtol=1e-4, atol=1e-4)
DIMS = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq=24)
TRAIN_SHAPES = ((2, 2), (1, 4), (4, 1))
ATTENTIONS = ("reference", "flash_force")
# make_mesh cases: (shape or None, axis names)
MESHES = {"2x2": ((2, 2), ("worker", "server")),
          "1x4": ((1, 4), ("worker", "server")),
          "4x1": ((4, 1), ("worker", "server")),
          "2x1": ((2, 1), ("worker", "server")),
          "default": (None, ("worker", "server")),
          "seq4": ((4,), ("seq",)),
          "1x2x2": ((1, 2, 2), ("worker", "server", "seq"))}
# session cases: -mesh_shape, -sync
SESSIONS = {"2,2": True, "1,4": False, "": True}
SYNC_TARGET = np.arange(8, dtype=np.float32)
SYNC_STEPS, SYNC_LR = 60, 0.5


def _tokens() -> np.ndarray:
    """Three global [8, 16] batches."""
    return np.random.default_rng(18).integers(
        0, DIMS["vocab_size"], (3, 8, 16)).astype(np.int64)


def _sync_batch() -> np.ndarray:
    """[4, 8]: row r is the target plus r (one row per worker)."""
    return SYNC_TARGET[None] + np.arange(N, dtype=np.float32)[:, None]


_CHILD = """
    os.nice(10)
    import json, traceback
    import torch
    out_dir = os.environ["MV_TEST_OUT"]
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    cases = json.loads(open(os.path.join(out_dir, "cases.json")).read())
    from multiverso_tpu_torch import topology as T
    from multiverso_tpu_torch.log import FatalError
    from multiverso_tpu_torch.models import transformer as tf
    res, errors = {}, {}

    def named(tree, prefix=""):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from named(tree[k], f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", tree[k].detach().numpy()

    def case(name, fn):
        try:
            for key, val in fn().items():
                res[f"{name}/{key}"] = np.asarray(val)
        except Exception:
            errors[name] = traceback.format_exc()

    def refused(fn):
        try:
            fn()
        except FatalError as exc:
            return {"refused": str(exc)}
        return {"refused": ""}

    # the session queries, each in a session of its own
    for shape, sync in cases["sessions"].items():
        def queries():
            mv.init(["mesh", "-device=cpu", "-log_level=error",
                     f"-mesh_shape={shape}", f"-sync={str(sync).lower()}"])
            s = mv.session()
            out = {"mesh": list(s.mesh.ranks.shape),
                   "table_mesh": list(s.table_mesh.ranks.shape),
                   "table_ranks": s.table_mesh.ranks.ravel(),
                   "q": [s.num_workers, s.num_servers, s.local_workers,
                         s.worker_id, s.rank, s.size]}
            mv.shutdown()
            return out
        case(f"session_{shape or 'default'}", queries)
    for shape in ("3,1", "2,4"):
        def refuse():
            def start():
                mv.init(["mesh", "-device=cpu", "-log_level=error",
                         f"-mesh_shape={shape}"])
            out = refused(start)
            out["started"] = int(mv.session().started)
            return out
        case(f"refuse_{shape}", refuse)

    mv.init(["mesh", "-device=cpu", "-sync=true", "-log_level=error",
             "-mesh_shape="])
    for name, (shape, axes) in cases["meshes"].items():
        def mesh():
            m = (T.make_mesh(shape, tuple(axes)) if shape is not None
                 else T.make_mesh(axis_names=tuple(axes)))
            out = {"shape": [m.shape[a] for a in m.axis_names],
                   "ranks": m.ranks, "coords": [-1] if m.coords() is None
                   else [m.coords()[a] for a in m.axis_names]}
            for a in m.axis_names:
                if m.coords() is not None:
                    out[f"group_{a}"] = list(m.group(a).ranks)
                    # a sum over the sub-group, in its order
                    from multiverso_tpu_torch.parallel import collectives
                    out[f"sum_{a}"] = collectives.allreduce(
                        torch.tensor([float(rank + 1)]),
                        group=m.group(a)).numpy()
            return out
        case(f"mesh_{name}", mesh)

    toks = torch.from_numpy(inp["tokens"])
    for shape in cases["train_shapes"]:
        mesh = T.make_mesh(tuple(shape))
        for att in cases["attentions"]:
            def train():
                cfg = tf.TransformerConfig(**cases["dims"], attention=att)
                lm = tf.TransformerLM(cfg, mesh=mesh)
                out = {f"init/{k}": v for k, v in named(
                    lm.snapshot_params()[0])}
                out["losses"] = [float(lm.train_batch(t)) for t in toks]
                for tag, tree in (("params", lm.params),
                                  ("momentum", lm._momentum)):
                    full = tf.gather_params(tree, lm.specs, mesh)
                    out.update({f"{tag}/{k}": v for k, v in
                                named(full)})
                out["version"] = lm.snapshot_params()[1]
                return out
            case(f"train_{shape[0]}x{shape[1]}_{att}", train)

    mesh22 = T.make_mesh((2, 2))
    one = T.make_mesh((1, 1))
    dims = cases["dims"]
    for name, over in (("n_heads", dict(n_heads=1, d_model=16)),
                       ("d_ff", dict(d_ff=129)),
                       ("vocab_size", dict(vocab_size=63))):
        case(f"refuse_{name}", lambda: refused(lambda: tf.TransformerLM(
            tf.TransformerConfig(**{**dims, **over}), mesh=mesh22)))
    def batch_refused():
        lm = tf.TransformerLM(tf.TransformerConfig(**dims), mesh=mesh22)
        return refused(lambda: lm.train_batch(toks[0][:3]))
    case("refuse_batch", batch_refused)
    case("refuse_outside", lambda: refused(lambda: tf.TransformerLM(
        tf.TransformerConfig(**dims), mesh=one)))

    def sync_step():
        from multiverso_tpu_torch.parallel import make_sync_step
        from multiverso_tpu_torch.updaters import AddOption
        table = mv.create_table("array", 8, updater="sgd")
        step = make_sync_step(table, lambda p, b: torch.mean((p - b) ** 2))
        batch = torch.from_numpy(inp["sync_batch"])
        losses = [float(step(batch, AddOption(learning_rate=cases["lr"])))
                  for _ in range(cases["steps"])]
        return {"losses": losses, "table": table.get(),
                "mesh": list(table.mesh.ranks.shape)}
    case("sync_step", sync_step)
    mv.shutdown()

    def app_ckpt():
        from multiverso_tpu_torch.apps import lm as app
        corpus = os.path.join(out_dir, "corpus.txt")
        def run():
            app.main(["-train_file", corpus, "-d_model", "16", "-n_layers",
                      "1", "-n_heads", "4", "-seq", "8", "-batch", "4",
                      "-steps", "1", "-ckpt", os.path.join(out_dir, "ck"),
                      "-device=cpu", "-log_level=error", "-mesh_shape=1,4"])
        out = refused(run)
        mv.shutdown()
        return out
    case("refuse_ckpt", app_ckpt)

    np.savez(os.path.join(out_dir, f"res_{rank}.npz"), **res)
    with open(os.path.join(out_dir, f"errors_{rank}.json"), "w") as f:
        json.dump(errors, f)
    print(f"RANK{rank}_MESH_OK", flush=True)
"""


class GroupResults:
    """The group's saved results: ``get(case)`` gives each rank's arrays
    by key, and fails the test with the group's traceback where the case
    raised."""

    def __init__(self, out_dir, procs, outs) -> None:
        for rank, (proc, out) in enumerate(zip(procs, outs)):
            assert proc.returncode == 0 and f"RANK{rank}_MESH_OK" in out, \
                f"rank {rank}:\n{out[-3000:]}"
        self.res, self.errors = [], []
        for rank in range(N):
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


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The group of 4, spawned once (at first use), at most 120 s."""
    out_dir = tmp_path_factory.mktemp("mesh")
    np.savez(out_dir / "inputs.npz", tokens=_tokens(),
             sync_batch=_sync_batch())
    (out_dir / "cases.json").write_text(json.dumps(dict(
        sessions=SESSIONS, meshes=MESHES, train_shapes=TRAIN_SHAPES,
        attentions=ATTENTIONS, dims=DIMS, lr=SYNC_LR, steps=SYNC_STEPS)))
    (out_dir / "corpus.txt").write_bytes(bytes(range(256)) * 4)
    procs, outs = run_group(out_dir, _CHILD, n=N, timeout=120)
    return GroupResults(out_dir, procs, outs)


# -- the JAX side ------------------------------------------------------------

def _jax_mesh(shape, axes=("worker", "server")):
    return jtopo.make_mesh(shape, axis_names=axes)


def _device_ids(mesh) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(mesh.devices)


_jax_cache = {}


def _jax_train(shape, attention):
    """JAX ``TransformerLM`` on ``make_mesh(shape)``: the initial sharded
    parameters' per-device shards, the losses of three steps, and the
    parameters and momentum after them."""
    key = (shape, attention)
    if key not in _jax_cache:
        jmv.shutdown()
        jmv.init()
        try:
            lm = jtf.TransformerLM(
                jtf.TransformerConfig(**DIMS, attention=attention),
                mesh=_jax_mesh(shape))
            shards = {}
            for name, leaf in _named(lm.params):
                for s in leaf.addressable_shards:
                    shards[(name, s.device.id)] = np.asarray(s.data)
            losses = [float(lm.train_batch(t.astype(np.int32)))
                      for t in _tokens()]
            _jax_cache[key] = dict(
                shards=shards, losses=np.array(losses),
                params=dict(_named(jax.tree.map(np.asarray, lm.params))),
                momentum=dict(_named(jax.tree.map(np.asarray,
                                                  lm._momentum))))
        finally:
            jmv.shutdown()
    return _jax_cache[key]


def _named(tree, prefix=""):
    """``(path, leaf)`` in sorted key order, ``layers.w_q`` style."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _named(tree[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", tree[k]


# -- make_mesh, discover, -mesh_shape ----------------------------------------

@pytest.mark.parametrize("name", sorted(MESHES))
def test_make_mesh_matches_jax(group, name):
    """Shape, axis order and the rank grid in JAX's device order; each
    rank's coordinates and sub-groups (the ranks that share its other
    coordinates), and a sum over each sub-group."""
    shape, axes = MESHES[name]
    jm = (_jax_mesh(shape, axes) if shape is not None
          else jtopo.make_mesh(axis_names=axes, devices=jax.devices()[:N]))
    ids = _device_ids(jm)
    for rank, r in enumerate(group.get(f"mesh_{name}")):
        assert list(r["shape"]) == [jm.shape[a] for a in axes]
        np.testing.assert_array_equal(r["ranks"], ids)
        at = np.argwhere(ids == rank)
        if at.size == 0:
            assert list(r["coords"]) == [-1]
            continue
        coords = tuple(at[0])
        assert list(r["coords"]) == list(coords)
        for i, a in enumerate(axes):
            line = ids[coords[:i] + (slice(None),) + coords[i + 1:]]
            assert list(r[f"group_{a}"]) == line.tolist()
            assert float(r[f"sum_{a}"][0]) == float(np.sum(line + 1))


def test_make_mesh_value_errors():
    """JAX's two ValueErrors: a shape that does not match the axes, and
    one that needs more ranks (devices) than exist."""
    for make, have in ((ttopo.make_mesh, 1), (jtopo.make_mesh, 8)):
        with pytest.raises(ValueError, match="does not match axes"):
            make((1, 1, 1))
        with pytest.raises(ValueError, match="needs"):
            make((have + 1, 1))


@pytest.mark.parametrize("text", ["", "4,2", " 2, 2 ", "4,", "1,4,2"])
def test_mesh_shape_parse(text):
    assert ttopo._parse_mesh_shape(text) == jtopo._parse_mesh_shape(text)


def test_discover_default_one_worker_per_process(group):
    """discover's default is (process count, 1): JAX's (workers =
    processes, server = devices per process), one device a process."""
    import multiverso_tpu_torch as mv

    mv.init(["mesh", "-device=cpu", "-log_level=error"])
    try:
        topo = ttopo.discover()
        assert topo.mesh.shape == {"worker": 1, "server": 1}
        assert (topo.num_workers, topo.num_servers) == (1, 1)
        assert topo.local_mesh.shape == {"worker": 1, "server": 1}
        assert ttopo.discover((1, 1)).mesh.ranks.tolist() == [[0]]
    finally:
        mv.shutdown()
    r = group.get("session_default")
    assert [list(x["mesh"]) for x in r] == [[N, 1]] * N


# -- the session --------------------------------------------------------------

@pytest.mark.parametrize("shape", sorted(SESSIONS))
def test_session_mesh_queries(group, shape):
    """Session.mesh, table_mesh, num_workers, num_servers, local_workers
    and worker_id by JAX's formulas (runtime.py:345-404) on JAX's
    Topology of the same mesh over 4 processes: table_mesh is the mesh,
    or with the async bus the rank's own (1, 1) mesh."""
    mesh_shape = jtopo._parse_mesh_shape(shape) or (N, 1)
    for rank, r in enumerate(group.get(f"session_{shape or 'default'}")):
        jt = jtopo.Topology(mesh=_jax_mesh(mesh_shape), process_index=rank,
                            process_count=N)
        local = jt.num_workers // jt.size
        assert list(r["mesh"]) == list(mesh_shape)
        assert list(r["q"]) == [jt.num_workers, jt.num_servers, local,
                                jt.rank * local, rank, N]
        if SESSIONS[shape]:
            assert list(r["table_mesh"]) == list(mesh_shape)
        else:
            assert list(r["table_mesh"]) == [1, 1]
            assert r["table_ranks"].tolist() == [rank]


@pytest.mark.parametrize("shape", ["3,1", "2,4"])
def test_session_refuses_mesh(group, shape):
    """A worker axis that neither divides by the process count nor
    divides it, and a mesh that needs more ranks than the group has, are
    FatalErrors on every rank; no session starts."""
    for r in group.get(f"refuse_{shape}"):
        assert str(r["refused"]) and "mesh" in str(r["refused"])
        assert int(r["started"]) == 0


def test_single_process_mesh_shape():
    """-mesh_shape is accepted; one process holds a (1, 1) mesh and no
    more."""
    import multiverso_tpu_torch as mv

    try:
        mv.init(["mesh", "-device=cpu", "-log_level=error",
                 "-mesh_shape=1,1"])
        assert mv.session().mesh.shape == {"worker": 1, "server": 1}
        mv.shutdown()
        with pytest.raises(FatalError, match="needs 2 ranks"):
            mv.init(["mesh", "-device=cpu", "-log_level=error",
                     "-mesh_shape=1,2"])
        assert not mv.session().started
    finally:
        mv.shutdown()
        mv.set_flag("mesh_shape", "")


# -- the LM trainer's layout ---------------------------------------------------

def test_param_shardings_cover_tree():
    """Every parameter has a spec, JAX's spec (tests/test_transformer.py:
    93)."""
    from multiverso_tpu_torch.models import transformer as ttf

    jcfg = jtf.TransformerConfig(**DIMS)
    jspecs = {k: tuple(v.spec) for k, v in _named(
        jtf.param_shardings(jcfg, _jax_mesh((4, 2))))}
    tspecs = dict(_named(ttf.param_shardings(
        ttf.TransformerConfig(**DIMS), ttopo.make_mesh((1, 1)))))
    assert tspecs == jspecs
    assert "server" in tspecs["layers.w_q"]
    params = dict(_named(jtf.init_params(jcfg)))
    assert sorted(params) == sorted(tspecs)


@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_shard_params_match_jax_shards(group, shape):
    """Rank r's shards from shard_params are JAX's shards on device r of
    the same mesh; gather_params of the initial shards (the momentum's
    zeros before any step) is checked by the training tests."""
    ref = _jax_train(shape, "reference")["shards"]
    for rank, r in enumerate(group.get(
            f"train_{shape[0]}x{shape[1]}_reference")):
        init = {k.split("/", 1)[1]: v for k, v in r.items()
                if k.startswith("init/")}
        for name, got in init.items():
            np.testing.assert_array_equal(got, ref[(name, rank)])


def test_shard_gather_round_trip_one_rank():
    """shard_params then gather_params is the whole tree (a (1, 1)
    mesh)."""
    import torch

    from multiverso_tpu_torch.models import transformer as ttf

    cfg = ttf.TransformerConfig(**DIMS)
    mesh = ttopo.make_mesh((1, 1))
    specs = ttf.param_shardings(cfg, mesh)
    whole = ttf.init_params(cfg, device="cpu")
    back = ttf.gather_params(ttf.shard_params(whole, specs, mesh), specs,
                             mesh)
    for (name, a), (_, b) in zip(_named(whole), _named(back)):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("attention", ATTENTIONS)
@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_train_steps_match_jax(group, shape, attention):
    """Three f32 steps of TransformerLM on the mesh from the same weights
    and global batches: every rank's losses, and the parameters and
    momentum gathered from the shards, within 1e-4 of JAX's
    TransformerLM on the virtual mesh of the same shape."""
    ref = _jax_train(shape, attention)
    for rank, r in enumerate(group.get(
            f"train_{shape[0]}x{shape[1]}_{attention}")):
        np.testing.assert_allclose(r["losses"], ref["losses"], **TOL)
        assert int(r["version"]) == 3
        for tag in ("params", "momentum"):
            for name, want in ref[tag].items():
                np.testing.assert_allclose(r[f"{tag}/{name}"], want,
                                           err_msg=f"{tag} {name}", **TOL)


@pytest.mark.parametrize("what", ["n_heads", "d_ff", "vocab_size", "batch",
                                  "outside"])
def test_trainer_refuses_uneven_layout(group, what):
    """A (2, 2) mesh that does not divide the heads, d_ff, the vocabulary
    or the batch, and a rank outside the mesh, are FatalErrors."""
    for rank, r in enumerate(group.get(f"refuse_{what}")):
        refused = str(r["refused"])
        if what == "outside" and rank == 0:
            assert refused == ""   # rank 0 is the (1, 1) mesh
        else:
            assert refused, f"rank {rank} was not refused"


def test_lm_app_ckpt_refused_with_tp_across_processes(group):
    """-ckpt on a mesh whose server axis spans processes is a FatalError
    naming ROADMAP item 8f."""
    for r in group.get("refuse_ckpt"):
        assert "8f" in str(r["refused"])


# -- the BSP step ---------------------------------------------------------------

def test_sync_step_matches_jax(group):
    """make_sync_step on tests/test_parallel.py:69-85's quadratic, the
    batch (row r: the target + r) sharded over a worker axis of 4: each
    step's loss and the final table within 1e-4 of JAX's on the virtual
    (4, 1) mesh."""
    import jax.numpy as jnp

    jmv.shutdown()
    jmv.set_flag("mesh_shape", "4,1")
    jmv.init()
    try:
        table = jmv.create_table("array", 8, updater="sgd")
        step = jax_sync_step(table, lambda p, b: jnp.mean((p - b) ** 2))
        losses = [float(step(_sync_batch(),
                             JaxAddOption(learning_rate=SYNC_LR)))
                  for _ in range(SYNC_STEPS)]
        final = table.get()
    finally:
        jmv.shutdown()
        jmv.set_flag("mesh_shape", "")
    # the fixed point is the batch's mean row
    np.testing.assert_allclose(final, SYNC_TARGET + 1.5, atol=1e-2)
    for r in group.get("sync_step"):
        assert list(r["mesh"]) == [N, 1]
        np.testing.assert_allclose(r["losses"], losses, **TOL)
        np.testing.assert_allclose(r["table"], final, **TOL)
