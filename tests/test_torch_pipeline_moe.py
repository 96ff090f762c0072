"""The port's pipeline parallelism and MoE against the JAX package's, on
the CPU.

``parallel.pipeline`` (``pipeline_apply``, GPipe; ``pipeline_value_and_
grad``, 1F1B) and ``ops.moe`` (``top1_gating``, ``moe_apply``,
``init_moe_params``), each held against the JAX function on the
conftest's virtual CPU mesh (4 devices, 2 where a case has 2 stages), on
the same inputs made with numpy from a seed: every case of
``tests/test_pipeline_moe.py`` at that file's tolerances in f32, a
transformer stage (2 flagship-style layers a stage, ``reference`` and
``flash_force`` attention; JAX's flash in interpret mode) against JAX
and against one process, and the two controls that chip_smoke.py's
phase 20 runs (the cotangent not passed up the ring; the loss's
cotangent counted on every rank), each of which must fail the check.

The port's stages and expert shards are processes, so the group cases
run in one group of 4 fresh interpreters (gloo on the CPU), spawned once
by a module-scoped fixture as ``tests/test_torch_mesh.py`` does: its
processes run every case and save the results, and each case is its own
test that reads them. A rank's gradient is its share (its stage's row,
its experts, its tokens' part of the router's): the shares summed over
the ranks are the JAX gradient.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_multiprocess import run_group

from multiverso_tpu.models import transformer as jtf
from multiverso_tpu.ops import moe as jmoe
from multiverso_tpu.parallel import pipeline as jpipe
from multiverso_tpu.topology import make_mesh as jax_make_mesh
from multiverso_tpu_torch.ops import moe as tmoe
from multiverso_tpu_torch.parallel import pipeline as tpipe

N = 4
# tests/test_pipeline_moe.py's tolerances
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
MOE_TOL = dict(rtol=1e-4, atol=1e-5)
# the transformer stage: f32 through 4 or 8 layers, the port's plain
# attention against JAX's reference or interpret-mode flash
LM_TOL = dict(rtol=1e-4, atol=1e-5)
LM_DIMS = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, max_seq=16)
LM_STAGES, LM_LAYERS, LM_MICRO, LM_MB, LM_SEQ = 4, 2, 4, 2, 16
ATTENTIONS = ("reference", "flash_force")

# name -> (n_stages or None for every rank, dim, n_micro, micro batch,
# seed): tests/test_pipeline_moe.py's cases
APPLY = {"matches": (4, 8, 6, 5, 0), "all_ranks": (None, 4, 3, 2, 1)}
BACKWARD = {"backward": (4, 6, 4, 3, 2)}
ONE_F_ONE_B = {"4x6": (4, 6, 6, 3, 5), "2x9": (2, 6, 9, 3, 7),
               "4x1": (4, 6, 1, 3, 8), "repeat": (4, 4, 5, 2, 9)}
# name -> (n_experts, d_model, d_hidden, tokens, seed, capacity factor)
MOE = {"E8": (8, 8, 16, 32, 4, 8.0), "E16": (16, 8, 16, 32, 4, 16.0),
       "grad": (8, 4, 8, 16, 5, 2.0)}


def _stage_inputs(n_stages, dim, n_micro, mb, seed):
    """tests/test_pipeline_moe.py's draws: per-stage w, b, then xs, then
    the targets."""
    rng = np.random.default_rng(seed)
    w, b = [], []
    for _ in range(n_stages):
        w.append(rng.standard_normal((dim, dim)) * 0.3)
        b.append(rng.standard_normal((dim,)) * 0.1)
    xs = rng.standard_normal((n_micro * mb, dim)).reshape(n_micro, mb, dim)
    tgt = rng.standard_normal(xs.shape)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(w=f(w), b=f(b), xs=f(xs), tgt=f(tgt))


def _moe_inputs(n_experts, d_model, d_hidden, tokens, seed):
    rng = np.random.default_rng(seed)
    router, ep = jmoe.init_moe_params(rng, n_experts, d_model, d_hidden)
    x = np.asarray(rng.standard_normal((tokens, d_model)), np.float32)
    return dict(router=np.asarray(router), w1=np.asarray(ep["w1"]),
                w2=np.asarray(ep["w2"]), x=x)


def _lm_inputs():
    """The transformer stage's weights: JAX init_params of an 8-layer
    model, its layers split 2 a stage; the microbatches' embedded inputs
    and targets."""
    cfg = jtf.TransformerConfig(**LM_DIMS, n_layers=LM_STAGES * LM_LAYERS)
    p = jax.tree.map(np.asarray, jtf.init_params(cfg))
    toks = np.random.default_rng(17).integers(
        0, LM_DIMS["vocab_size"], (LM_MICRO, LM_MB, LM_SEQ + 1))
    xs = (p["embed"][toks[..., :-1]] + p["pos"][:LM_SEQ]).astype(np.float32)
    out = {f"layers.{k}": v for k, v in p["layers"].items()}
    out.update(embed=p["embed"], ln_f_g=p["ln_f_g"], xs=xs,
               tgt=toks[..., 1:].astype(np.int64))
    return out


_CHILD = """
    os.nice(10)
    import json, traceback
    import torch
    out_dir = os.environ["MV_TEST_OUT"]
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    cases = json.loads(open(os.path.join(out_dir, "cases.json")).read())
    from multiverso_tpu_torch.models import transformer as tf
    from multiverso_tpu_torch.ops import moe
    from multiverso_tpu_torch.parallel import pipeline as pp
    from multiverso_tpu_torch.topology import make_mesh
    T = lambda a: torch.from_numpy(np.asarray(a))
    res, errors = {}, {}

    def case(name, fn):
        try:
            for key, val in fn().items():
                res[f"{name}/{key}"] = np.asarray(val)
        except Exception:
            errors[name] = traceback.format_exc()

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    def mse(y, t):
        return torch.mean((y - t) ** 2)

    def params_of(name):
        return {"w": T(inp[f"{name}.w"]).requires_grad_(),
                "b": T(inp[f"{name}.b"]).requires_grad_()}

    mv.init(["pipe", "-device=cpu", "-log_level=error", "-mesh_shape="])

    for name, (S, *_rest) in cases["apply"].items():
        mesh = pp.make_pipeline_mesh(S)
        if mesh.coords() is None:
            continue
        def apply():
            with torch.no_grad():
                out = pp.pipeline_apply(stage_fn, params_of(name),
                                        T(inp[f"{name}.xs"]), mesh)
            return {"out": out, "stages": [mesh.shape["stage"]]}
        case(f"apply_{name}", apply)

    for name, (S, *_rest) in cases["backward"].items():
        mesh = pp.make_pipeline_mesh(S)
        def backward():
            p = params_of(name)
            xs = T(inp[f"{name}.xs"]).requires_grad_()
            out = pp.pipeline_apply(stage_fn, p, xs, mesh)
            loss = mse(out, T(inp[f"{name}.tgt"]))
            loss.backward()
            # stage 0 alone gets xs's gradient; elsewhere it stays None
            dxs = xs.grad if xs.grad is not None else torch.zeros_like(xs)
            return {"loss": loss.detach(), "w": p["w"].grad,
                    "b": p["b"].grad, "xs": dxs,
                    "xs_none": [xs.grad is None]}
        case(f"bwd_{name}", backward)

    def one_f_one_b(name, S):
        mesh = pp.make_pipeline_mesh(S)
        if mesh.coords() is None:
            return None
        def run():
            pp.reset_stats()
            loss, g = pp.pipeline_value_and_grad(
                stage_fn, mse, params_of(name), T(inp[f"{name}.xs"]),
                T(inp[f"{name}.tgt"]), mesh)
            return {"loss": loss, "w": g["w"], "b": g["b"],
                    "stage": [mesh.coords()["stage"]],
                    "slots": [pp.STATS["slots"], pp.STATS["filled"]]}
        return run

    for name, (S, *_rest) in cases["1f1b"].items():
        run = one_f_one_b(name, S)
        if run is None:
            continue
        case(f"1f1b_{name}", run)
        if name == "repeat":
            case("1f1b_repeat_again", run)

    # the controls, on the 4 x 6 case
    run = one_f_one_b("4x6", 4)
    ring, seed = pp._pass_cotangent, pp._loss_and_seed
    pp._pass_cotangent = lambda dx, *a: torch.zeros_like(dx)
    try:
        case("ctl_no_cotangent", run)
    finally:
        pp._pass_cotangent = ring
    def every_rank(loss_fn, y, aux):
        loss, s = seed(loss_fn, y, aux)
        return loss, s * 4
    pp._loss_and_seed = every_rank
    try:
        case("ctl_seed_every_rank", run)
    finally:
        pp._loss_and_seed = seed

    def refused(fn):
        try:
            fn()
        except ValueError as exc:
            return str(exc)
        return ""

    def mismatch():
        mesh = pp.make_pipeline_mesh(4)
        p = {"w": torch.zeros(8, 4, 4), "b": torch.zeros(8, 4)}
        xs = torch.zeros(2, 2, 4)
        return {"apply": [refused(lambda: pp.pipeline_apply(
                    stage_fn, p, xs, mesh))],
                "vg": [refused(lambda: pp.pipeline_value_and_grad(
                    stage_fn, mse, p, xs, xs, mesh))]}
    case("mismatch", mismatch)

    # the transformer stage: 2 layers a stage over 4 stages
    lm = {k[len("lm.layers."):]: T(v) for k, v in inp.items()
          if k.startswith("lm.layers.")}
    embed, ln_f = T(inp["lm.embed"]), T(inp["lm.ln_f_g"])
    xs, tgt = T(inp["lm.xs"]), T(inp["lm.tgt"])
    n_stages, per = cases["lm"]["stages"], cases["lm"]["layers"]
    stacked = {k: v.reshape((n_stages, per) + tuple(v.shape[1:]))
               for k, v in lm.items()}
    for att in cases["attentions"]:
        cfg = tf.TransformerConfig(**cases["lm"]["dims"],
                                   n_layers=n_stages * per, attention=att)

        def lm_stage(p, h, cfg=cfg):
            for layer in tf._layers({"layers": p}):
                h = tf._block(cfg, layer, h)[0]
            return h

        def lm_loss(h, t):
            logits = tf._logits(tf._rmsnorm(h, ln_f), embed)
            return torch.nn.functional.cross_entropy(
                logits.reshape(-1, logits.shape[-1]), t.reshape(-1))

        mesh = pp.make_pipeline_mesh(n_stages)
        def lm_run():
            loss, g = pp.pipeline_value_and_grad(
                lm_stage, lm_loss, stacked, xs, tgt, mesh)
            return {"loss": loss, **{k: v for k, v in g.items()}}
        case(f"lm_{att}", lm_run)

        def lm_single():
            # one process: every microbatch through all the layers in
            # order, gradients by autograd
            whole = {k: v.clone().requires_grad_() for k, v in lm.items()}
            total = 0.0
            for m in range(xs.shape[0]):
                h = xs[m]
                for layer in tf._layers({"layers": whole}):
                    h = tf._block(cfg, layer, h)[0]
                total = total + lm_loss(h, tgt[m])
            loss = total / xs.shape[0]
            grads = torch.autograd.grad(loss, list(whole.values()))
            return {"loss": loss.detach(),
                    **{k: g for k, g in zip(whole, grads)}}
        if rank == 0:
            case(f"lm_single_{att}", lm_single)

    for name, (E, d, h, tokens, seed, cf) in cases["moe"].items():
        mesh = make_mesh((4,), ("expert",))
        def moe_run():
            router = T(inp[f"{name}.router"]).requires_grad_()
            ep = {"w1": T(inp[f"{name}.w1"]).requires_grad_(),
                  "w2": T(inp[f"{name}.w2"]).requires_grad_()}
            y, aux = moe.moe_apply(moe.mlp_expert, ep, router,
                                   T(inp[f"{name}.x"]), mesh,
                                   capacity_factor=cf)
            (torch.sum(y ** 2) + 0.01 * aux).backward()
            return {"y": y.detach(), "aux": aux.detach(),
                    "router": router.grad, "w1": ep["w1"].grad,
                    "w2": ep["w2"].grad}
        case(f"moe_{name}", moe_run)

    def moe_refused():
        mesh = make_mesh((4,), ("expert",))
        r, ep = moe.init_moe_params(np.random.default_rng(0), 6, 4, 8,
                                    device="cpu")
        r8, ep8 = moe.init_moe_params(np.random.default_rng(0), 8, 4, 8,
                                      device="cpu")
        return {"experts": [refused(lambda: moe.moe_apply(
                    moe.mlp_expert, ep, r, torch.zeros(8, 4), mesh))],
                "tokens": [refused(lambda: moe.moe_apply(
                    moe.mlp_expert, ep8, r8, torch.zeros(6, 4), mesh))]}
    case("moe_refused", moe_refused)
    mv.shutdown()

    np.savez(os.path.join(out_dir, f"res_{rank}.npz"), **res)
    with open(os.path.join(out_dir, f"errors_{rank}.json"), "w") as f:
        json.dump(errors, f)
    print(f"RANK{rank}_PIPE_OK", flush=True)
"""


class GroupResults:
    """The group's saved results: ``get(case)`` gives each rank's arrays
    by key (None for a rank that did not run the case), and fails the test
    with the group's traceback where the case raised."""

    def __init__(self, out_dir, procs, outs) -> None:
        for rank, (proc, out) in enumerate(zip(procs, outs)):
            assert proc.returncode == 0 and f"RANK{rank}_PIPE_OK" in out, \
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
                if k.startswith(case + "/")} or None for r in self.res]
        assert out[0], f"case {case} left no result"
        return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The group of 4, spawned once (at first use), at most 150 s."""
    out_dir = tmp_path_factory.mktemp("pipe")
    arrays = {}
    for name, (S, dim, n_micro, mb, seed) in {**APPLY, **BACKWARD,
                                              **ONE_F_ONE_B}.items():
        arrays.update({f"{name}.{k}": v for k, v in _stage_inputs(
            S or N, dim, n_micro, mb, seed).items()})
    for name, (E, d, h, tokens, seed, _) in MOE.items():
        arrays.update({f"{name}.{k}": v for k, v in _moe_inputs(
            E, d, h, tokens, seed).items()})
    arrays.update({f"lm.{k}": v for k, v in _lm_inputs().items()})
    np.savez(out_dir / "inputs.npz", **arrays)
    (out_dir / "cases.json").write_text(json.dumps(dict(
        apply=APPLY, backward=BACKWARD, **{"1f1b": ONE_F_ONE_B}, moe=MOE,
        attentions=ATTENTIONS,
        lm=dict(stages=LM_STAGES, layers=LM_LAYERS, dims=LM_DIMS))))
    procs, outs = run_group(out_dir, _CHILD, n=N, timeout=150)
    return GroupResults(out_dir, procs, outs)


# -- the JAX side ------------------------------------------------------------

def _jax_stage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _jax_params(inp):
    return {"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"])}


def _jax_sequential(params, xs, n_stages):
    out = xs.reshape((-1,) + xs.shape[2:])
    for s in range(n_stages):
        out = _jax_stage_fn(jax.tree.map(lambda l, s=s: l[s], params), out)
    return out.reshape(xs.shape)


def _mse(y, t):
    return jnp.mean((y - t) ** 2)


def _share_sum(parts, key):
    """The ranks' gradient shares summed: the whole gradient."""
    return sum(np.asarray(p[key], np.float64) for p in parts if p)


# -- GPipe --------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(APPLY))
def test_pipeline_apply_matches_jax(group, name):
    """The forward equals JAX's pipeline_apply and the sequential
    composition on every rank of the stage axis (make_pipeline_mesh()
    takes every rank, as JAX's takes every device)."""
    S, dim, n_micro, mb, seed = APPLY[name]
    S = S or N
    inp = _stage_inputs(S, dim, n_micro, mb, seed)
    params = _jax_params(inp)
    xs = jnp.asarray(inp["xs"])
    mesh = jpipe.make_pipeline_mesh(S, devices=jax.devices()[:S])
    ref = np.asarray(jpipe.pipeline_apply(_jax_stage_fn, params, xs, mesh))
    np.testing.assert_allclose(
        ref, np.asarray(_jax_sequential(params, xs, S)), **OUT_TOL)
    parts = group.get(f"apply_{name}")
    assert [int(p["stages"][0]) for p in parts] == [S] * N
    for p in parts:
        np.testing.assert_allclose(p["out"], ref, **OUT_TOL)


def test_pipeline_apply_backward_matches_jax(group):
    """Autograd through the GPipe schedule: the stack's gradient shares
    summed over the ranks equal JAX's gradient (AD through its schedule),
    each rank's share is its stage's row alone, and xs's gradient comes
    from stage 0 alone."""
    S, dim, n_micro, mb, seed = BACKWARD["backward"]
    inp = _stage_inputs(S, dim, n_micro, mb, seed)
    mesh = jpipe.make_pipeline_mesh(S, devices=jax.devices()[:S])
    xs, tgt = jnp.asarray(inp["xs"]), jnp.asarray(inp["tgt"])

    def loss(p, xs):
        return _mse(jpipe.pipeline_apply(_jax_stage_fn, p, xs, mesh), tgt)

    val, (g_p, g_xs) = jax.value_and_grad(loss, argnums=(0, 1))(
        _jax_params(inp), xs)
    parts = group.get("bwd_backward")
    for rank, p in enumerate(parts):
        np.testing.assert_allclose(float(p["loss"]), float(val), **LOSS_TOL)
        for key in ("w", "b"):
            others = np.delete(p[key], rank, axis=0)
            assert not others.any(), (rank, key)
    for key in ("w", "b"):
        np.testing.assert_allclose(_share_sum(parts, key),
                                   np.asarray(g_p[key]), **GRAD_TOL)
    assert [bool(p["xs_none"][0]) for p in parts] == [False] + [True] * 3
    np.testing.assert_allclose(parts[0]["xs"], np.asarray(g_xs), **GRAD_TOL)


# -- 1F1B ---------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_1f1b(name):
    S, dim, n_micro, mb, seed = ONE_F_ONE_B[name]
    inp = _stage_inputs(S, dim, n_micro, mb, seed)
    mesh = jpipe.make_pipeline_mesh(S, devices=jax.devices()[:S])
    params = _jax_params(inp)
    xs, tgt = jnp.asarray(inp["xs"]), jnp.asarray(inp["tgt"])
    loss, grads = jpipe.pipeline_value_and_grad(
        _jax_stage_fn, _mse, params, xs, tgt, mesh)

    def loss_seq(p):
        return jnp.mean(jax.vmap(_mse)(_jax_sequential(p, xs, S), tgt))

    ref_loss, ref_grads = jax.value_and_grad(loss_seq)(params)
    np.testing.assert_allclose(float(loss), float(ref_loss), **LOSS_TOL)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _stacked(parts, key):
    """Each stage's [1, ...] gradient stacked in stage order."""
    by_stage = {int(p["stage"][0]): p[key] for p in parts if p}
    return np.concatenate([by_stage[s] for s in sorted(by_stage)])


def _hold_1f1b(parts, loss, grads):
    for p in parts:
        if p:
            np.testing.assert_allclose(float(p["loss"]), loss, **LOSS_TOL)
    for key in ("w", "b"):
        np.testing.assert_allclose(_stacked(parts, key), grads[key],
                                   **GRAD_TOL)


@pytest.mark.parametrize("name", ["4x6", "2x9", "4x1"])
def test_one_f_one_b_matches_jax(group, name):
    """pipeline_value_and_grad: the mean loss on every stage and each
    stage's gradient against JAX's 1F1B (itself held to the sequential
    composition); the bubble is the schedule's (2 slots a tick over
    n_micro + 2S - 1 ticks, 2 n_micro of them filled)."""
    loss, grads = _jax_1f1b(name)
    S, _, n_micro, _, _ = ONE_F_ONE_B[name]
    parts = group.get(f"1f1b_{name}")
    assert sum(1 for p in parts if p) == S
    _hold_1f1b(parts, loss, grads)
    for p in parts:
        if p:
            assert list(p["slots"]) == [2 * (n_micro + 2 * S - 1),
                                        2 * n_micro]


def test_one_f_one_b_repeats_exactly(group):
    """JAX's jit-compiles-once case: the same step twice gives the same
    bits, finite, and equal to JAX's jitted step."""
    S, dim, n_micro, mb, seed = ONE_F_ONE_B["repeat"]
    inp = _stage_inputs(S, dim, n_micro, mb, seed)
    mesh = jpipe.make_pipeline_mesh(S, devices=jax.devices()[:S])
    step = jax.jit(lambda p, xs, tgt: jpipe.pipeline_value_and_grad(
        _jax_stage_fn, _mse, p, xs, tgt, mesh))
    loss, grads = step(_jax_params(inp), jnp.asarray(inp["xs"]),
                       jnp.asarray(inp["tgt"]))
    a, b = group.get("1f1b_repeat"), group.get("1f1b_repeat_again")
    for x, y in zip(a, b):
        for key in ("loss", "w", "b"):
            assert np.isfinite(x[key]).all()
            np.testing.assert_array_equal(x[key], y[key])
    _hold_1f1b(a, float(loss), {k: np.asarray(v) for k, v in grads.items()})


@pytest.mark.parametrize("control", ["ctl_no_cotangent",
                                     "ctl_seed_every_rank"])
def test_controls_fail_the_check(group, control):
    """Phase 20's two controls on the 4 x 6 case: stages 0-2 seeded with
    zeros (the cotangent not passed up the ring), and the loss's
    cotangent counted on all 4 ranks; each must fail the gradient check
    that the real schedule passes."""
    loss, grads = _jax_1f1b("4x6")
    parts = group.get(control)
    with pytest.raises(AssertionError):
        for key in ("w", "b"):
            np.testing.assert_allclose(_stacked(parts, key), grads[key],
                                       **GRAD_TOL)


def test_pipeline_rejects_stage_count_mismatch(group):
    """JAX's ValueError (params stacked for 8 stages on a 4-stage mesh)
    from both functions, in the group and in one process."""
    r = group.get("mismatch")[0]
    assert "leading dim" in str(r["apply"][0])
    assert "leading dim" in str(r["vg"][0])
    with pytest.raises(ValueError, match="leading dim"):
        jpipe.pipeline_apply(
            _jax_stage_fn, {"w": jnp.zeros((8, 4, 4)),
                            "b": jnp.zeros((8, 4))},
            jnp.zeros((2, 2, 4)), jpipe.make_pipeline_mesh(4))
    mesh = tpipe.make_pipeline_mesh()       # one process: 1 stage
    assert mesh.shape == {"stage": 1}
    for fn in (lambda p: tpipe.pipeline_apply(
                   lambda q, x: x, p, torch.zeros(2, 1), mesh),
               lambda p: tpipe.pipeline_value_and_grad(
                   lambda q, x: x, lambda y, a: y.sum(), p,
                   torch.zeros(2, 1), torch.zeros(2), mesh)):
        with pytest.raises(ValueError, match="leading dim"):
            fn({"w": torch.zeros(2, 3)})
        with pytest.raises(ValueError, match="leading dim"):
            fn({"w": torch.zeros(())})


def test_microbatch_matches_jax():
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    np.testing.assert_array_equal(
        tpipe.microbatch(torch.from_numpy(x), 3).numpy(),
        np.asarray(jpipe.microbatch(jnp.asarray(x), 3)))
    for fn, arr in ((tpipe.microbatch, torch.from_numpy(x)),
                    (jpipe.microbatch, jnp.asarray(x))):
        with pytest.raises(ValueError, match="not divisible"):
            fn(arr, 4)


def test_stack_and_stage_params_from_jax():
    """stack_stage_params stacks like JAX's; stage_params_from_jax takes
    JAX per-stage pytrees (as numpy) to the same stacked tensors."""
    inp = _stage_inputs(3, 4, 1, 1, 11)
    per = [{"w": inp["w"][s], "b": {"c": inp["b"][s]}} for s in range(3)]
    ref = jpipe.stack_stage_params(per)
    got = tpipe.stack_stage_params(jax.tree.map(torch.from_numpy, per))
    conv = tpipe.stage_params_from_jax(per, device="cpu")
    for tree in (got, conv):
        np.testing.assert_array_equal(tree["w"].numpy(), ref["w"])
        np.testing.assert_array_equal(tree["b"]["c"].numpy(), ref["b"]["c"])
    bf = tpipe.stage_params_from_jax(per, device="cpu",
                                     dtype=torch.bfloat16)
    assert bf["w"].dtype == torch.bfloat16


# -- the transformer stage ------------------------------------------------------

def _jax_lm(attention):
    """JAX's 1F1B over the same 2-layer stages (JAX's own layer math)."""
    inp = _lm_inputs()
    cfg = jtf.TransformerConfig(**LM_DIMS, n_layers=LM_STAGES * LM_LAYERS,
                                attention=attention)
    stacked = {k.split(".", 1)[1]: jnp.asarray(v.reshape(
        (LM_STAGES, LM_LAYERS) + v.shape[1:]))
        for k, v in inp.items() if k.startswith("layers.")}
    embed, ln_f = jnp.asarray(inp["embed"]), jnp.asarray(inp["ln_f_g"])

    def stage_fn(p, h):
        for i in range(LM_LAYERS):
            layer = jax.tree.map(lambda w: w[i], p)
            x = jtf._rmsnorm(h, layer["ln1_g"])
            h = h + jtf._attention(x @ layer["w_q"], x @ layer["w_k"],
                                   x @ layer["w_v"], cfg.n_heads,
                                   cfg.attention) @ layer["w_o"]
            x = jtf._rmsnorm(h, layer["ln2_g"])
            h = h + jax.nn.gelu(x @ layer["w_ff1"]) @ layer["w_ff2"]
        return h

    def loss_fn(h, t):
        logits = jnp.einsum("btd,vd->btv", jtf._rmsnorm(h, ln_f), embed)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, t[..., None], axis=-1))

    mesh = jpipe.make_pipeline_mesh(LM_STAGES,
                                    devices=jax.devices()[:LM_STAGES])
    loss, grads = jpipe.pipeline_value_and_grad(
        stage_fn, loss_fn, stacked, jnp.asarray(inp["xs"]),
        jnp.asarray(inp["tgt"], jnp.int32), mesh)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("attention", ATTENTIONS)
def test_transformer_stages_match_jax_and_one_process(group, attention):
    """4 stages of 2 flagship-style layers (pre-LN, tied logits as the
    loss): the port's 1F1B against JAX's on the same stages, and against
    one process running every microbatch through the 8 layers in order
    with autograd (its mean loss and gradients)."""
    loss, grads = _jax_lm(attention)
    parts = group.get(f"lm_{attention}")
    single = group.get(f"lm_single_{attention}")[0]
    np.testing.assert_allclose(float(single["loss"]), loss, **LM_TOL)
    for p in parts:
        np.testing.assert_allclose(float(p["loss"]), loss, **LM_TOL)
        np.testing.assert_allclose(float(p["loss"]), float(single["loss"]),
                                   **LM_TOL)
    for key, ref in grads.items():
        got = np.concatenate([p[key] for p in parts])   # ranks = stages
        np.testing.assert_allclose(got, ref, **LM_TOL)
        np.testing.assert_allclose(got.reshape(single[key].shape),
                                   single[key], **LM_TOL)


# -- gating ---------------------------------------------------------------------

def _gate_both(logits: np.ndarray, capacity: int, dtype=np.float32):
    j = jmoe.top1_gating(jnp.asarray(logits, dtype), capacity)
    t = tmoe.top1_gating(torch.from_numpy(
        np.asarray(logits, np.float32)).to(
            torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32),
        capacity)
    return ([np.asarray(a, np.float32) for a in j],
            [a.float().numpy() for a in t])


def test_capacity_drops_overflow():
    """Everyone wants expert 0: 2 of 5 tokens dropped, the kept ones in
    distinct slots; dispatch, combine and aux equal JAX's."""
    logits = np.zeros((5, 2), np.float32)
    logits[:, 0] = 10.0
    (jd, jc, ja), (d, c, a) = _gate_both(logits, 3)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_allclose(a, ja, **MOE_TOL)
    assert d.sum() == 3.0 and d[:, 1].sum() == 0.0
    assert np.array_equal(d[:3, 0].argmax(-1), [0, 1, 2])
    assert np.all(c <= 1.0)


def test_every_token_routed_when_ample():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((16, 4)).astype(np.float32)
    (jd, jc, ja), (d, c, a) = _gate_both(logits, 16)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_allclose(c, jc, **MOE_TOL)
    np.testing.assert_allclose(a, ja, **MOE_TOL)
    assert d.sum() == 16.0 and float(a) > 0.0


def test_gating_positions_exact_in_bf16():
    """Slot counters stay int32: 400 bf16 tokens all on expert 0 fill 400
    distinct slots, as JAX's do."""
    n_tokens = 400
    logits = np.zeros((n_tokens, 2), np.float32)
    logits[:, 0] = 10.0
    (jd, _, _), (d, _, _) = _gate_both(logits, n_tokens, jnp.bfloat16)
    np.testing.assert_array_equal(d, jd)
    assert d.sum() == n_tokens
    assert len(set(d[:, 0].argmax(-1).tolist())) == n_tokens


def test_gating_drops_and_positions_match_jax():
    """Under a tight capacity, the same tokens dropped and the same slots
    as JAX, in f32 and bf16: each token's expert drawn at random and its
    logit 4 over the others' (in [-1, 1]), so no bf16 rounding of the
    gates can tie two experts."""
    rng = np.random.default_rng(12)
    logits = rng.uniform(-1.0, 1.0, (300, 8)).astype(np.float32)
    logits[np.arange(300), rng.integers(0, 8, 300)] = 4.0
    for dtype in (np.float32, jnp.bfloat16):
        (jd, _, _), (d, _, _) = _gate_both(logits, 20, dtype)
        np.testing.assert_array_equal(d, jd)
        assert 0 < d.sum() < 300


def test_init_moe_params_bitwise():
    for seed, (E, d, h) in ((0, (8, 8, 16)), (5, (16, 4, 8))):
        jr, jp = jmoe.init_moe_params(np.random.default_rng(seed), E, d, h)
        tr, tp = tmoe.init_moe_params(np.random.default_rng(seed), E, d, h,
                                      device="cpu")
        assert tr.dtype == torch.float32
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        for k in ("w1", "w2"):
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


def test_mlp_expert_matches_jax():
    """One expert, and the expert dim written out as a batch dim (JAX's
    vmap)."""
    inp = _moe_inputs(4, 8, 16, 10, 21)
    ep = {k: np.array(inp[k]) for k in ("w1", "w2")}   # writable copies
    x = np.stack([inp["x"]] * 4)
    ref = np.asarray(jax.vmap(jmoe.mlp_expert)(
        jax.tree.map(jnp.asarray, ep), jnp.asarray(x)))
    got = tmoe.mlp_expert(jax.tree.map(torch.from_numpy, ep),
                          torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, **MOE_TOL)
    one = tmoe.mlp_expert({k: torch.from_numpy(v[1]) for k, v in ep.items()},
                          torch.from_numpy(inp["x"])).numpy()
    np.testing.assert_allclose(one, ref[1], **MOE_TOL)


# -- moe_apply ------------------------------------------------------------------

def _dense_reference(router_w, ep, x):
    """tests/test_pipeline_moe.py's dense per-token reference."""
    gates = jax.nn.softmax(x @ router_w, axis=-1)
    idx = np.asarray(jnp.argmax(gates, axis=-1))
    y = np.zeros(x.shape, np.float32)
    for t in range(x.shape[0]):
        p = jax.tree.map(lambda l, e=idx[t]: l[e], ep)
        y[t] = np.asarray(jmoe.mlp_expert(p, x[None, t])[0]) * float(
            gates[t, idx[t]])
    return y


@functools.lru_cache(maxsize=None)
def _jax_moe(name):
    E, d, h, tokens, seed, cf = MOE[name]
    inp = _moe_inputs(E, d, h, tokens, seed)
    mesh = jax_make_mesh((N,), axis_names=(jmoe.EXPERT_AXIS,),
                         devices=jax.devices()[:N])
    ep = {k: jnp.asarray(inp[k]) for k in ("w1", "w2")}
    rw, x = jnp.asarray(inp["router"]), jnp.asarray(inp["x"])

    def loss(ep, rw):
        y, aux = jmoe.moe_apply(jmoe.mlp_expert, ep, rw, x, mesh,
                                capacity_factor=cf)
        return jnp.sum(y ** 2) + 0.01 * aux, (y, aux)

    (_, (y, aux)), (g_ep, g_rw) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(ep, rw)
    return inp, np.asarray(y), float(aux), np.asarray(g_rw), \
        {k: np.asarray(v) for k, v in g_ep.items()}


@pytest.mark.parametrize("name", ["E8", "E16"])
def test_moe_matches_jax_and_dense_reference(group, name):
    """Ample capacity (cf = E): nothing dropped, so the output equals the
    dense per-token reference; y and aux equal JAX's moe_apply."""
    inp, y, aux, _, _ = _jax_moe(name)
    parts = group.get(f"moe_{name}")
    got = np.concatenate([p["y"] for p in parts])   # rank r: rows r T/4..
    np.testing.assert_allclose(got, y, **MOE_TOL)
    ref = _dense_reference(jnp.asarray(inp["router"]),
                           {k: jnp.asarray(inp[k]) for k in ("w1", "w2")},
                           jnp.asarray(inp["x"]))
    np.testing.assert_allclose(got, ref, **MOE_TOL)
    for p in parts:
        np.testing.assert_allclose(float(p["aux"]), aux, **MOE_TOL)
        assert float(p["aux"]) > 0.0


@pytest.mark.parametrize("name", ["E8", "E16", "grad"])
def test_moe_gradients_match_jax(group, name):
    """Gradients of sum(y^2) + 0.01 aux: the router's shares summed over
    the ranks, and each expert's from its owner (rank r holds experts
    [r E/4, (r+1) E/4)), against JAX's (the "grad" case at capacity
    factor 2.0, where tokens are dropped)."""
    E = MOE[name][0]
    _, _, _, g_rw, g_ep = _jax_moe(name)
    parts = group.get(f"moe_{name}")
    np.testing.assert_allclose(_share_sum(parts, "router"), g_rw,
                               **MOE_TOL)
    per = E // N
    for key in ("w1", "w2"):
        got = np.concatenate([p[key][r * per:(r + 1) * per]
                              for r, p in enumerate(parts)])
        np.testing.assert_allclose(got, g_ep[key], **MOE_TOL)
        for r, p in enumerate(parts):
            assert not np.delete(p[key], np.s_[r * per:(r + 1) * per],
                                 axis=0).any()


def test_moe_refuses_uneven_splits(group):
    """JAX's two ValueErrors: E not divisible by the axis, T not
    divisible by it."""
    r = group.get("moe_refused")[0]
    assert "E=6 not divisible by mesh axis expert=4" in str(r["experts"][0])
    assert "token count T=6 not divisible" in str(r["tokens"][0])
