"""The port's LM training slice against the JAX package's, on the CPU.

Same weights in both packages (``init_params`` draws the same numpy
stream; ``params_from_jax`` carries a JAX pytree across, parameters and
the trainer's momentum alike), same token windows from a seeded numpy
generator, f32 throughout. ``attention="flash_force"`` runs JAX's Pallas
kernels in interpret mode and the port's plain versions; "reference" runs
both packages' plain attention. Tolerances: forward logits, losses and
gradients 1e-4 (the JAX suite's gradient tolerance); parameters and
momentum after three momentum-SGD steps 1e-4 absolute and relative, the
f32 rounding of two frameworks through three steps of lr 0.1.
"""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.apps import lm as jax_app
from multiverso_tpu.models import transformer as jtf
from multiverso_tpu_torch.apps import lm as port_app
from multiverso_tpu_torch.log import FatalError
from multiverso_tpu_torch.models import transformer as ttf

DIMS = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq=24)
TOL = dict(rtol=1e-4, atol=1e-4)
OFF = dict(prefill_token_budget=0, kv_block_size=0, decode_tp=1,
           prefix_cache=False, spec_k=0, kv_quant="none",
           decode_param_quant="none", prefill_sp=False, preempt=False,
           flight_recorder=False, watchdog=False, cost_ledger=False)


@pytest.fixture()
def port():
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.dashboard import Dashboard
    from multiverso_tpu_torch.runtime import Session

    Session._instance = None
    Dashboard.reset()
    mv.init(["test", "-device=cpu"])
    yield mv
    mv.shutdown()
    Session._instance = None
    mv.set_flag("device", "cuda")


def _cfgs(attention="reference"):
    return (jtf.TransformerConfig(**DIMS, attention=attention),
            ttf.TransformerConfig(**DIMS, attention=attention))


def _params(jcfg):
    jparams = jtf.init_params(jcfg)
    host = jax.tree.map(np.asarray, jparams)
    return jparams, ttf.params_from_jax(host, device="cpu")


def _tokens(batch, length, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, DIMS["vocab_size"], (batch, length)).astype(
        np.int32)


def _leaves(tree):
    """(dotted name, tensor) of every leaf of a parameter dict."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += [(f"{k}.{n}", w) for n, w in v.items()]
        else:
            out.append((k, v))
    return out


def _assert_tree_close(port_tree, jax_tree, **tol):
    got = dict(_leaves(port_tree))
    want = dict(_leaves(jax.tree.map(np.asarray, jax_tree)))
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w, **tol,
                                   err_msg=name)


@pytest.mark.parametrize("attention", ["reference", "flash_force"])
def test_forward_matches_jax(attention):
    jcfg, tcfg = _cfgs(attention)
    jparams, tparams = _params(jcfg)
    toks = _tokens(3, 24, seed=1)
    want = jtf.forward(jcfg, jparams, jnp.asarray(toks))
    got = ttf.forward(tcfg, tparams, torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == (3, 24, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("attention", ["reference", "flash_force"])
@pytest.mark.parametrize("length", [24, 25],
                         ids=["slice_logits", "slice_tokens"])
def test_loss_and_grads_match_jax(length, attention):
    """Both loss_fn branches: up to max_seq tokens the forward runs at full
    length and the logits are sliced; max_seq + 1 (the app's windows) runs
    the forward on tokens[:, :-1]. Gradients of every parameter too."""
    jcfg, tcfg = _cfgs(attention)
    jparams, tparams = _params(jcfg)
    toks = _tokens(2, length, seed=length)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, p, jnp.asarray(toks)))(jparams)
    leaves = [w.requires_grad_() for _, w in _leaves(tparams)]
    loss = ttf.loss_fn(tcfg, tparams, torch.from_numpy(toks).long())
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    named = {name: g for (name, _), g in zip(_leaves(tparams), grads)}
    for name, w in _leaves(jax.tree.map(np.asarray, jgrads)):
        np.testing.assert_allclose(named[name].numpy(), w, **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("attention", ["reference", "flash_force"])
def test_three_train_steps_match_jax(attention, mv_session, port):
    """Three train_batch steps of the JAX TransformerLM and the port's from
    the same init on the same windows: losses, parameters and momentum."""
    jcfg, tcfg = _cfgs(attention)
    jlm = jtf.TransformerLM(jcfg)
    tlm = ttf.TransformerLM(tcfg)
    _assert_tree_close(tlm.params, jlm.params, rtol=0, atol=0)
    windows = jax_app.batches(np.arange(400, dtype=np.int32) * 7 % 64, 3,
                              DIMS["max_seq"], seed=2)
    for step in range(3):
        toks = next(windows)
        jloss = float(jlm.train_batch(toks))
        tloss = tlm.train_batch(toks)
        np.testing.assert_allclose(tloss.item(), jloss, **TOL,
                                   err_msg=f"step {step}")
    assert tlm.version == jlm.version == 3
    _assert_tree_close(tlm.params, jlm.params, **TOL)
    _assert_tree_close(tlm._momentum, jlm._momentum, **TOL)
    # the JAX trainer's state carries across with params_from_jax and the
    # port steps on from it as JAX does
    host = jax.tree.map(np.asarray, jlm.params)
    tlm.params = ttf._map(lambda w: w.requires_grad_(),
                          ttf.params_from_jax(host, device="cpu"))
    tlm._momentum = ttf.params_from_jax(
        jax.tree.map(np.asarray, jlm._momentum), device="cpu")
    toks = next(windows)
    np.testing.assert_allclose(tlm.train_batch(toks).item(),
                               float(jlm.train_batch(toks)), **TOL)
    _assert_tree_close(tlm.params, jlm.params, **TOL)


def test_app_default_lr_diverges_at_the_flagship_width_in_both(
        mv_session, port):
    """At d_model 768 the app's default lr 0.1 (momentum 0.9) makes the
    loss rise from the first step, in the JAX reference and the port
    alike, step for step (so the card's training slice runs a lower lr)."""
    dims = dict(vocab_size=256, d_model=768, n_heads=12, n_layers=1,
                d_ff=3072, max_seq=32)
    jlm = jtf.TransformerLM(jtf.TransformerConfig(**dims))
    tlm = ttf.TransformerLM(ttf.TransformerConfig(**dims))
    text = port_app.load_bytes(jtf.__file__)   # real text: a source file
    windows = jax_app.batches(text, 4, 32, seed=0)
    losses = []
    for _ in range(3):
        toks = next(windows)
        losses.append((float(jlm.train_batch(toks)),
                       tlm.train_batch(toks).item()))
    np.testing.assert_allclose([t for _, t in losses],
                               [j for j, _ in losses], **TOL)
    assert losses[1][0] > 1.5 * losses[0][0]
    assert losses[1][1] > 1.5 * losses[0][1]


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    """Every way a tensor's value reaches the host raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("a tensor value was read on the host")
    for name in ("item", "tolist", "numpy", "__float__", "__int__",
                 "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    yield
    monkeypatch.undo()


def test_train_batch_returns_a_device_scalar_without_host_sync(
        port, monkeypatch):
    _, tcfg = _cfgs("flash_force")
    lm = ttf.TransformerLM(tcfg)
    toks = _tokens(2, 25, seed=4)
    with _no_host_reads(monkeypatch):
        loss = lm.train_batch(toks)
    assert isinstance(loss, torch.Tensor) and loss.shape == ()
    assert loss.grad_fn is None and not loss.requires_grad
    assert lm.version == 1
    assert np.isfinite(loss.item())


def test_train_batch_lowers_the_loss(port):
    """The app's path at a toy size: batches of a repetitive corpus, lr
    0.1, momentum 0.9 (the app's defaults); the mean loss of the last 5
    of 40 steps is below the first step's by at least 0.5."""
    cfg = ttf.TransformerConfig(vocab_size=256, d_model=32, n_heads=2,
                                n_layers=1, d_ff=64, max_seq=16,
                                attention="flash_force")
    lm = ttf.TransformerLM(cfg)
    data = np.frombuffer(b"the quick brown fox jumps over the lazy dog. "
                         * 40, np.uint8).astype(np.int32)
    gen = port_app.batches(data, 8, 16, seed=0)
    losses = [lm.train_batch(next(gen)).item() for _ in range(40)]
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < losses[0] - 0.5, losses


def test_batches_draw_the_jax_apps_windows():
    data = np.arange(1000, dtype=np.int32) % 251
    jgen = jax_app.batches(data, 4, 32, seed=3)
    tgen = port_app.batches(data, 4, 32, seed=3)
    for _ in range(3):
        np.testing.assert_array_equal(next(tgen), next(jgen))


def test_load_bytes_matches_jax_and_refuses_uris(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_bytes(bytes(range(256)) * 3)
    np.testing.assert_array_equal(port_app.load_bytes(str(path)),
                                  jax_app.load_bytes(str(path)))
    with pytest.raises(FatalError, match="io/stream"):
        port_app.load_bytes(f"file://{path}")


def _app_args(path, *extra):
    return ["-train_file", str(path), "-d_model", "32", "-n_layers", "1",
            "-n_heads", "2", "-seq", "16", "-batch", "4", *extra,
            "-device=cpu", "-log_level=error"]


def test_app_main_trains_and_samples(tmp_path, capsys):
    from multiverso_tpu_torch.runtime import Session

    path = tmp_path / "corpus.txt"
    path.write_bytes(b"hello multiverso, hello torch. " * 20)
    Session._instance = None
    try:
        assert port_app.main(_app_args(path, "-steps", "3", "-sample", "8",
                                       "-log_every", "1")) == 0
    finally:
        Session._instance = None
        importlib.import_module("multiverso_tpu_torch").set_flag("device",
                                                                 "cuda")
    out = capsys.readouterr().out
    assert "--- sample ---" in out
    text = out.split("--- sample ---\n", 1)[1]
    assert text.startswith("hello multiverso")


@pytest.mark.parametrize("extra,match", [
    (["-ckpt", "ckpt_dir"], "io/checkpoint"),
])
def test_app_main_refuses_checkpoints(tmp_path, extra, match):
    path = tmp_path / "corpus.txt"
    path.write_bytes(b"x" * 64)
    with pytest.raises(FatalError, match=match):
        port_app.main(_app_args(path, *extra))


def test_app_main_refuses_a_uri():
    from multiverso_tpu_torch.runtime import Session

    Session._instance = None
    try:
        with pytest.raises(FatalError, match="io/stream"):
            port_app.main(_app_args("hdfs://namenode/corpus.txt",
                                    "-steps", "1"))
    finally:
        Session._instance = None
        importlib.import_module("multiverso_tpu_torch").set_flag("device",
                                                                 "cuda")


def test_serving_a_trained_model_builds_no_graph(port):
    """Once the parameters require grad (a trainer's), serving must not
    build autograd graphs: the snapshot is detached, prefill, decode_step
    and greedy_decode save no tensor for backward even on the live
    parameters, and the engine serves the trained weights."""
    from multiverso_tpu_torch.serving import InferenceServer

    _, tcfg = _cfgs("flash_force")
    lm = ttf.TransformerLM(tcfg)
    assert all(w.requires_grad for w in ttf._leaves(lm.params))
    for _ in range(2):
        lm.train_batch(_tokens(2, 25, seed=5))
    snap, version = lm.snapshot_params()
    assert version == 2
    assert not any(w.requires_grad or w.grad_fn is not None
                   for w in ttf._leaves(snap))

    saved = []

    def pack(t):
        saved.append(t.shape)
        return t

    toks = torch.from_numpy(_tokens(1, 8, seed=6)).long()
    lengths = torch.tensor([8])
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        logits, ks, vs = ttf.prefill(tcfg, lm.params, toks)
        want = ttf.greedy_decode(tcfg, lm.params, toks, lengths, 6,
                                 slots=2, cache_len=16)
        logits_lm = lm.logits(toks)
    assert saved == []
    for t in (logits, ks, vs, want, logits_lm):
        assert t.grad_fn is None and not t.requires_grad

    srv = InferenceServer("t")
    srv.register_decoder("lm", lm, slots=2, max_prompt=8, max_new=6,
                         prompt_buckets=(8,), **OFF)
    try:
        reply = srv.submit("lm", {"prompt": toks[0].numpy(),
                                  "max_new": 6}).result(timeout=60)
    finally:
        srv.stop()
    np.testing.assert_array_equal(np.asarray(reply["result"]),
                                  want[0].numpy())
    assert reply["snapshot_version"] == 2
