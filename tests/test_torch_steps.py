"""The port's `launch/steps.py` factories against the JAX package's (the
contract of tests/test_system.py: the split loss in logits and fused mode,
the K-client train step with microbatches and FedAvg, and the prefill and
decode steps), on bridged weights of the reduced Qwen2.5 (3 layers,
d_model 64, vocab 128, prompt 4). The f32 comparisons set the JAX module's
`ACT_DTYPE` to float32 with monkeypatch, as the port's."""
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import repro.launch.steps as jsteps  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import SplitConfig as JSplitConfig  # noqa: E402
from repro.core import SplitModel as JSplitModel  # noqa: E402
from repro.runtime import WireSpec as JWireSpec  # noqa: E402
import repro_torch.launch.steps as tsteps  # noqa: E402
from repro_torch.bridge import jax_to_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import SplitConfig, SplitModel  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.runtime import WireSpec  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
SPLIT = dict(head_cycles=1, tail_cycles=1, prompt_len=4)
VOCAB = 128


def _cfg(get):
    return get("qwen2.5-14b").reduced(n_layers=3, d_model=64, d_ff=128,
                                      vocab_size=VOCAB)


def _models(wire="fp32"):
    return (JSplitModel(_cfg(jget_config), JSplitConfig(**SPLIT),
                        JWireSpec.make(wire)),
            SplitModel(_cfg(get_config), SplitConfig(**SPLIT),
                       WireSpec.make(wire)))


@pytest.fixture(scope="module")
def setup():
    jm, tm = _models()
    params = jm.init(jax.random.PRNGKey(0))
    return jm, tm, params, jax_to_torch(params, "cpu")


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(jsteps, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(tsteps, "ACT_DTYPE", torch.float32)


def _split(params):
    return ({"head": params["head"], "body": params["body"]},
            {"tail": params["tail"], "prompt": params["prompt"]})


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, shape).astype(
        np.int32)


def _assert_tree_close(t_tree, j_tree, **tol):
    jflat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, j_tree))[0]
    assert len(jflat) == len(tree_leaves(t_tree))
    for path, leaf in jflat:
        node = t_tree
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node.detach().numpy(), leaf,
                                   err_msg=jax.tree_util.keystr(path), **tol)


@pytest.mark.parametrize("wire", ["fp32", "int8"])
@pytest.mark.parametrize("mode", ["logits", "fused"])
def test_split_loss_matches_jax_at_f32(f32, mode, wire):
    """Both cut points cross the wire (int8: round to nearest, as JAX
    without a key); logits and fused mode within 1e-5 of JAX's."""
    jm, tm = _models(wire)
    params = jm.init(jax.random.PRNGKey(1))
    (jf, jt), (tf, tt) = _split(params), _split(jax_to_torch(params, "cpu"))
    toks = _tokens((2, 16))
    want = jsteps.make_split_loss(jm, loss_mode=mode, remat=False)(
        jt, jf, {"tokens": jnp.asarray(toks)})
    got = tsteps.make_split_loss(tm, loss_mode=mode, remat=False)(
        tt, tf, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_split_loss_gradient_matches_jax_at_f32(f32, setup):
    """The gradient of the logits-mode loss w.r.t. (tail, prompt), through
    both wire boundaries, within 1e-5 of JAX's."""
    jm, tm, params, tparams = setup
    (jf, jt), (tf, tt) = _split(params), _split(tparams)
    toks = _tokens((2, 16), seed=1)
    jg = jax.grad(lambda tr: jsteps.make_split_loss(jm, remat=False)(
        tr, jf, {"tokens": jnp.asarray(toks)}))(jt)
    from repro_torch.core.local_update import value_and_grad
    loss = tsteps.make_split_loss(tm, remat=False)
    _, _, tg = value_and_grad(
        lambda tr, b: (loss(tr, tf, b), None), tt,
        {"tokens": torch.from_numpy(toks)})
    _assert_tree_close(tg, jg, **TOL)


def test_fused_loss_within_jax_tolerance_of_logits_at_bf16(setup):
    """At the default bf16 activations, fused mode is within JAX's own
    0.05 of logits mode (tests/test_system.py), and the port's logits-mode
    loss within the same of JAX's."""
    jm, tm, params, tparams = setup
    assert tsteps.ACT_DTYPE == torch.bfloat16
    (jf, jt), (tf, tt) = _split(params), _split(tparams)
    toks = _tokens((2, 16), seed=2)
    tb = {"tokens": torch.from_numpy(toks)}
    l_logits = float(tsteps.make_split_loss(tm, remat=False)(tt, tf, tb))
    l_fused = float(tsteps.make_split_loss(tm, loss_mode="fused",
                                           remat=False)(tt, tf, tb))
    j_logits = float(jsteps.make_split_loss(jm, remat=False)(
        jt, jf, {"tokens": jnp.asarray(toks)}))
    assert abs(l_logits - l_fused) < 0.05
    assert abs(l_logits - j_logits) < 0.05


def test_train_step_matches_jax(f32, setup):
    """K 2 clients, microbatches 2: each accumulates, steps SGD with
    momentum 0.9, then FedAvg with unit weights; params within 1e-5 of
    JAX's jitted step, the K copies identical, the loss within 1e-5."""
    jm, tm, params, tparams = setup
    K, b, S = 2, 4, 16
    toks = _tokens((K, b, S), seed=3)
    jstep, jopt = jsteps.make_train_step(jm, n_clients=K, microbatches=2)
    jf, jt = _split(params)
    jtk = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (K,) + x.shape),
                       jt)
    jtr2, jos2, jloss = jax.jit(jstep)(jf, jtk, jax.vmap(jopt.init)(jtk),
                                       {"tokens": jnp.asarray(toks)})
    tstep, topt = tsteps.make_train_step(tm, n_clients=K, microbatches=2)
    tf, _ = _split(tparams)
    ttk = jax_to_torch(jtk, "cpu")
    before = launch_counts()
    ttr2, tos2, tloss = tstep(tf, ttk, tsteps.init_opt_states(topt, ttk),
                              {"tokens": torch.from_numpy(toks)})
    assert launch_counts() == before
    _assert_tree_close(ttr2, jtr2, **TOL)
    _assert_tree_close(tos2["mom"], jos2["mom"], **TOL)
    np.testing.assert_array_equal(tos2["step"].numpy(),
                                  np.asarray(jos2["step"]))
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    for leaf in tree_leaves(ttr2):
        assert torch.equal(leaf[0], leaf[1])


def test_prefill_and_decode_steps_match_jax(setup):
    """f32 activations: last-position logits of prefill and the decode
    step's logits within 1e-5 of JAX's, the greedy next tokens `==`, wire
    bytes `==`, and the caches written in place."""
    jm, tm, params, tparams = setup
    B, S = 2, 12
    toks = _tokens((B, S), seed=4)
    kw = dict(dtype=jnp.float32, with_wire_bytes=True)
    jpre, jdec = (jsteps.make_prefill_step(jm, **kw),
                  jsteps.make_decode_step(jm, **kw))
    kw = dict(dtype=torch.float32, with_wire_bytes=True)
    tpre, tdec = (tsteps.make_prefill_step(tm, donate_cache=True, **kw),
                  tsteps.make_decode_step(tm, donate_cache=True, **kw))
    jc = jm.init_cache(B, seq_len=48)
    tc = tm.init_cache(B, seq_len=48, device="cpu")
    jlg, jc, jb = jax.jit(jpre)(params, {"tokens": jnp.asarray(toks)}, jc)
    tlg, tc2, tb = tpre(tparams, {"tokens": torch.from_numpy(toks)}, tc)
    # the cache leaves are the ones handed in, written in place
    assert all(a is b for a, b in zip(tree_leaves(tc2), tree_leaves(tc)))
    assert tlg.shape == (B, VOCAB) and not tlg.requires_grad
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
    assert tb == {k: float(v) for k, v in jb.items()}
    nxt = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
    np.testing.assert_array_equal(tlg.argmax(-1).numpy(), nxt)
    pos = np.full((B,), S + SPLIT["prompt_len"], np.int32)
    for _ in range(2):
        jn, jl2, jc, jb = jax.jit(jdec)(
            params, {"tokens": jnp.asarray(nxt[:, None]),
                     "pos": jnp.asarray(pos)}, jc)
        tn, tl2, tc, tb = tdec(tparams, {
            "tokens": torch.from_numpy(nxt[:, None]),
            "pos": torch.from_numpy(pos)}, tc)
        assert tn.dtype == torch.int32
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)
        assert tb == {k: float(v) for k, v in jb.items()}
        nxt, pos = np.array(jn), pos + 1


def test_step_factories_take_the_jax_arguments(setup):
    """`impl`, `remat`, `unroll` and `donate_cache` are accepted; an
    unknown impl or loss mode is refused."""
    _, tm, _, _ = setup
    for impl in ("auto", "ref", "pallas", "interpret"):
        tsteps.make_prefill_step(tm, impl=impl, unroll=True,
                                 donate_cache=True)
        tsteps.make_train_step(tm, n_clients=2, impl=impl, remat=False,
                               unroll=True)
    with pytest.raises(ValueError, match="impl"):
        tsteps.make_decode_step(tm, impl="xla")
    with pytest.raises(ValueError, match="loss_mode"):
        tsteps.make_split_loss(tm, loss_mode="chunked")
