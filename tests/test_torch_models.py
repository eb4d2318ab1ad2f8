"""The port's unsplit `Transformer` against the JAX package's, on bridged
weights: tests/test_models.py's seven contracts for every assigned family
(qwen2.5, gemma2, nemotron, stablelm, phi3.5-moe, deepseek-v3, zamba2,
rwkv6, whisper, qwen2-vl) and the ViT classifier, at the port tests'
reduced width (`reduced(d_model=64, d_ff=128, vocab_size=128)`, the layer
counts of tests/test_models.py). At `reduced()`'s default width 256 rwkv6's
gradient is ill-conditioned in f32 in both packages: at one RWKV-6 layer
JAX's gradient of the `k` weights is 9.6e-5 and the port's 1.8e-4 from a
float64 evaluation (max 17), and the embedding gradients of the model end
2.7e-5 apart, so no two f32 evaluations meet 1e-5 there; at width 64 they
are 5.4e-7 apart.

1. the train-mode forward: logits (and deepseek-v3's MTP logits, and the
   MoE aux loss) within 1e-5 of JAX's;
2. one SGD step on the task loss (the MoE aux loss and the MTP term
   included): loss and every gradient within 1e-5, and the loss after
   the step;
3. prefill then one decode step against the cache equals the full
   forward's last position (2e-4, as tests/test_models.py), and the
   decode logits equal JAX's within 1e-5;
4. gemma2's ring-buffer decode (cache of the sliding window) equals the
   full-cache decode;
5. stablelm's greedy 4-step decode equals the teacher-forced forward;
6. zamba2's shared attention block is one parameter set;
7. the analytic `param_count` is within 2% of a `meta` init of every
   full-size config.

Whisper's batches carry `frames` (its reduced encoder's 16), qwen2-vl's 8
`patch_embeds` and their (2, 2, 2) grid's M-RoPE positions, as
tests/test_models.py's do; qwen2-vl's decode check prefills the patches
too (no grid positions) and decodes at S + 8.

The MoE families' router margins (the smallest gap between a token's k-th
and (k+1)-th router probability) are asserted above 1e-4
(tests/test_torch_moe.py): a smaller one could let the packages' fp32
difference flip an expert choice."""
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from test_torch_moe import assert_margin, margin_probe  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.models.transformer import Transformer as JTransformer  # noqa: E402
from repro.optim import apply_updates as japply  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro_torch.bridge import jax_to_torch  # noqa: E402
from repro_torch.configs import ASSIGNED, get_config  # noqa: E402
from repro_torch.core import losses  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.optim import apply_updates, sgd  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
FAMILIES = list(ASSIGNED) + ["vit-base"]
MOE = ("phi3.5-moe-42b-a6.6b", "deepseek-v3-671b")
KEY = jax.random.PRNGKey(0)
SIZE = dict(d_model=64, d_ff=128, vocab_size=128)
_BUILT = {}


def build(arch):
    """(JAX model, port model, JAX params, bridged params) at
    tests/test_models.py's `reduced()` config, built once per arch."""
    if arch not in _BUILT:
        jm = JTransformer(jget_config(arch).reduced(**SIZE))
        tm = Transformer(get_config(arch).reduced(**SIZE))
        params = jax.jit(jm.init)(KEY)
        _BUILT[arch] = (jm, tm, params, jax_to_torch(params, "cpu"))
    return _BUILT[arch]


def make_batch(cfg, B=2, S=24, seed=1):
    """Draw 1 for every family: at draw 0 a token's k-th and (k+1)-th
    router probabilities lie 2.8e-5 (phi3.5-moe) and 5.1e-5 (deepseek-v3)
    apart, below the margin held here."""
    rng = np.random.default_rng(seed)
    if cfg.arch_type == "vit":
        return {"patches": (0.1 * rng.standard_normal(
                    (B, 16, 16 * 16 * 3))).astype(np.float32),
                "labels": rng.integers(0, cfg.num_classes, B).astype(
                    np.int32)}
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    batch.update(modality(cfg, rng, B))
    return batch


def modality(cfg, rng, B, grid=True):
    """Whisper's frames, or qwen2-vl's 8 patch embeddings and (with
    `grid`) their M-RoPE positions on a (2, 2, 2) grid, stored (B, 3, 8)."""
    if cfg.arch_type == "audio":
        return {"frames": (0.02 * rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model))).astype(np.float32)}
    if cfg.arch_type != "vlm":
        return {}
    out = {"patch_embeds": (0.02 * rng.standard_normal(
        (B, 8, cfg.d_model))).astype(np.float32)}
    if grid:
        g = np.stack(np.meshgrid(np.arange(2), np.arange(2), np.arange(2),
                                 indexing="ij")).reshape(3, 8)
        out["mrope_positions"] = np.ascontiguousarray(
            np.broadcast_to(g[None], (B, 3, 8)), dtype=np.int32)
    return out


def _probe(arch):
    return margin_probe() if arch in MOE else _NoProbe()


class _NoProbe:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def _check_margin(arch, label, margins):
    if margins is not None:
        assert_margin(f"{arch} {label}", margins)


def _assert_tree_close(ttree, jtree):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert len(jflat) == len(tree_leaves(ttree))
    for path, leaf in jflat:
        node = ttree
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node.detach().numpy(), np.asarray(leaf),
                                   err_msg=jax.tree_util.keystr(path), **TOL)


_JAX_STEPS = {}


def jax_step(arch):
    """JAX's side of contracts 1 and 2, computed once an arch: the train
    forward's output, the task loss, its metrics and gradients, and the
    loss after one SGD step of 1e-2."""
    if arch not in _JAX_STEPS:
        jm, tm, params, _ = build(arch)
        jbatch = jax.tree.map(jnp.asarray, make_batch(tm.cfg))

        def jloss(p):
            out = jm.apply(p, jbatch, mode="train")
            loss, metrics = jlosses.task_loss(jm.cfg, out, jbatch,
                                              impl="ref")
            return loss, (metrics, out)

        step = jax.jit(jax.value_and_grad(jloss, has_aux=True))
        (jl, (jmetrics, jout)), jg = step(params)
        jopt = jsgd(1e-2)
        jup, _ = jopt.update(jg, jopt.init(params), params)
        jl1 = step(japply(params, jup))[0][0]
        _JAX_STEPS[arch] = dict(loss=jl, metrics=jmetrics, out=jout,
                                grads=jg, loss_after=jl1)
    return _JAX_STEPS[arch]


# ------------------------------------------------------------ 1. forward
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_jax(arch):
    jm, tm, params, tparams = build(arch)
    batch = make_batch(tm.cfg)
    jout = jax_step(arch)["out"]
    with _probe(arch) as margins:
        tout = tm.apply(tparams, tree_map(torch.from_numpy, batch),
                        mode="train")
    _check_margin(arch, "forward", margins)
    assert tout["logits"].shape[-1] == (tm.cfg.num_classes
                                        or tm.cfg.vocab_size)
    assert torch.isfinite(tout["logits"]).all()
    np.testing.assert_allclose(tout["logits"].numpy(),
                               np.asarray(jout["logits"]), **TOL)
    np.testing.assert_allclose(float(tout["aux_loss"]),
                               float(jout["aux_loss"]), **TOL)
    assert (arch in MOE) == (float(tout["aux_loss"]) > 0)
    assert set(tout) - {"cache"} == set(jout)
    if "mtp_logits" in jout:
        np.testing.assert_allclose(tout["mtp_logits"].numpy(),
                                   np.asarray(jout["mtp_logits"]), **TOL)


# --------------------------------------------------------- 2. train step
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_jax(arch):
    """The task loss (with the MoE aux loss and, for deepseek-v3, the MTP
    term at weight 0.3), every gradient, and the loss after one SGD step
    of 1e-2."""
    jm, tm, params, tparams = build(arch)
    tbatch = tree_map(torch.from_numpy, make_batch(tm.cfg))

    def tloss(p):
        out = tm.apply(p, tbatch, mode="train", differentiable=True)
        return losses.task_loss(tm.cfg, out, tbatch)

    want = jax_step(arch)
    jl, jmetrics, jg = want["loss"], want["metrics"], want["grads"]
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(tparams)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), tparams)
    with _probe(arch) as margins:
        tl, tmetrics = tloss(live)
    _check_margin(arch, "train step", margins)
    grads = torch.autograd.grad(tl, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    assert ("mtp_ce" in tmetrics) == ("mtp_ce" in jmetrics) \
        == (arch == "deepseek-v3-671b")
    if "mtp_ce" in jmetrics:
        np.testing.assert_allclose(float(tmetrics["mtp_ce"].detach()),
                                   float(jmetrics["mtp_ce"]), **TOL)
    it = iter(grads)
    tgrads = tree_map(lambda _: next(it), tparams)
    _assert_tree_close(tgrads, jg)
    assert sum(float(g.abs().sum()) for g in grads) > 0
    topt = sgd(1e-2)
    tup, _ = topt.update(tgrads, topt.init(tparams), tparams)
    with torch.no_grad():
        tl1, _ = tloss(apply_updates(tparams, tup))
    np.testing.assert_allclose(float(tl1), float(want["loss_after"]), **TOL)
    assert np.isfinite(float(tl1))


# ----------------------------------------------------- 3. decode == full
@pytest.mark.parametrize("arch", ASSIGNED)
def test_decode_matches_full_and_jax(arch):
    jm, tm, params, tparams = build(arch)
    B, S = 2, 16
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tm.cfg.vocab_size, (B, S + 1)).astype(np.int32)
    extra = modality(tm.cfg, rng, B, grid=False)
    n_extra = 8 if "patch_embeds" in extra else 0
    step = {"tokens": toks[:, S:S + 1],
            "pos": np.full((B,), S + n_extra, np.int32)}
    bfull = tree_map(torch.from_numpy, dict(extra, tokens=toks))
    bpre = tree_map(torch.from_numpy, dict(extra, tokens=toks[:, :S]))
    with _probe(arch) as margins:
        full = tm.apply(tparams, bfull, mode="train")["logits"]
        cache = tm.init_cache(B, seq_len=64, device="cpu")
        pre = tm.apply(tparams, bpre, mode="prefill", cache=cache)
        dec = tm.apply(tparams, tree_map(torch.from_numpy, step),
                       mode="decode", cache=pre["cache"])
    _check_margin(arch, "decode", margins)
    np.testing.assert_allclose(dec["logits"][:, 0].numpy(),
                               full[:, -1].numpy(), rtol=2e-4, atol=2e-4)
    jcache = jm.init_cache(B, seq_len=64)
    jpre = jax.jit(lambda p, b, c: jm.apply(p, b, mode="prefill", cache=c))(
        params, jax.tree.map(jnp.asarray, dict(extra, tokens=toks[:, :S])),
        jcache)
    jdec = jax.jit(lambda p, b, c: jm.apply(p, b, mode="decode", cache=c))(
        params, jax.tree.map(jnp.asarray, step), jpre["cache"])
    np.testing.assert_allclose(pre["logits"].numpy(),
                               np.asarray(jpre["logits"]), **TOL)
    np.testing.assert_allclose(dec["logits"].numpy(),
                               np.asarray(jdec["logits"]), **TOL)
    _assert_tree_close(dec["cache"], jdec["cache"])


# ------------------------------------------------------ 4. ring buffer
def test_ring_buffer_decode_matches_full_window():
    """gemma2 sliding-window decode with a ring-buffer cache of the window
    == full-cache decode (S < window, so the two see the same keys)."""
    jm, tm, params, tparams = build("gemma2-9b")
    cfg = tm.cfg
    B, S = 1, 40
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    step = {"tokens": torch.from_numpy(toks[:, S:S + 1]),
            "pos": torch.full((B,), S, dtype=torch.int32)}
    outs = []
    for window in (None, cfg.attention.sliding_window):
        cache = tm.init_cache(B, seq_len=S + 1, window=window, device="cpu")
        pre = tm.apply(tparams, {"tokens": torch.from_numpy(toks[:, :S])},
                       mode="prefill", cache=cache)
        outs.append(tm.apply(tparams, step, mode="decode",
                             cache=pre["cache"])["logits"][:, 0].numpy())
    assert tm.init_cache(B, seq_len=S + 1, window=cfg.attention
                         .sliding_window, device="cpu")["cycle"]["pos0"][
        "k"].shape[2] == min(S + 1, cfg.attention.sliding_window)
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-4, atol=2e-4)
    jcache = jm.init_cache(B, seq_len=S + 1,
                           window=cfg.attention.sliding_window)
    jpre = jm.apply(params, {"tokens": jnp.asarray(toks[:, :S])},
                    mode="prefill", cache=jcache)
    jdec = jm.apply(params, {"tokens": jnp.asarray(toks[:, S:S + 1]),
                             "pos": jnp.full((B,), S, jnp.int32)},
                    mode="decode", cache=jpre["cache"])
    np.testing.assert_allclose(outs[1], np.asarray(jdec["logits"][:, 0]),
                               **TOL)


# --------------------------------------------------- 5. multi-step decode
def test_multi_step_decode_consistency():
    """Greedy 4-step decode == teacher-forced full forward (stablelm)."""
    _, tm, _, tparams = build("stablelm-12b")
    B, S, n_new = 1, 12, 4
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tm.cfg.vocab_size, (B, S + n_new)).astype(np.int32))
    full = tm.apply(tparams, {"tokens": toks}, mode="train")["logits"]
    cache = tm.init_cache(B, seq_len=S + n_new, device="cpu")
    cache = tm.apply(tparams, {"tokens": toks[:, :S]}, mode="prefill",
                     cache=cache)["cache"]
    for i in range(n_new):
        out = tm.apply(tparams, {"tokens": toks[:, S + i:S + i + 1],
                                 "pos": torch.full((B,), S + i,
                                                   dtype=torch.int32)},
                       mode="decode", cache=cache)
        cache = out["cache"]
        np.testing.assert_allclose(out["logits"][:, 0].numpy(),
                                   full[:, S + i].numpy(), rtol=2e-4,
                                   atol=2e-4)


# ------------------------------------------------------ 6. weight sharing
def test_zamba2_weight_sharing():
    """The shared attention block is one parameter set used at every site,
    in the port's own init and in the bridged JAX params alike."""
    jm, tm, params, tparams = build("zamba2-2.7b")
    own = tm.init(torch.Generator().manual_seed(0), device="cpu")
    for tree in (own, tparams):
        assert "shared_attn" in tree
        for i, kind in enumerate(tm.cfg.layer_pattern):
            if kind == "shared_attn":
                assert f"pos{i}" not in tree["cycle"]
    assert jax.tree.structure(jax.tree.map(lambda x: 0, params)) == \
        jax.tree.structure(tree_map(lambda x: 0, own))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        node = own
        for p in path:
            node = node[p.key]
        assert tuple(leaf.shape) == tuple(node.shape), path


# ------------------------------------------------------- 7. param count
@pytest.mark.parametrize("arch", FAMILIES)
def test_param_count_sane(arch):
    """Analytic param_count within 2% of a `meta` init of the full-size
    config (nothing allocated), and equal to the JAX package's count of
    its own init's shapes."""
    cfg = get_config(arch)
    params = Transformer(cfg).init(torch.Generator(), device="meta")
    actual = sum(x.numel() for x in tree_leaves(params))
    assert abs(actual - cfg.param_count()) / actual < 0.02, \
        (arch, actual, cfg.param_count())
    jshapes = jax.eval_shape(JTransformer(jget_config(arch)).init, KEY)
    assert actual == sum(int(np.prod(s.shape))
                         for s in jax.tree.leaves(jshapes))


def test_transformer_defaults_to_cuda():
    """No entry point falls back to the CPU: without a card, the default
    device raises."""
    tm = Transformer(get_config("qwen2.5-14b").reduced())
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init(torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init_cache(1, 8)
