"""The port's MoE block, Multi-head Latent Attention and the split model of
the two MoE families against the JAX package, on bridged weights.

`apply_moe` and its gradients (input, norm, router, experts, shared
expert) against `jax.grad` of JAX's at top-2 of 4 experts (phi3.5-moe's
routing, reduced) and top-8 of 16 with a shared expert (deepseek-v3's,
16 of its 256 experts); a row subset gives the rows of the full batch
(dropless dispatch); MLA prefill, ring-buffer decode and the latent caches
(`ckv`, `kr`, `positions`); `SplitModel` for phi3.5-moe and deepseek-v3
(dense prefix layer, MTP head in the tail): prefill and decode with every
cache leaf, train-mode forwards, the bridge key for key, segment sizes and
tail bytes; the paged engine's refusal with JAX's message.

Routing is discontinuous: where the k-th and (k+1)-th router
probabilities of a token are closer than the two packages' fp32
difference (about 1e-7), rounding can flip the choice and move the result
by O(1). Every case asserts the smallest such gap (the router margin)
above 1e-4 and prints it."""
import torch

torch.set_num_threads(2)

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import SplitConfig as JSplitConfig  # noqa: E402
from repro.core import SplitModel as JSplitModel  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.runtime import WireSpec as JWireSpec  # noqa: E402
from repro.serve import PagedServeConfig as JPagedServeConfig  # noqa: E402
from repro.serve import PagedServeEngine as JPagedServeEngine  # noqa: E402
from repro.serve import TenantBank as JTenantBank  # noqa: E402
from repro_torch.bridge import bank_from_arrays, jax_to_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import SplitConfig, SplitModel  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.runtime import WireSpec  # noqa: E402
from repro_torch.serve import (PagedServeConfig,  # noqa: E402
                               PagedServeEngine)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
MARGIN = 1e-4
ARCHS = ["phi3.5-moe-42b-a6.6b", "deepseek-v3-671b"]
PROMPT_LEN = 4


def family_cfg(get, arch):
    """The reduced family: 3 MoE layers (deepseek-v3 also its dense prefix
    layer), d_model 64, vocab 128; top-2 of 4 experts."""
    return get(arch).reduced(n_layers=3, d_model=64, d_ff=128,
                             vocab_size=128)


@contextlib.contextmanager
def margin_probe():
    """Record the router margin of every `apply_moe` call the port makes
    inside the block; yields the list of margins."""
    margins, inner = [], L.apply_moe

    def probe(p, cfg, x, *mesh):
        margins.append(L.router_margin(p, cfg, x))
        return inner(p, cfg, x, *mesh)
    L.apply_moe = probe
    try:
        yield margins
    finally:
        L.apply_moe = inner


def assert_margin(label, margins, floor=None):
    """Print the smallest of `margins` and assert it above `floor`
    (default `MARGIN`)."""
    assert margins, f"{label}: no MoE call was probed"
    low = min(margins)
    print(f"{label}: router margin {low:.3g} over {len(margins)} MoE calls")
    assert low > (MARGIN if floor is None else floor), (label, low)
    return low


def _assert_tree_close(ttree, jtree, **tol):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert len(jflat) == len(tree_leaves(ttree))
    for path, leaf in jflat:
        node = ttree
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node.detach().numpy(), np.asarray(leaf),
                                   err_msg=jax.tree_util.keystr(path),
                                   **(tol or TOL))


# --------------------------------------------------------------- MoE
MOE_CASES = {
    "top2of4": ("phi3.5-moe-42b-a6.6b", dict(n_experts=4, top_k=2)),
    "top8of16": ("deepseek-v3-671b", dict(n_experts=16, top_k=8)),
}


def moe_case(name):
    arch, moe = MOE_CASES[name]
    cfgs = []
    for get in (jget_config, get_config):
        c = family_cfg(get, arch)
        cfgs.append(dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, **moe)))
    params = JL.init_moe(jax.random.PRNGKey(1), cfgs[0])
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    w = rng.standard_normal((2, 9, 64)).astype(np.float32)
    return cfgs, params, x, w


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_apply_moe_and_grads_match_jax(case):
    """Output, aux loss and the gradients of sum(delta * w) + aux with
    respect to x and every param leaf within 1e-5; deepseek-v3's case has
    a shared expert."""
    (jcfg, tcfg), params, x, w = moe_case(case)
    assert ("shared" in params) == (case == "top8of16")

    def jloss(p, xx):
        y, aux = JL.apply_moe(p, jcfg, xx)
        return jnp.sum(y * w) + aux, (y, aux)

    (jl, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    tp = tree_map(lambda a: a.requires_grad_(True),
                  jax_to_torch(params, "cpu"))
    tx = torch.from_numpy(x).requires_grad_(True)
    assert_margin(f"apply_moe {case}", [L.router_margin(tp, tcfg, tx)])
    ty, taux = L.apply_moe(tp, tcfg, tx)
    tl = (ty * torch.from_numpy(w)).sum() + taux
    assert taux.dtype == torch.float32 and taux.dim() == 0
    leaves = tree_leaves(tp)
    grads = torch.autograd.grad(tl, [tx] + leaves)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), **TOL)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), **TOL)
    it = iter(grads[1:])
    _assert_tree_close(tree_map(lambda _: next(it), tp), jgp)


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_row_subset_gives_the_full_batch_rows(case):
    """Dropless dispatch: the rows of a subset of the batch come out as in
    the whole batch (the serving decode step runs each tenant's tail on
    its own rows); the host syncs are one a call."""
    (_, tcfg), params, x, _ = moe_case(case)
    tp = jax_to_torch(params, "cpu")
    full, _ = L.apply_moe(tp, tcfg, torch.from_numpy(x))
    rows = [1]
    syncs = L.moe_host_syncs
    part, _ = L.apply_moe(tp, tcfg, torch.from_numpy(x[rows]))
    assert L.moe_host_syncs == syncs + 1
    np.testing.assert_allclose(part.numpy(), full[rows].numpy(),
                               atol=1e-6, rtol=1e-6)
    one, _ = L.apply_moe(tp, tcfg, torch.from_numpy(x[:1, 3:4]))
    np.testing.assert_allclose(one.numpy(), full[:1, 3:4].numpy(),
                               atol=1e-6, rtol=1e-6)


def test_moe_top_k_ties_take_the_lower_expert():
    """Equal router probabilities order as `jax.lax.top_k` orders them:
    the lower expert first, so the top-2 of four equal experts are 0 and
    1 in both packages."""
    (jcfg, tcfg), params, x, _ = moe_case("top2of4")
    params = dict(params, router={"w": jnp.zeros_like(
        params["router"]["w"])})
    jy, jaux = JL.apply_moe(params, jcfg, jnp.asarray(x))
    ty, taux = L.apply_moe(jax_to_torch(params, "cpu"), tcfg,
                           torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    sorted_e = L._route(jax_to_torch(params, "cpu"), tcfg,
                        torch.from_numpy(x))[4]
    assert (sorted_e[:, :2] == torch.tensor([0, 1])).all()


# --------------------------------------------------------------- MLA
def test_mla_prefill_decode_and_latent_caches_match_jax():
    """deepseek-v3's attention, reduced (2 heads, q_lora 64, kv_lora 32,
    nope / rope / v 16 / 16 / 32): a prefill of 6 tokens into a ring of 8,
    then 4 decode steps that wrap it, at batch 2 with rows at different
    positions; the delta and every cache leaf (the latent `ckv`, the
    rotary key `kr`, positions) within 1e-5 after each call."""
    jcfg = family_cfg(jget_config, "deepseek-v3-671b")
    tcfg = family_cfg(get_config, "deepseek-v3-671b")
    assert tcfg.attention.mla is not None
    params = JL.init_attention(jax.random.PRNGKey(4), jcfg)
    tp = jax_to_torch(params, "cpu")
    own = L.init_attention(torch.Generator().manual_seed(0), tcfg,
                           device="cpu")
    assert set(own) == set(params) >= {"q_a", "q_a_ln", "q_b", "kv_a",
                                       "kv_a_ln", "kv_b", "o"}
    for k in own:
        for a, b in zip(tree_leaves(own[k]), jax.tree.leaves(params[k])):
            assert tuple(a.shape) == tuple(b.shape), k
    jcache = JL.init_attn_cache(jcfg, 2, 8)
    tcache = L.init_attn_cache(tcfg, 2, 8, device="cpu")
    assert set(tcache) == {"ckv", "kr", "positions"}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
    @functools.partial(jax.jit, static_argnames="mode")
    def jattend(xx, positions, cache, mode):
        return JL.apply_attention(params, jcfg, xx, JL.Ctx(
            mode=mode, positions=positions), cache)

    tctx = L.Ctx(mode="prefill", positions=torch.from_numpy(pos.copy()))
    jd, jcache = jattend(jnp.asarray(x), jnp.asarray(pos), jcache,
                         mode="prefill")
    td, tcache = L.apply_attention(tp, tcfg, torch.from_numpy(x), tctx,
                                   tcache)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    _assert_tree_close(tcache, jcache)
    p = np.array([6, 5], np.int32)
    for _ in range(4):
        xd = rng.standard_normal((2, 1, 64)).astype(np.float32)
        tctx = L.Ctx(mode="decode",
                     positions=torch.from_numpy(p[:, None].copy()))
        jd, jcache = jattend(jnp.asarray(xd), jnp.asarray(p[:, None]),
                             jcache, mode="decode")
        td, tcache = L.apply_attention(tp, tcfg, torch.from_numpy(xd), tctx,
                                       tcache)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
        _assert_tree_close(tcache, jcache)
        p = p + 1
    assert int(tcache["positions"].max()) == 9    # the ring wrapped


def test_mla_refuses_a_paged_cache_as_jax():
    tcfg = family_cfg(get_config, "deepseek-v3-671b")
    jcfg = family_cfg(jget_config, "deepseek-v3-671b")
    params = JL.init_attention(jax.random.PRNGKey(4), jcfg)
    cache = dict(JL.init_attn_cache(jcfg, 2, 8),
                 block_tables=jnp.zeros((2, 1), jnp.int32))
    ctx = JL.Ctx(mode="decode", positions=jnp.zeros((2, 1), jnp.int32))
    with pytest.raises(NotImplementedError) as jerr:
        JL.apply_attention(params, jcfg, jnp.zeros((2, 1, 64)), ctx, cache)
    tctx = L.Ctx(mode="decode", positions=torch.zeros((2, 1),
                                                      dtype=torch.int32))
    with pytest.raises(NotImplementedError) as terr:
        L.apply_attention(jax_to_torch(params, "cpu"), tcfg,
                          torch.zeros((2, 1, 64)), tctx,
                          dict(jax_to_torch(cache, "cpu")))
    assert str(terr.value) == str(jerr.value)


# -------------------------------------------------------- split model
def build(arch, wire="fp32", seed=0):
    split = dict(head_cycles=1, tail_cycles=1, prompt_len=PROMPT_LEN)
    jm = JSplitModel(family_cfg(jget_config, arch), JSplitConfig(**split),
                     JWireSpec.make(wire))
    tm = SplitModel(family_cfg(get_config, arch), SplitConfig(**split),
                    WireSpec.make(wire))
    params = jm.init(jax.random.PRNGKey(seed))
    return jm, tm, params, jax_to_torch(params, "cpu")


@pytest.mark.parametrize("wire", ["fp32", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_split_prefill_then_decode_matches_jax(arch, wire):
    """Logits and every cache leaf (deepseek-v3's dense-prefix attention
    cache and its MLA latents) within 1e-5 over a prefill and 4 decode
    steps; metered wire bytes equal. On the int8 wire this draw flips no
    payload value (ROADMAP Queue 3 item 2)."""
    jm, tm, params, tparams = build(arch, wire)
    rng = np.random.default_rng(0)
    B, S = 2, 7
    batch = {"tokens": rng.integers(0, 128, (B, S)).astype(np.int32)}
    jcache = jm.init_cache(B, seq_len=24)
    tcache = tm.init_cache(B, seq_len=24, device="cpu")
    if arch == "deepseek-v3-671b":
        assert set(tcache["head"]) == {"stack", "dense_stack"}
        assert set(tcache["body"]["stack"]["pos0"]) == {"ckv", "kr",
                                                        "positions"}
    jforward = jax.jit(jm.forward, static_argnames="mode")
    with margin_probe() as margins:
        for t in range(5):
            jout = jforward(params, jax.tree.map(jnp.asarray, batch),
                            mode="decode" if t else "prefill", cache=jcache)
            tout = tm.forward(tparams, tree_map(torch.from_numpy, batch),
                              mode="decode" if t else "prefill",
                              cache=tcache)
            np.testing.assert_allclose(tout["logits"].numpy(),
                                       np.asarray(jout["logits"]), **TOL)
            np.testing.assert_allclose(float(tout["aux"]),
                                       float(jout["aux"]), **TOL)
            assert tout["wire_bytes"] == {k: float(v) for k, v in
                                          jout["wire_bytes"].items()}
            jcache, tcache = jout["cache"], tout["cache"]
            _assert_tree_close(tcache, jcache)
            batch = {"tokens": rng.integers(0, 128, (B, 1)).astype(np.int32),
                     "pos": np.full((B,), S + PROMPT_LEN + t, np.int32)}
    assert_margin(f"{arch} split prefill/decode {wire}", margins)


@pytest.mark.parametrize("route", ["split", "local"])
@pytest.mark.parametrize("arch", ARCHS)
def test_split_train_forward_matches_jax(arch, route):
    """Token draw 5: draws 0-4 bring some token's k-th and (k+1)-th router
    probabilities within 1e-4 of each other (down to 2.4e-5) in one
    family or the other, below the margin this file holds; the logits
    still agreed within 2.4e-7 at every one of them."""
    jm, tm, params, tparams = build(arch, "int8")
    toks = np.random.default_rng(5).integers(0, 128, (3, 9)).astype(np.int32)
    jout = jm.forward(params, {"tokens": jnp.asarray(toks)}, route=route)
    with margin_probe() as margins:
        tout = tm.forward(tparams, {"tokens": torch.from_numpy(toks)},
                          route=route)
    assert_margin(f"{arch} train forward {route}", margins)
    np.testing.assert_allclose(tout["logits"].numpy(),
                               np.asarray(jout["logits"]), **TOL)
    np.testing.assert_allclose(float(tout["aux"]), float(jout["aux"]), **TOL)
    assert tout["wire_bytes"] == {k: float(v) for k, v in
                                  jout["wire_bytes"].items()}
    assert ("mtp_hidden_ready" in tout) == ("mtp_hidden_ready" in jout) \
        == (arch == "deepseek-v3-671b")


@pytest.mark.parametrize("arch", ARCHS)
def test_split_params_bridge_key_for_key_and_sizes(arch):
    """Every JAX leaf at its key path (deepseek-v3: head `dense_stack`,
    tail `mtp`); the port's own init has the same tree and shapes; segment
    sizes (on the `meta` device) and the tail + prompt bytes a client
    uploads equal JAX's."""
    jm, tm, params, tparams = build(arch)
    _assert_tree_close(tparams, params, atol=0, rtol=0)
    if arch == "deepseek-v3-671b":
        assert set(tparams["tail"]["mtp"]) == {"proj", "block", "norm"}
        assert "dense_stack" in tparams["head"]
    own = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda x: 0, params)) == \
        jax.tree.structure(tree_map(lambda x: 0, own))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        node = own
        for p in path:
            node = node[p.key]
        assert tuple(leaf.shape) == tuple(node.shape), path
    for seg in ("head", "body", "tail"):
        assert tm._segment_params_count(seg) == \
            jm._segment_params_count(seg), seg
    np.testing.assert_allclose(tm.segment_fractions(),
                               jm.segment_fractions(), rtol=1e-12)
    up = sum(x.numel() * x.element_size() for x in
             tree_leaves({"tail": own["tail"], "prompt": own["prompt"]}))
    assert up == sum(x.nbytes for x in jax.tree.leaves(
        {"tail": params["tail"], "prompt": params["prompt"]}))


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_ops_carry_dense_stack_and_latents(arch):
    """Every cache leaf, the dense prefix stack and MLA's latents included,
    has its slot axis at 1: a slot write overwrites the whole slot and
    leaves the others alone."""
    _, tm, _, _ = build(arch)
    shared = tm.init_cache(3, seq_len=16, device="cpu")
    single = tree_map(lambda x: torch.full_like(x, 3),
                      tm.blank_slot_cache(16, device="cpu"))
    tm.cache_write_slot(shared, single, 1)
    for a, b in zip(tree_leaves(tm.cache_read_slot(shared, 1)),
                    tree_leaves(single)):
        assert torch.equal(a, b)
    blank = tm.blank_slot_cache(16, device="cpu")
    for slot in (0, 2):
        for a, b in zip(tree_leaves(tm.cache_read_slot(shared, slot)),
                        tree_leaves(blank)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_refuses_with_jax_reason(arch):
    jm, tm, params, tparams = build(arch)
    assert tm.paged_cache_unsupported() == jm.paged_cache_unsupported()
    assert "non-'attn'" in tm.paged_cache_unsupported()
    jb = JTenantBank.from_lists([params["tail"]], [params["prompt"]])
    with pytest.raises(ValueError) as jerr:
        JPagedServeEngine(jm, params, jb,
                          JPagedServeConfig(n_slots=2, max_seq=32,
                                            page_size=8))
    with pytest.raises(ValueError) as terr:
        PagedServeEngine(tm, tparams,
                         bank_from_arrays(jb.tails, jb.prompts, "cpu"),
                         PagedServeConfig(n_slots=2, max_seq=32,
                                          page_size=8), device="cpu")
    assert str(terr.value) == str(jerr.value)
