"""The two recurrent-state families served by the port against the JAX
package on bridged weights: zamba2 (Mamba-2 with one shared-weight
attention block) and rwkv6 (RWKV-6), reduced. SplitModel prefill + decode
with every cache leaf, train-mode forwards, the bridge key for key,
ServeEngine against the JAX ServeEngine, a mid-batch join into a reused
slot, the paged engine's refusal and the launcher."""
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import SplitConfig as JSplitConfig  # noqa: E402
from repro.core import SplitModel as JSplitModel  # noqa: E402
from repro.runtime import WireSpec as JWireSpec  # noqa: E402
from repro.serve import PagedServeConfig as JPagedServeConfig  # noqa: E402
from repro.serve import PagedServeEngine as JPagedServeEngine  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import TenantBank as JTenantBank  # noqa: E402
from repro_torch.bridge import bank_from_arrays, jax_to_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import SplitConfig, SplitModel  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.runtime import WireSpec  # noqa: E402
from repro_torch.serve import (PagedServeConfig,  # noqa: E402
                               PagedServeEngine, Request, ServeConfig,
                               ServeEngine)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCHS = ["zamba2-2.7b", "rwkv6-3b"]
TOL = dict(atol=1e-5, rtol=1e-5)
PROMPT_LEN = 4
MAX_SEQ = 40

# two prompt lengths only: each is one JAX prefill compile
REQS = [
    Request(rid=0, tenant=0, tokens=np.arange(9, dtype=np.int32) % 128,
            max_new=5, arrival=0),
    Request(rid=1, tenant=1, tokens=(np.arange(12, dtype=np.int32) * 3)
            % 128, max_new=3, arrival=0),
    Request(rid=2, tenant=2, tokens=(np.arange(9, dtype=np.int32) * 7)
            % 128, max_new=6, arrival=2),
]


def _cfg(get, arch):
    cyc = 6 if arch == "zamba2-2.7b" else 1
    return get(arch).reduced(n_layers=3 * cyc, d_model=64, d_ff=128,
                             vocab_size=128)


def build(arch, wire="fp32"):
    split = dict(head_cycles=1, tail_cycles=1, prompt_len=PROMPT_LEN)
    jm = JSplitModel(_cfg(jget_config, arch), JSplitConfig(**split),
                     JWireSpec.make(wire))
    tm = SplitModel(_cfg(get_config, arch), SplitConfig(**split),
                    WireSpec.make(wire))
    params = jm.init(jax.random.PRNGKey(0))
    return jm, tm, params, jax_to_torch(params, "cpu")


def jax_bank(params, n_tenants=3, jitter=0.2):
    """Distinct per-tenant (tail, prompt), as tests/test_serve.py builds."""
    tails, prompts = [], []
    for t in range(n_tenants):
        key = jax.random.fold_in(jax.random.PRNGKey(7), t)
        leaves, treedef = jax.tree.flatten(params["tail"])
        ks = jax.random.split(key, len(leaves) + 1)
        tails.append(jax.tree.unflatten(treedef, [
            x + jitter * jax.random.normal(k, x.shape, x.dtype)
            for x, k in zip(leaves, ks[:-1])]))
        prompts.append(params["prompt"] + jitter * jax.random.normal(
            ks[-1], params["prompt"].shape))
    return JTenantBank.from_lists(tails, prompts)


def _assert_tree_close(ttree, jtree):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert len(jflat) == len(tree_leaves(ttree))
    for path, leaf in jflat:
        node = ttree
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf), **TOL,
                                   err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------ split model
@pytest.mark.parametrize("wire", ["fp32", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_jax(arch, wire):
    """Logits and every cache leaf (conv, ssm, shift_t, shift_c, state, and
    zamba2's attention k/v/positions at each shared-block site) within
    1e-5; metered wire bytes equal. On the int8 wire this draw flips no
    payload value (ROADMAP Queue 3, upstream rounding)."""
    jm, tm, params, tparams = build(arch, wire)
    rng = np.random.default_rng(0)
    B, S = 2, 7
    toks = rng.integers(0, 128, (B, S)).astype(np.int32)
    jcache = jm.init_cache(B, seq_len=24)
    tcache = tm.init_cache(B, seq_len=24, device="cpu")
    batch = {"tokens": toks}
    for t in range(5):
        jout = jm.forward(params, jax.tree.map(jnp.asarray, batch),
                          mode="decode" if t else "prefill", cache=jcache)
        tout = tm.forward(tparams, tree_map(torch.from_numpy, batch),
                          mode="decode" if t else "prefill", cache=tcache)
        np.testing.assert_allclose(tout["logits"].numpy(),
                                   np.asarray(jout["logits"]), **TOL)
        assert tout["wire_bytes"] == {k: float(v) for k, v in
                                      jout["wire_bytes"].items()}
        jcache, tcache = jout["cache"], tout["cache"]
        _assert_tree_close(tcache, jcache)
        batch = {"tokens": rng.integers(0, 128, (B, 1)).astype(np.int32),
                 "pos": np.full((B,), S + PROMPT_LEN + t, np.int32)}


@pytest.mark.parametrize("route", ["split", "local"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_mode_forward_matches_jax(arch, route):
    jm, tm, params, tparams = build(arch, "int8")
    toks = np.random.default_rng(1).integers(0, 128, (3, 9)).astype(np.int32)
    jout = jm.forward(params, {"tokens": jnp.asarray(toks)}, route=route)
    tout = tm.forward(tparams, {"tokens": torch.from_numpy(toks)},
                      route=route)
    np.testing.assert_allclose(tout["logits"].numpy(),
                               np.asarray(jout["logits"]), **TOL)
    assert tout["wire_bytes"] == {k: float(v) for k, v in
                                  jout["wire_bytes"].items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_params_bridge_key_for_key(arch):
    """Every JAX leaf lands at its key path; zamba2 carries one copy of the
    shared attention block in each of head, body and tail; the port's own
    init has the same tree and shapes; segment fractions (counted on the
    `meta` device) equal JAX's."""
    jm, tm, params, tparams = build(arch)
    _assert_tree_close(tparams, params)
    if arch == "zamba2-2.7b":
        copies = [tparams[seg]["shared_attn"] for seg in
                  ("head", "body", "tail")]
        for other in copies[1:]:
            for a, b in zip(tree_leaves(copies[0]), tree_leaves(other)):
                assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    else:
        assert all("shared_attn" not in tparams[s]
                   for s in ("head", "body", "tail"))
    own = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda x: 0, params)) == \
        jax.tree.structure(tree_map(lambda x: 0, own))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        node = own
        for p in path:
            node = node[p.key]
        assert tuple(leaf.shape) == tuple(node.shape), path
    np.testing.assert_allclose(tm.segment_fractions(),
                               jm.segment_fractions(), rtol=1e-12)


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_ops_carry_recurrent_leaves(arch):
    """Every recurrent leaf has its slot axis at 1: a slot write overwrites
    the whole slot and leaves the others alone."""
    _, tm, _, _ = build(arch)
    shared = tm.init_cache(3, seq_len=16, device="cpu")
    names = {k for stack in shared["body"]["stack"].values() for k in stack}
    assert names >= ({"conv", "ssm"} if arch == "zamba2-2.7b"
                     else {"shift_t", "shift_c", "state"})
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


# ------------------------------------------------------------------ engine
def engines(arch, wire="fp32"):
    jm, tm, params, tparams = build(arch, wire)
    jb = jax_bank(params)
    return (jm, params, jb), (tm, tparams,
                              bank_from_arrays(jb.tails, jb.prompts, "cpu"))


@pytest.mark.parametrize("decode_block", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch, decode_block):
    """Tokens ==, per-step logits within 1e-5 and metered wire bytes ==
    (int8 wire), over 3 requests on 2 slots: a queued request joins into a
    retired slot mid-flight."""
    (jm, params, jb), (tm, tparams, tbank) = engines(arch, "int8")
    want = JServeEngine(jm, params, jb,
                        JServeConfig(n_slots=2, max_seq=MAX_SEQ,
                                     decode_block=decode_block),
                        collect_logits=True).run(REQS)
    got = ServeEngine(tm, tparams, tbank,
                      ServeConfig(n_slots=2, max_seq=MAX_SEQ,
                                  decode_block=decode_block),
                      collect_logits=True, device="cpu").run(REQS)
    assert got["n_finished"] == want["n_finished"] == len(REQS)
    w_by = {f.req.rid: f for f in want["finished"]}
    for f in got["finished"]:
        np.testing.assert_array_equal(f.tokens, w_by[f.req.rid].tokens)
        np.testing.assert_allclose(f.logits, w_by[f.req.rid].logits, **TOL)
    assert got["wire_bytes"] == want["wire_bytes"]
    for key in ("tokens_out", "decode_steps", "prefills", "occupancy"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("arch", ARCHS)
def test_mid_batch_join_into_reused_slot(arch):
    """Two tenants share 2 slots; request 2 (tenant 1) joins mid-flight
    into the slot request 1 retired from, whose recurrent state had run
    on. Every request gives the tokens it gives in a fresh engine alone:
    admission overwrites the whole slot."""
    _, (tm, tparams, tbank) = engines(arch)
    reqs = [
        Request(rid=0, tenant=0, tokens=np.arange(10, dtype=np.int32),
                max_new=8, arrival=0),
        Request(rid=1, tenant=1, tokens=(np.arange(6, dtype=np.int32) * 5)
                % 128, max_new=2, arrival=0),
        Request(rid=2, tenant=1, tokens=(np.arange(8, dtype=np.int32) * 11)
                % 128, max_new=5, arrival=3),
    ]

    def run(rs):
        eng = ServeEngine(tm, tparams, tbank,
                          ServeConfig(n_slots=2, max_seq=MAX_SEQ,
                                      decode_block=2),
                          collect_logits=True, device="cpu")
        return {f.req.rid: f for f in eng.run(rs)["finished"]}

    together = run(reqs)
    assert len(together) == 3
    for r in reqs:
        alone = run([Request(rid=r.rid, tenant=r.tenant, tokens=r.tokens,
                             max_new=r.max_new, arrival=0)])[r.rid]
        np.testing.assert_array_equal(together[r.rid].tokens, alone.tokens)
        np.testing.assert_allclose(together[r.rid].logits, alone.logits,
                                   **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_refuses_with_jax_reason(arch):
    (jm, params, jb), (tm, tparams, tbank) = engines(arch)
    assert tm.paged_cache_unsupported() == jm.paged_cache_unsupported()
    assert "non-'attn'" in tm.paged_cache_unsupported()
    with pytest.raises(ValueError) as jerr:
        JPagedServeEngine(jm, params, jb,
                          JPagedServeConfig(n_slots=2, max_seq=MAX_SEQ,
                                            page_size=8))
    with pytest.raises(ValueError) as terr:
        PagedServeEngine(tm, tparams, tbank,
                         PagedServeConfig(n_slots=2, max_seq=MAX_SEQ,
                                          page_size=8), device="cpu")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="paged"):
        launch_serve.main(["--device", "cpu", "--arch", arch,
                           "--page-size", "8", "--requests", "1"])


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_main_on_cpu(arch, capsys):
    stats = launch_serve.main([
        "--device", "cpu", "--arch", arch, "--requests", "4", "--slots",
        "2", "--tenants", "2", "--wire", "int8", "--prompt-choices", "6",
        "10", "--new-token-choices", "3", "5", "--decode-block", "4"])
    assert stats["n_finished"] == 4
    out = capsys.readouterr().out
    assert f"{arch}-reduced" in out and "MB analytical" in out


def test_unported_block_kinds_name_their_slice():
    """Every block kind builds now: `moe` (an attention half and the MoE
    block, and an attention cache) and `cross_attn` (self-attention with
    the cross-attention half's norm and projections, an MLP, and a
    self-attention cache); an unknown kind raises ValueError."""
    from repro_torch.models.transformer import init_block, init_block_cache
    cfg = _cfg(get_config, "zamba2-2.7b")
    gen = torch.Generator().manual_seed(0)
    moe_cfg = get_config("phi3.5-moe-42b-a6.6b").reduced(
        n_layers=3, d_model=64, d_ff=128, vocab_size=128)
    block = init_block(gen, moe_cfg, "moe", device="cpu")
    assert set(block) == {"attn", "moe"}
    assert set(block["moe"]["experts"]) == {"up", "gate", "down"}
    assert set(init_block_cache(moe_cfg, "moe", 1, 8, device="cpu")) == \
        {"k", "v", "positions"}
    cross = init_block(gen, cfg, "cross_attn", device="cpu")
    assert set(cross) == {"attn", "mlp"}
    assert {"ln_cross", "cq", "ck", "cv", "co"} <= set(cross["attn"])
    assert set(init_block_cache(cfg, "cross_attn", 1, 8, device="cpu")) == \
        {"k", "v", "positions"}
    with pytest.raises(ValueError):
        init_block(gen, cfg, "no-such-kind", device="cpu")