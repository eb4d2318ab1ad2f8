"""The port's SplitModel against the JAX SplitModel on bridged weights:
prefill then several decode tokens through both wire boundaries, at the
reduced Qwen2.5 family (G = 1) and a hand-built GQA variant (G = 5)."""
import torch

torch.set_num_threads(2)

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import SplitConfig as JSplitConfig  # noqa: E402
from repro.core import SplitModel as JSplitModel  # noqa: E402
from repro.runtime import WireSpec as JWireSpec  # noqa: E402
from repro_torch.bridge import jax_to_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import SplitConfig, SplitModel  # noqa: E402
from repro_torch.runtime import WireSpec  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
PROMPT_LEN = 4


def _cfg(get, variant):
    cfg = get("qwen2.5-14b").reduced(n_layers=3, d_model=64, d_ff=128,
                                     vocab_size=128)
    if variant == "gqa5":
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, n_heads=10, n_kv_heads=2, head_dim=16))
    return cfg


def build(variant="g1", wire="fp32"):
    jm = JSplitModel(_cfg(jget_config, variant),
                     JSplitConfig(head_cycles=1, tail_cycles=1,
                                  prompt_len=PROMPT_LEN),
                     JWireSpec.make(wire))
    tm = SplitModel(_cfg(get_config, variant),
                    SplitConfig(head_cycles=1, tail_cycles=1,
                                prompt_len=PROMPT_LEN),
                    WireSpec.make(wire))
    params = jm.init(jax.random.PRNGKey(0))
    return jm, tm, params, jax_to_torch(params, "cpu")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _check_cache(tcache, jcache):
    jc = _np_tree(jcache)
    for seg in ("head", "body", "tail"):
        for pos, leaves in tcache[seg]["stack"].items():
            want = jc[seg]["stack"][pos]
            np.testing.assert_allclose(leaves["k"].numpy(), want["k"], **TOL)
            np.testing.assert_allclose(leaves["v"].numpy(), want["v"], **TOL)
            np.testing.assert_array_equal(leaves["positions"].numpy(),
                                          want["positions"])


@pytest.mark.parametrize("variant,wire,window", [
    ("g1", "fp32", 32), ("g1", "int8", 8),
    ("gqa5", "fp32", 8), ("gqa5", "int8", 32)])
def test_prefill_then_decode_matches_jax(variant, wire, window):
    """Logits and cache k/v within 1e-5, cache positions and metered wire
    bytes equal; window 8 < prompt makes the ring wrap in both prefill and
    decode.

    The int8 wire is exact only while the packages' fp32 rounding
    differences upstream of a boundary (~1e-7 relative) push no element
    across a rounding boundary of the quantizer. At this size about one
    token draw in twenty-five flips one payload value somewhere (a ~1e-3
    logit change); the drawn tokens below flip none."""
    jm, tm, params, tparams = build(variant, wire)
    rng = np.random.default_rng(0)
    B, S = 2, 7
    toks = rng.integers(0, 128, (B, S)).astype(np.int32)
    jcache = jm.init_cache(B, seq_len=window)
    tcache = tm.init_cache(B, seq_len=window, device="cpu")
    jout = jm.forward(params, {"tokens": jnp.asarray(toks)}, mode="prefill",
                      cache=jcache)
    tout = tm.forward(tparams, {"tokens": torch.from_numpy(toks)},
                      mode="prefill", cache=tcache)
    np.testing.assert_allclose(tout["logits"].numpy(),
                               np.asarray(jout["logits"]), **TOL)
    assert tout["wire_bytes"] == {k: float(v) for k, v in
                                  jout["wire_bytes"].items()}
    jcache, tcache = jout["cache"], tout["cache"]
    _check_cache(tcache, jcache)
    for t in range(4):
        tok = rng.integers(0, 128, (B, 1)).astype(np.int32)
        pos = np.full((B,), S + PROMPT_LEN + t, np.int32)
        jout = jm.forward(params, {"tokens": jnp.asarray(tok),
                                   "pos": jnp.asarray(pos)},
                          mode="decode", cache=jcache)
        tout = tm.forward(tparams, {"tokens": torch.from_numpy(tok),
                                    "pos": torch.from_numpy(pos)},
                          mode="decode", cache=tcache)
        np.testing.assert_allclose(tout["logits"].numpy(),
                                   np.asarray(jout["logits"]), **TOL)
        assert tout["wire_bytes"] == {k: float(v) for k, v in
                                      jout["wire_bytes"].items()}
        jcache, tcache = jout["cache"], tout["cache"]
        _check_cache(tcache, jcache)


@pytest.mark.parametrize("route", ["split", "local"])
def test_train_mode_forward_matches_jax(route):
    """Full-sequence (no cache) forward: logits over every position, and
    train-mode wire bytes counting the gradient crossing too."""
    jm, tm, params, tparams = build("gqa5", "int8")
    toks = np.random.default_rng(1).integers(0, 128, (3, 9)).astype(np.int32)
    jout = jm.forward(params, {"tokens": jnp.asarray(toks)}, route=route)
    tout = tm.forward(tparams, {"tokens": torch.from_numpy(toks)},
                      route=route)
    np.testing.assert_allclose(tout["logits"].numpy(),
                               np.asarray(jout["logits"]), **TOL)
    assert tout["wire_bytes"] == {k: float(v) for k, v in
                                  jout["wire_bytes"].items()}


def test_slot_cache_write_read_roundtrip():
    _, tm, _, _ = build()
    shared = tm.init_cache(3, seq_len=16, device="cpu")
    single = tree_map(lambda x: torch.full_like(x, 3),
                      tm.blank_slot_cache(16, device="cpu"))
    before = tree_map(torch.clone, shared)
    written = tm.cache_write_slot(shared, single, 1)
    back = tm.cache_read_slot(written, 1)
    for a, b in zip(tree_leaves(back), tree_leaves(single)):
        assert torch.equal(a, b)
    for slot in (0, 2):        # the other slots are untouched
        for a, b in zip(tree_leaves(tm.cache_read_slot(written, slot)),
                        tree_leaves(tm.cache_read_slot(before, slot))):
            assert torch.equal(a, b)
    # writing a blank slot back resets every leaf, positions to -1
    tm.cache_write_slot(written, tm.blank_slot_cache(16, device="cpu"), 1)
    assert (tm.cache_read_slot(written, 1)["head"]["stack"]["pos0"]
            ["positions"] == -1).all()


def test_params_bridge_key_for_key():
    jm, tm, params, tparams = build("gqa5")
    jflat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(jflat) == len(tree_leaves(tparams))
    for path, leaf in jflat:
        node = tparams
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    # the port's own init draws the same keys and shapes
    own = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda x: 0, params)) == \
        jax.tree.structure(tree_map(lambda x: 0, own))
    for path, leaf in jflat:
        node = own
        for p in path:
            node = node[p.key]
        assert tuple(leaf.shape) == tuple(node.shape), path
