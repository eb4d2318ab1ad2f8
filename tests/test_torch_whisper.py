"""Whisper in the port against the JAX package, on bridged weights: the
reduced whisper-base (`reduced(n_layers=3, d_model=64, d_ff=128,
vocab_size=128)`: a 1-layer encoder over 16 frames, 3 decoder layers of
self-attention, cross-attention and a GELU MLP, layernorm, sinusoidal
positions, no RoPE), split head 1 / body 1 / tail 1 with a prompt of 4.

- `sinusoidal_embedding` and `apply_cross_attention` against JAX's (1e-5);
- tests/test_split.py::test_whisper_cross_attention_uses_encoder on both
  packages: the encoder lives in the head, and the logits move with the
  frames;
- the split forward in train mode (split and local routes) and a prefill
  then four decode steps, on the fp32 and int8 wires: logits and caches
  within 1e-5, wire bytes and cache positions `==`. The encoder's output
  reaches body and tail in the head's output, as in the JAX package, and
  crosses no metered wire;
- an SFPrompt round with `frames` in the cohort on both wires (wire bytes,
  kept sets and kept_frac `==`; params, losses and EL2N scores within
  1e-5) and `evaluate` (CE within 1e-5, accuracy `==`);
- a round on token-only data fails with `KeyError: 'frames'` in both
  packages (the encoder reads the batch's frames);
- both serving engines refuse the model with JAX's messages.

The int8 wire is exact only while the two packages' fp32 differences
upstream of a boundary push no element across a quantizer rounding
boundary (ROADMAP Queue 3 item 2). The draws here (init seed 0, numpy
seeds 0 and 1) flip none; none had to be changed for it.

The round helpers here are shared with tests/test_torch_vlm.py."""
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.core import SFPromptTrainer as JSFPromptTrainer  # noqa: E402
from repro.core import SplitConfig as JSplitConfig  # noqa: E402
from repro.core import SplitModel as JSplitModel  # noqa: E402
from repro.core.aggregation import broadcast_to_clients  # noqa: E402
from repro.core.local_update import local_epochs as jlocal  # noqa: E402
from repro.core.pruning import score_client_data as jscore  # noqa: E402
from repro.data import (iid_partition, select_clients,  # noqa: E402
                        stack_clients, synthetic_lm_dataset)
from repro.models import layers as JL  # noqa: E402
from repro.runtime import WireSpec as JWireSpec  # noqa: E402
from repro.serve import PagedServeConfig as JPagedServeConfig  # noqa: E402
from repro.serve import PagedServeEngine as JPagedServeEngine  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.bridge import jax_to_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ProtocolConfig, SFPromptTrainer,  # noqa: E402
                              SplitConfig, SplitModel)
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.runtime import WireSpec  # noqa: E402
from repro_torch.serve import PagedServeConfig  # noqa: E402
from repro_torch.serve import PagedServeEngine, ServeConfig  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCH = "whisper-base"
TOL = dict(atol=1e-5, rtol=1e-5)
K, N_LOCAL, BATCH, SEQ, VOCAB, PROMPT = 2, 8, 4, 16, 128, 4
SPLIT = dict(head_cycles=1, tail_cycles=1, prompt_len=PROMPT,
             prune_gamma=0.5, local_epochs=1)
PCFG = dict(clients_per_round=K, local_epochs=1, batch_size=BATCH,
            lr_local=0.05, lr_split=0.05)


# ------------------------------------------------------------- helpers
def cfg(get, arch):
    return get(arch).reduced(n_layers=3, d_model=64, d_ff=128,
                             vocab_size=VOCAB)


def models(arch, wire):
    return (JSplitModel(cfg(jget_config, arch), JSplitConfig(**SPLIT),
                        JWireSpec.make(wire)),
            SplitModel(cfg(get_config, arch), SplitConfig(**SPLIT),
                       WireSpec.make(wire)))


def extras(c, rng, n, grid=True):
    """The batch keys a family's frontend stub brings for n samples:
    Whisper's `frames` (n, n_frames, D); Qwen2-VL's 8 `patch_embeds`
    (n, 8, D) and, with `grid`, their M-RoPE positions on a (2, 2, 2)
    grid, stored client-axis-first as (n, 3, 8)."""
    if c.arch_type == "audio":
        return {"frames": (0.02 * rng.standard_normal(
            (n, c.encoder.n_frames, c.d_model))).astype(np.float32)}
    out = {"patch_embeds": (0.02 * rng.standard_normal(
        (n, 8, c.d_model))).astype(np.float32)}
    if grid:
        g = np.stack(np.meshgrid(np.arange(2), np.arange(2), np.arange(2),
                                 indexing="ij")).reshape(3, 8)
        out["mrope_positions"] = np.ascontiguousarray(
            np.broadcast_to(g[None], (n, 3, 8)), dtype=np.int32)
    return out


def n_extra(batch):
    """Rows the frontend prepends to the tokens (besides the prompt)."""
    return batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0


def lm_data(arch, n, seed, modal=True):
    data = synthetic_lm_dataset(n, SEQ, VOCAB, seed=seed)
    if modal:
        data.update(extras(cfg(get_config, arch),
                           np.random.default_rng(100 + seed), n))
    return data


def cohort(arch, modal=True):
    clients = iid_partition(lm_data(arch, 4 * N_LOCAL, 0, modal), 4, seed=0)
    return stack_clients(clients, select_clients(4, K, seed=0, round_idx=0))


def jtree(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def ttree(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def jax_wire_noise(round_idx, k):
    """The uniforms the JAX round draws (tests/test_torch_train.py)."""
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(23),
                                               round_idx), k)

    def noise(client, step, name, shape):
        k_hb, k_bt = jax.random.split(jax.random.fold_in(keys[client], step))
        kf, kb = jax.random.split(k_hb if name == "head_body" else k_bt)
        return tuple(torch.from_numpy(np.array(
            jax.random.uniform(key, shape, jnp.float32))) for key in (kf, kb))
    return noise


def assert_tree_close(t_tree, j_tree, **tol):
    jflat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, j_tree))[0]
    assert len(jflat) == len(tree_leaves(t_tree))
    for path, leaf in jflat:
        node = t_tree
        for p in path:
            node = node[p.key]
        if leaf.dtype.kind in "iu":
            np.testing.assert_array_equal(node.numpy(), leaf,
                                          err_msg=jax.tree_util.keystr(path))
        else:
            np.testing.assert_allclose(node.detach().numpy(), leaf,
                                       err_msg=jax.tree_util.keystr(path),
                                       **tol)


def check_forward(arch, wire, route, seed=1):
    """Train-mode split forward on a (3, 9)-token batch with the family's
    extras: logits within 1e-5, train-mode wire bytes (activation and
    gradient crossings) `==`."""
    jm, tm = models(arch, wire)
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    batch = dict(tokens=rng.integers(0, VOCAB, (3, 9)).astype(np.int32),
                 **extras(tm.cfg, rng, 3))
    jout = jm.forward(params, jtree(batch), route=route)
    tout = tm.forward(jax_to_torch(params, "cpu"), ttree(batch), route=route)
    np.testing.assert_allclose(tout["logits"].numpy(),
                               np.asarray(jout["logits"]), **TOL)
    assert tout["n_prefix"] == jout["n_prefix"]
    assert tout["wire_bytes"] == {k: float(v) for k, v in
                                  jout["wire_bytes"].items()}
    return tout


def check_serve(arch, wire, window, seed=0, grid=True):
    """Prefill of (2, 7) tokens with the family's extras, then four decode
    steps through both wires: logits and every cache leaf within 1e-5
    (positions `==`), wire bytes `==` at every step. Returns the wire
    bytes of the prefill and of a decode step."""
    jm, tm = models(arch, wire)
    params = jm.init(jax.random.PRNGKey(0))
    tparams = jax_to_torch(params, "cpu")
    rng = np.random.default_rng(seed)
    B, S = 2, 7
    batch = dict(tokens=rng.integers(0, VOCAB, (B, S)).astype(np.int32),
                 **extras(tm.cfg, rng, B, grid=grid))
    jcache = jm.init_cache(B, seq_len=window)
    tcache = tm.init_cache(B, seq_len=window, device="cpu")
    jout = jm.forward(params, jtree(batch), mode="prefill", cache=jcache)
    tout = tm.forward(tparams, ttree(batch), mode="prefill", cache=tcache)
    np.testing.assert_allclose(tout["logits"].numpy(),
                               np.asarray(jout["logits"]), **TOL)
    bytes_ = {"prefill": tout["wire_bytes"]}
    assert tout["wire_bytes"] == {k: float(v) for k, v in
                                  jout["wire_bytes"].items()}
    assert_tree_close(tout["cache"], jout["cache"], **TOL)
    jcache, tcache = jout["cache"], tout["cache"]
    for t in range(4):
        step = {"tokens": rng.integers(0, VOCAB, (B, 1)).astype(np.int32),
                "pos": np.full((B,), S + PROMPT + n_extra(batch) + t,
                               np.int32)}
        jout = jm.forward(params, jtree(step), mode="decode", cache=jcache)
        tout = tm.forward(tparams, ttree(step), mode="decode", cache=tcache)
        np.testing.assert_allclose(tout["logits"].numpy(),
                                   np.asarray(jout["logits"]), **TOL)
        assert tout["wire_bytes"] == {k: float(v) for k, v in
                                      jout["wire_bytes"].items()}
        assert_tree_close(tout["cache"], jout["cache"], **TOL)
        jcache, tcache = jout["cache"], tout["cache"]
    bytes_["decode"] = tout["wire_bytes"]
    return bytes_


def run_round(arch, wire, modal=True, seed=0):
    """One JAX round and one port round from the same (JAX-initialised)
    params, cohort and wire noise."""
    jm, tm = models(arch, wire)
    data = cohort(arch, modal)
    jtr = JSFPromptTrainer(jm, JProtocolConfig(**PCFG))
    jstate = jtr.init(jax.random.PRNGKey(seed))
    jnew, jmetrics = jtr.round(jstate, jtree(data))
    ttr = SFPromptTrainer(tm, ProtocolConfig(**PCFG), device="cpu")
    before = launch_counts()
    tnew, tmetrics = ttr.round(
        {"params": jax_to_torch(jstate["params"], "cpu"), "round": 0}, data,
        wire_noise=jax_wire_noise(0, K))
    assert launch_counts() == before         # no kernel on CPU tensors
    return dict(arch=arch, modal=modal, jm=jm, jtr=jtr, ttr=ttr,
                jstate=jstate, jnew=jnew, jmetrics=jmetrics, tnew=tnew,
                tmetrics=tmetrics)


def jax_phase1(r):
    """JAX's kept sets and scores for the round `r` ran: phases 1a and 1b
    of `repro/core/protocol.py::_round`, vmapped over the clients with the
    frozen head unbatched, as there (the round returns neither)."""
    jm, jtr = r["jm"], r["jtr"]
    params = r["jstate"]["params"]
    data = jtree(cohort(r["arch"], r["modal"]))
    trainable = broadcast_to_clients(
        {"tail": params["tail"], "prompt": params["prompt"]}, K)
    opt = jtr.opt_local

    def local(hd, tr, os, d):
        return jlocal(jm, hd, tr, opt, os, d, batch_size=BATCH, n_epochs=1,
                      impl="ref")

    trainable, _, _ = jax.jit(jax.vmap(local, in_axes=(None, 0, 0, 0)))(
        params["head"], trainable, jax.vmap(opt.init)(trainable), data)
    scores = jax.jit(jax.vmap(
        lambda hd, tr, d: jscore(jm, hd, tr["tail"], tr["prompt"], d,
                                 batch_size=BATCH, impl="ref"),
        in_axes=(None, 0, 0)))(params["head"], trainable, data)
    keep = jtr.phase2_keep(N_LOCAL)
    return (np.asarray(jnp.argsort(-scores, axis=1)[:, :keep]),
            np.asarray(scores))


def check_round(r):
    jm_, tm_ = r["jmetrics"], r["tmetrics"]
    assert set(jm_) == set(tm_)
    for key in ("local_loss", "split_loss", "el2n_mean"):
        np.testing.assert_allclose(tm_[key], jm_[key], **TOL, err_msg=key)
    for key in jm_:
        if key.startswith(("wire/", "cohort/")) or key == "kept_frac":
            assert tm_[key] == jm_[key], key
    assert tm_["kept_frac"] == 0.5
    assert r["tnew"]["round"] == int(r["jnew"]["round"]) == 1
    assert_tree_close(r["tnew"]["params"], r["jnew"]["params"], **TOL)
    assert r["ttr"].meter.state_dict() == r["jtr"].meter.state_dict()


def check_kept(r):
    kept, scores = jax_phase1(r)
    np.testing.assert_allclose(r["ttr"].last_scores.numpy(), scores, **TOL)
    np.testing.assert_array_equal(r["ttr"].last_kept.numpy(), kept)


def check_evaluate(r):
    test = lm_data(r["arch"], 16, 1, r["modal"])
    want = r["jtr"].evaluate(r["jnew"]["params"], jtree(test),
                             batch_size=BATCH)
    got = r["ttr"].evaluate(r["tnew"]["params"], test, batch_size=BATCH)
    np.testing.assert_allclose(got["ce"], want["ce"], **TOL)
    assert got["acc"] == want["acc"]


def round_cache():
    """`get(arch, wire, modal)`: `run_round`'s result, run once for the
    module that owns the cache."""
    cache = {}

    def get(arch, wire, modal=True):
        if (arch, wire, modal) not in cache:
            cache[arch, wire, modal] = run_round(arch, wire, modal)
        return cache[arch, wire, modal]
    return get


def engine_messages(arch):
    """The messages both packages' dense and paged engines refuse the
    model with."""
    jm, tm = models(arch, "fp32")
    msgs = {}
    for name, make in (
            ("jax dense", lambda: JServeEngine(jm, None, None,
                                               JServeConfig())),
            ("port dense", lambda: ServeEngine(tm, None, None, ServeConfig(),
                                               device="cpu")),
            ("jax paged", lambda: JPagedServeEngine(jm, None, None,
                                                    JPagedServeConfig())),
            ("port paged", lambda: PagedServeEngine(
                tm, None, None, PagedServeConfig(), device="cpu"))):
        with pytest.raises(ValueError) as err:
            make()
        msgs[name] = str(err.value)
    return msgs


def check_engines_refuse(arch, reason):
    msgs = engine_messages(arch)
    assert msgs["port dense"] == msgs["jax dense"]
    assert "has no token decode loop" in msgs["port dense"]
    assert msgs["port paged"] == msgs["jax paged"]
    assert reason in msgs["port paged"]
    jm, tm = models(arch, "fp32")
    assert tm.paged_cache_unsupported() == jm.paged_cache_unsupported()


# -------------------------------------------------------------- layers
@pytest.mark.parametrize("d,n", [(64, 16), (512, 16), (512, 4)])
def test_sinusoidal_embedding_matches_jax(d, n):
    """The reduced encoder's 16 frames at d_model 64, the published
    width's 512 at the same positions, and decode positions (B, 1)."""
    pos = np.arange(n, dtype=np.int32)[None].repeat(2, 0)
    if n == 4:
        pos = np.array([[3], [11]], np.int32)
    want = np.asarray(JL.sinusoidal_embedding(jnp.asarray(pos), d))
    got = L.sinusoidal_embedding(torch.from_numpy(pos), d)
    assert got.shape == want.shape == pos.shape + (d,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("S", [1, 7])
def test_cross_attention_matches_jax(S):
    """The decoder's cross-attention half on bridged weights: S queries
    (1: a decode step) over the 16 encoder frames, no mask; its
    differentiable pass (the plain form) gives the same value."""
    jc, tc = cfg(jget_config, ARCH), cfg(get_config, ARCH)
    key = jax.random.PRNGKey(3)
    jp = JL.init_attention(key, jc, cross=True)
    jp.update(JL.init_cross_attention_extra(jax.random.fold_in(key, 1), jc))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    enc = rng.standard_normal((2, 16, 64)).astype(np.float32)
    pos = np.zeros((2, S), np.int32)
    want = JL.apply_cross_attention(
        jp, jc, jnp.asarray(x),
        JL.Ctx(mode="train", positions=jnp.asarray(pos),
               encoder_out=jnp.asarray(enc)))
    tp = jax_to_torch(jp, "cpu")
    for differentiable in (False, True):
        got = L.apply_cross_attention(
            tp, tc, torch.from_numpy(x),
            L.Ctx(mode="train", positions=torch.from_numpy(pos),
                  encoder_out=torch.from_numpy(enc),
                  differentiable=differentiable))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)


def test_whisper_params_bridge_key_for_key():
    """The port's own init has JAX's keys and shapes, the encoder in the
    head; the segment counts are JAX's."""
    jm, tm = models(ARCH, "fp32")
    params = jm.init(jax.random.PRNGKey(0))
    own = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert "encoder" in own["head"]
    assert {"ln_cross", "cq", "ck", "cv", "co"} <= set(
        own["head"]["stack"]["pos0"]["attn"])
    jflat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(jflat) == len(tree_leaves(own))
    for path, leaf in jflat:
        node = own
        for p in path:
            node = node[p.key]
        assert tuple(leaf.shape) == tuple(node.shape), path
    for seg in ("head", "body", "tail"):
        assert tm._segment_params_count(seg) == \
            jm._segment_params_count(seg), seg


def test_whisper_cross_attention_uses_encoder():
    """tests/test_split.py's contract on both packages: the encoder lives
    in the head (client side), the decoder logits move with the frames,
    and the two packages agree on both."""
    jm, tm = models(ARCH, "fp32")
    c = tm.cfg
    params = jm.init(jax.random.PRNGKey(0))
    tparams = jax_to_torch(params, "cpu")
    assert "encoder" in params["head"] and "encoder" in tparams["head"]
    rng = np.random.default_rng(5)
    toks = rng.integers(0, VOCAB, (2, 12)).astype(np.int32)
    fr = (0.05 * rng.standard_normal((2, c.encoder.n_frames, c.d_model))
          ).astype(np.float32)
    outs = {}
    for sign in (1.0, -1.0):
        b = {"tokens": toks, "frames": sign * fr}
        j = np.asarray(jm.forward(params, jtree(b), route="split",
                                  mode="train")["logits"])
        t = tm.forward(tparams, ttree(b), route="split",
                       mode="train")["logits"].numpy()
        np.testing.assert_allclose(t, j, **TOL)
        outs[sign] = t
    assert np.abs(outs[1.0] - outs[-1.0]).max() > 1e-4


# --------------------------------------------------------------- split
@pytest.mark.parametrize("route", ["split", "local"])
@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_whisper_train_forward_matches_jax(wire, route):
    out = check_forward(ARCH, wire, route)
    assert out["logits"].shape == (3, 9 + PROMPT, VOCAB)


@pytest.mark.parametrize("wire,window", [("fp32", 32), ("int8", 8)])
def test_whisper_prefill_then_decode_matches_jax(wire, window):
    """Window 8 < prompt + tokens makes the decoder's ring wrap; the
    cache's `encoder_out` (batch axis first) is written at prefill and
    read at every decode step."""
    b = check_serve(ARCH, wire, window)
    # the encoder output rides in the head's output: only the decoder's
    # (B, 11, 64) and (B, 1, 64) activations cross each link
    per = {"fp32": 4, "int8": 1}[wire]
    scale = 4 if wire == "int8" else 0
    assert b["prefill"]["head_body"] == 2 * 11 * (64 * per + scale)
    assert b["decode"]["head_body"] == 2 * (64 * per + scale)


def test_whisper_slot_cache_encoder_axis():
    """`cache_write_slot` / `cache_read_slot` take `encoder_out`'s slot on
    its batch axis 0, every other leaf's on axis 1."""
    _, tm = models(ARCH, "fp32")
    shared = tm.init_cache(3, seq_len=16, device="cpu")
    assert shared["head"]["encoder_out"].shape == (3, 16, 64)
    single = tree_map(lambda x: torch.full_like(x, 3),
                      tm.blank_slot_cache(16, device="cpu"))
    tm.cache_write_slot(shared, single, 1)
    back = tm.cache_read_slot(shared, 1)
    for a, b in zip(tree_leaves(back), tree_leaves(single)):
        assert torch.equal(a, b)
    enc = shared["head"]["encoder_out"]
    assert (enc[1] == 3).all() and (enc[0] == 0).all() and (enc[2] == 0).all()


# --------------------------------------------------------------- round
@pytest.fixture(scope="module")
def rounds():
    return round_cache()


@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_whisper_round_matches_jax(rounds, wire):
    check_round(rounds(ARCH, wire))


def test_whisper_kept_sets_match_jax(rounds):
    check_kept(rounds(ARCH, "fp32"))


def test_whisper_evaluate_matches_jax(rounds):
    check_evaluate(rounds(ARCH, "fp32"))


def test_whisper_token_only_round_fails_as_jax():
    """Without `frames` the encoder has nothing to read: JAX's round
    raises KeyError('frames'), and so does the port's."""
    jm, tm = models(ARCH, "fp32")
    data = cohort(ARCH, modal=False)
    assert set(data) == {"tokens"}
    jtr = JSFPromptTrainer(jm, JProtocolConfig(**PCFG))
    with pytest.raises(KeyError, match="frames"):
        jtr.round(jtr.init(jax.random.PRNGKey(0)), jtree(data))
    ttr = SFPromptTrainer(tm, ProtocolConfig(**PCFG), device="cpu")
    with pytest.raises(KeyError, match="frames"):
        ttr.round(ttr.init(torch.Generator().manual_seed(0)), data)


# ------------------------------------------------------------- engines
def test_whisper_engines_refuse_as_jax():
    check_engines_refuse(ARCH, "arch_type 'audio' has no token decode loop")
