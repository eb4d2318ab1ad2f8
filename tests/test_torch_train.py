"""The port's SFPrompt training round against the JAX package's, on bridged
weights, at the reduced ViT of tests/test_protocol.py (3 layers, d_model
64, d_ff 128, prompt 4, 32x32 images: 9 tokens with CLS and prompt).

Inputs come from numpy and are fed to both packages; the JAX side runs its
round as its own tests do on the CPU (`impl="ref"`). One JAX round per wire
is shared by the tests of this module."""
import torch

torch.set_num_threads(2)

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.core import SFPromptTrainer as JSFPromptTrainer  # noqa: E402
from repro.core import SplitConfig as JSplitConfig  # noqa: E402
from repro.core import SplitModel as JSplitModel  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import comm as jcomm  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.data import (DATASETS, iid_partition,  # noqa: E402
                        select_clients, stack_clients,
                        synthetic_image_dataset)
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import apply_updates as japply  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.runtime import WireSpec as JWireSpec  # noqa: E402
from repro_torch.bridge import jax_to_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ProtocolConfig, SFPromptTrainer,  # noqa: E402
                              SplitConfig, SplitModel)
from repro_torch.core import aggregation, comm, losses, pruning  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.optim import adamw, apply_updates, sgd  # noqa: E402
from repro_torch.runtime import WireSpec  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
K, N_LOCAL, BATCH = 2, 24, 8
SPLIT = dict(head_cycles=1, tail_cycles=1, prompt_len=4, prune_gamma=0.5,
             local_epochs=1)
PCFG = dict(clients_per_round=K, local_epochs=1, batch_size=BATCH,
            lr_local=0.05, lr_split=0.05)


def _cfg(get):
    return get("vit-base").reduced(n_layers=3, d_model=64, d_ff=128)


def _models(wire):
    jm = JSplitModel(_cfg(jget_config), JSplitConfig(**SPLIT),
                     JWireSpec.make(wire))
    tm = SplitModel(_cfg(get_config), SplitConfig(**SPLIT),
                    WireSpec.make(wire))
    return jm, tm


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(t_tree, j_tree, **tol):
    jflat = jax.tree_util.tree_flatten_with_path(_np(j_tree))[0]
    assert len(jflat) == len(tree_leaves(t_tree))
    for path, leaf in jflat:
        node = t_tree
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node.detach().numpy(), leaf,
                                   err_msg=jax.tree_util.keystr(path), **tol)


@pytest.fixture(scope="module")
def data():
    """Train and test are slices of ONE synthetic draw (class anchors depend
    on the seed and n)."""
    d = synthetic_image_dataset(DATASETS["cifar10-syn"], 8 * N_LOCAL + 64,
                                seed=0, image_hw=32)
    train = {k: v[:8 * N_LOCAL] for k, v in d.items()}
    test = {k: v[8 * N_LOCAL:] for k, v in d.items()}
    clients = iid_partition(train, 8, seed=0)
    cohort = stack_clients(clients, select_clients(8, K, seed=0,
                                                   round_idx=0))
    return cohort, test


def jax_wire_noise(round_idx, k):
    """The uniforms the JAX round draws: fold_in(PRNGKey(23), round) ->
    split(K) -> fold_in(step) -> split into (k_hb, k_bt) -> each split into
    (kf, kb) -> uniform."""
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(23),
                                               round_idx), k)

    def noise(client, step, name, shape):
        k_hb, k_bt = jax.random.split(jax.random.fold_in(keys[client], step))
        kf, kb = jax.random.split(k_hb if name == "head_body" else k_bt)
        return tuple(torch.from_numpy(np.array(
            jax.random.uniform(key, shape, jnp.float32))) for key in (kf, kb))
    return noise


def _run_round(wire, cohort, seed):
    jm, tm = _models(wire)
    jtr = JSFPromptTrainer(jm, JProtocolConfig(**PCFG))
    jstate = jtr.init(jax.random.PRNGKey(seed))
    jcohort = {k: jnp.asarray(v) for k, v in cohort.items()}
    jnew, jmetrics = jtr.round(jstate, jcohort)
    ttr = SFPromptTrainer(tm, ProtocolConfig(**PCFG), device="cpu")
    tstate = {"params": jax_to_torch(jstate["params"], "cpu"), "round": 0}
    before = launch_counts()
    tnew, tmetrics = ttr.round(tstate, cohort,
                               wire_noise=jax_wire_noise(0, K))
    assert launch_counts() == before          # no kernel on CPU tensors
    return dict(jm=jm, tm=tm, jtr=jtr, ttr=ttr, jstate=jstate,
                jnew=jnew, jmetrics=jmetrics, tnew=tnew, tmetrics=tmetrics)


@pytest.fixture(scope="module")
def fp32_round(data):
    return _run_round("fp32", data[0], seed=0)


# The int8 wire is exact only while the packages' fp32 differences upstream
# of a boundary (~1e-7 relative) push no element across a quantizer
# rounding boundary (ROADMAP Queue 3). This seed's draw flips none.
INT8_SEED = 0


@pytest.fixture(scope="module")
def int8_round(data):
    return _run_round("int8", data[0], seed=INT8_SEED)


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("route", ["split", "local"])
def test_vit_forward_matches_jax(route):
    jm, tm = _models("fp32")
    params = jm.init(jax.random.PRNGKey(1))
    x = np.random.default_rng(2).standard_normal((3, 4, 768)).astype(
        np.float32)
    jout = jm.forward(params, {"patches": jnp.asarray(x)}, route=route)
    tout = tm.forward(jax_to_torch(params, "cpu"),
                      {"patches": torch.from_numpy(x)}, route=route)
    assert tout["logits"].shape == (3, 10)
    np.testing.assert_allclose(tout["logits"].numpy(),
                               np.asarray(jout["logits"]), **TOL)
    np.testing.assert_allclose(tout["hidden"].numpy(),
                               np.asarray(jout["hidden"]), **TOL)
    assert tout["wire_bytes"] == {k: float(v) for k, v in
                                  jout["wire_bytes"].items()}


def test_vit_params_bridge_key_for_key_and_sizes():
    jm, tm = _models("fp32")
    params = jm.init(jax.random.PRNGKey(0))
    tparams = jax_to_torch(params, "cpu")
    for key in ("patch", "cls", "pos"):
        assert key in tparams["head"]["embed"]
    assert "head" in tparams["tail"]
    _assert_tree_close(tparams, params, atol=0, rtol=0)
    own = tm.init(torch.Generator().manual_seed(0), device="cpu")
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
    assert tm.segment_fractions() == jm.segment_fractions()


# ------------------------------------------------------------ losses
def test_losses_and_logit_grads_match_jax():
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((12, 10))).astype(np.float32)
    labels = rng.integers(0, 10, 12).astype(np.int32)
    lm_logits = rng.standard_normal((3, 9, 17)).astype(np.float32)
    tokens = rng.integers(0, 17, (3, 7)).astype(np.int32)
    cases = [
        (lambda lg: jlosses.classifier_loss(lg, jnp.asarray(labels),
                                            impl="ref"),
         lambda lg: losses.classifier_loss(lg, torch.from_numpy(labels)),
         logits),
        (lambda lg: jlosses.lm_loss(lg, jnp.asarray(tokens), 2, impl="ref"),
         lambda lg: losses.lm_loss(lg, torch.from_numpy(tokens), 2),
         lm_logits),
    ]
    for jfn, tfn, x in cases:
        (jl, jm), jg = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_(True)
        tl, tm_ = tfn(xt)
        (tg,) = torch.autograd.grad(tl, xt)
        np.testing.assert_allclose(tl.item(), float(jl), **TOL)
        np.testing.assert_allclose(float(tm_["acc"]), float(jm["acc"]))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    cfg = _cfg(get_config)
    out = {"logits": torch.from_numpy(logits)}
    batch = {"labels": torch.from_numpy(labels)}
    np.testing.assert_allclose(
        losses.task_el2n(cfg, out, batch).numpy(),
        np.asarray(jlosses.task_el2n(_cfg(jget_config),
                                     {"logits": jnp.asarray(logits)},
                                     {"labels": jnp.asarray(labels)},
                                     impl="ref")), **TOL)
    el2n, _ = losses.lm_el2n(torch.from_numpy(lm_logits),
                             torch.from_numpy(tokens), 2)
    jel2n, _ = jlosses.lm_el2n(jnp.asarray(lm_logits), jnp.asarray(tokens),
                               2, impl="ref")
    np.testing.assert_allclose(el2n.numpy(), np.asarray(jel2n), **TOL)
    # the DeepSeek MTP term (token t + 2 from position t, weight 0.3) and
    # the aux loss on an LM config: loss, metrics and both logit gradients
    lm_cfg, jlm_cfg = (get("deepseek-v3-671b").reduced(vocab_size=17)
                       for get in (get_config, jget_config))
    mtp = rng.standard_normal((3, 6, 17)).astype(np.float32)

    def jmtp(lg, m):
        return jlosses.task_loss(
            jlm_cfg, {"logits": lg, "mtp_logits": m, "n_prefix": 2,
                      "aux": jnp.float32(0.25)},
            {"tokens": jnp.asarray(tokens)}, impl="ref")

    (jl, jm), jg = jax.value_and_grad(jmtp, argnums=(0, 1), has_aux=True)(
        jnp.asarray(lm_logits), jnp.asarray(mtp))
    xt, mt = (torch.from_numpy(a).requires_grad_(True)
              for a in (lm_logits, mtp))
    tl, tm_ = losses.task_loss(
        lm_cfg, {"logits": xt, "mtp_logits": mt, "n_prefix": 2,
                 "aux": torch.tensor(0.25)},
        {"tokens": torch.from_numpy(tokens)})
    tg = torch.autograd.grad(tl, (xt, mt))
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    assert set(tm_) == set(jm) >= {"mtp_ce", "ce", "acc", "loss"}
    np.testing.assert_allclose(float(tm_["mtp_ce"].detach()),
                               float(jm["mtp_ce"]), **TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ---------------------------------------------------------- optimizers
@pytest.mark.parametrize("name", ["sgd_momentum", "sgd", "adamw"])
def test_optimizer_steps_match_jax(name):
    rng = np.random.default_rng(4)
    shapes = {"a": (3, 5), "b": {"c": (7,)}}
    params = jax.tree.map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32), params) for _ in range(3)]
    jopt, topt = {
        "sgd_momentum": (jsgd(0.05, momentum=0.9), sgd(0.05, momentum=0.9)),
        "sgd": (jsgd(0.05), sgd(0.05)),
        "adamw": (jadamw(1e-2, weight_decay=0.01),
                  adamw(1e-2, weight_decay=0.01)),
    }[name]
    jp, tp = jax.tree.map(jnp.asarray, params), jax_to_torch(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = japply(jp, ju)
        tu, ts = topt.update(jax_to_torch(g, "cpu"), ts, tp)
        tp = apply_updates(tp, tu)
    _assert_tree_close(tp, jp, **TOL)
    assert int(ts["step"]) == int(js["step"]) == 3


# --------------------------------------------------------- aggregation
def test_fedavg_partial_matches_jax_and_falls_back():
    rng = np.random.default_rng(5)
    trees = {"t": rng.standard_normal((4, 3, 2)).astype(np.float32),
             "p": rng.standard_normal((4, 5)).astype(np.float32)}
    fb = {"t": rng.standard_normal((3, 2)).astype(np.float32),
          "p": rng.standard_normal((5,)).astype(np.float32)}
    for w in ([3.0, 1.0, 0.0, 2.0], [1.0, 1.0, 1.0, 1.0],
              [0.0, 0.0, 0.0, 0.0]):
        w = np.asarray(w, np.float32)
        got = aggregation.fedavg_partial(jax_to_torch(trees, "cpu"),
                                         torch.from_numpy(w),
                                         jax_to_torch(fb, "cpu"))
        want = jagg.fedavg_partial(jax.tree.map(jnp.asarray, trees),
                                   jnp.asarray(w),
                                   jax.tree.map(jnp.asarray, fb))
        _assert_tree_close(got, want, **TOL)
        if not w.any():      # the lost round returns the fallback exactly
            _assert_tree_close(got, fb, atol=0, rtol=0)
    with pytest.raises(ValueError, match="sum to 0"):
        aggregation.fedavg(jax_to_torch(trees, "cpu"), torch.zeros(4))
    bc = aggregation.broadcast_to_clients(jax_to_torch(fb, "cpu"), 3)
    assert bc["t"].shape == (3, 3, 2)
    # secure aggregation is ported (slice 3): the aggregator JAX builds
    secure = aggregation.get_aggregator(secure=True, seed=4)
    assert secure.name == "secure"
    assert secure.describe() == jagg.get_aggregator(secure=True,
                                                    seed=4).describe()
    # hierarchical aggregation is ported (slice E): the edge layout JAX
    # builds, clear and secure
    for kw in ({}, {"secure": True, "seed": 4}):
        hier = aggregation.get_aggregator(n_edges=2, cohort_size=4, **kw)
        assert hier.name == "hierarchical"
        assert hier.describe() == jagg.get_aggregator(
            n_edges=2, cohort_size=4, **kw).describe()


# ------------------------------------------------------------- pruning
def test_score_client_data_ragged_matches_jax():
    """n % batch_size != 0: the last batch wraps to the start and every
    sample gets its own score."""
    jm, tm = _models("fp32")
    params = jm.init(jax.random.PRNGKey(2))
    tparams = jax_to_torch(params, "cpu")
    d = synthetic_image_dataset(DATASETS["cifar10-syn"], 13, seed=3,
                                image_hw=32)
    want = jpruning.score_client_data(
        jm, params["head"], params["tail"], params["prompt"],
        {k: jnp.asarray(v) for k, v in d.items()}, batch_size=4, impl="ref")
    got = pruning.score_client_data(
        tm, tparams["head"], tparams["tail"], tparams["prompt"],
        {k: torch.from_numpy(v) for k, v in d.items()}, batch_size=4)
    assert got.shape == (13,) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pruning_sorts_stably_as_jax():
    """Clamped-zero EL2N scores tie; the kept set follows index order among
    ties, as `jnp.argsort` (stable) does."""
    s = np.array([0.0, 0.5, 0.0, 0.5, 0.0, 0.2, 0.0, 0.5], np.float32)
    for gamma in (0.25, 0.5, 0.75):
        np.testing.assert_array_equal(
            pruning.prune_indices(torch.from_numpy(s), gamma).numpy(),
            np.asarray(jpruning.prune_indices(jnp.asarray(s), gamma)))
    two = np.stack([s, s[::-1].copy()])
    np.testing.assert_array_equal(
        pruning.rank_descending(torch.from_numpy(two), dim=1).numpy(),
        np.asarray(jnp.argsort(-jnp.asarray(two), axis=1)))
    d = {"x": torch.arange(8)}
    kept, n = pruning.prune_client_data(d, torch.from_numpy(s), 0.5)
    assert n == 4 and kept["x"].tolist() == [1, 3, 7, 5]
    for n_local, gamma, bs in ((24, 0.5, 8), (64, 0.5, 16), (13, 0.3, 4),
                               (8, 0.9, 8)):
        assert pruning.pruned_keep_count(n_local, gamma, bs) == \
            jpruning.pruned_keep_count(n_local, gamma, bs)


# --------------------------------------------------------------- rounds
def _check_round(r, params_tol):
    jm_, tm_ = r["jmetrics"], r["tmetrics"]
    assert set(jm_) == set(tm_)
    for key in ("local_loss", "split_loss", "el2n_mean"):
        np.testing.assert_allclose(tm_[key], jm_[key], **TOL, err_msg=key)
    for key in jm_:
        if key.startswith(("wire/", "cohort/")) or key == "kept_frac":
            assert tm_[key] == jm_[key], key
    assert r["tnew"]["round"] == int(r["jnew"]["round"]) == 1
    _assert_tree_close(r["tnew"]["params"], r["jnew"]["params"], **params_tol)
    assert r["ttr"].meter.state_dict() == r["jtr"].meter.state_dict()


def test_round_fp32_wire_matches_jax(fp32_round):
    _check_round(fp32_round, TOL)


def test_round_int8_wire_on_jax_noise_matches_jax(int8_round):
    """Injected JAX uniforms on both boundaries, forward and backward: bytes
    ==, and params within the fp32 tolerance on this draw (no quantizer
    value flips; see INT8_SEED)."""
    _check_round(int8_round, TOL)


def test_round_only_tail_and_prompt_change(fp32_round):
    new, old = fp32_round["tnew"]["params"], fp32_round["jstate"]["params"]
    _assert_tree_close(new["head"], old["head"], atol=0, rtol=0)
    _assert_tree_close(new["body"], old["body"], atol=0, rtol=0)
    assert not np.allclose(new["prompt"].numpy(), np.asarray(old["prompt"]))


def test_round_participation_partial_matches_jax(data):
    """A straggler at half transmit and a dropped client: bytes scale with
    transmit, the dropped client's tail is excluded from FedAvg. Each
    client starts from its own (personalized) tail."""
    cohort, _ = data
    part = {"transmit": np.array([1.0, 0.5], np.float32),
            "aggregate": np.array([1.0, 0.0], np.float32)}
    jm, tm = _models("fp32")
    pcfg = dict(PCFG, local_epochs=0, use_local_loss=False)
    jtr = JSFPromptTrainer(jm, JProtocolConfig(**pcfg))
    jstate = jtr.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(6)
    tails = jax.tree.map(lambda x: np.stack(
        [np.asarray(x) + 0.01 * rng.standard_normal(x.shape).astype(
            np.float32), np.asarray(x)]), jstate["params"]["tail"])
    jnew, jmetrics = jtr.round(
        jstate, {k: jnp.asarray(v) for k, v in cohort.items()},
        {k: jnp.asarray(v) for k, v in part.items()},
        jax.tree.map(jnp.asarray, tails))
    ttr = SFPromptTrainer(tm, ProtocolConfig(**pcfg), device="cpu")
    tnew, tmetrics = ttr.round(
        {"params": jax_to_torch(jstate["params"], "cpu"), "round": 0},
        cohort, part, tails)
    assert "local_loss" not in tmetrics
    for key in jmetrics:
        if key.startswith(("wire/", "cohort/")):
            assert tmetrics[key] == jmetrics[key], key
    _assert_tree_close(tnew["params"], jnew["params"], **TOL)


def test_evaluate_matches_jax(fp32_round, data):
    _, test = data
    r = fp32_round
    want = r["jtr"].evaluate(r["jnew"]["params"],
                             {k: jnp.asarray(v) for k, v in test.items()},
                             batch_size=16)
    got = r["ttr"].evaluate(r["tnew"]["params"], test, batch_size=16)
    np.testing.assert_allclose(got["ce"], want["ce"], **TOL)
    assert got["acc"] == want["acc"]


def test_trainer_defaults_to_cuda_and_refuses_unported_paths():
    _, tm = _models("fp32")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SFPromptTrainer(tm, ProtocolConfig())
    # DP-SGD is ported (slice 3): a clip alone has no ledger, noise
    # without a clip is refused as in the JAX package
    assert SFPromptTrainer(tm, ProtocolConfig(dp_clip=1.0),
                           device="cpu").accountant is None
    with pytest.raises(ValueError, match="dp_clip"):
        SFPromptTrainer(tm, ProtocolConfig(dp_noise_multiplier=1.0),
                        device="cpu")
    # the mesh is ported (slice H parts 1 and 2): a 'model' axis on an
    # MoE family is taken (tests/test_torch_mesh_moe.py runs it)
    moe = SplitModel(get_config("phi3.5-moe-42b-a6.6b").reduced(n_layers=3),
                     SplitConfig(**SPLIT))
    tp = type("Mesh", (), {"shape": {"data": 1, "model": 2}})()
    assert SFPromptTrainer(moe, ProtocolConfig(), device="cpu",
                           mesh=tp).model.mesh is tp
    # async dispatch is ported (slice E): without the per-client trees it
    # is refused with JAX's message
    tr = SFPromptTrainer(tm, ProtocolConfig(), device="cpu")
    with pytest.raises(ValueError, match="return_client_trainable") as te:
        tr.client_updates({}, {})
    jm, _ = _models("fp32")
    with pytest.raises(ValueError) as je:
        JSFPromptTrainer(jm, JProtocolConfig()).client_updates({}, {})
    assert str(te.value) == str(je.value)


# ------------------------------------------------------------ cost model
def test_cost_model_matches_jax(fp32_round):
    jm, tm = fp32_round["jm"], fp32_round["tm"]
    kw = dict(tokens_per_sample=4 + 1, n_local=N_LOCAL, batch_size=BATCH,
              K=K)
    jci = jcomm.measured_cost_inputs(jm, **kw)
    tci = comm.measured_cost_inputs(tm, **kw)
    assert dataclasses.asdict(jci) == dataclasses.asdict(tci)
    assert comm.sfprompt_comm_breakdown(tci) == \
        jcomm.sfprompt_comm_breakdown(jci)
    for fn in ("fl_comm", "sfl_comm", "sfprompt_comm"):
        assert getattr(comm, fn)(tci) == getattr(jcomm, fn)(jci), fn
    part = dict(transmit_sum=1.5, n_uploads=1.0)
    assert comm.sfprompt_comm_breakdown_partial(tci, **part) == \
        jcomm.sfprompt_comm_breakdown_partial(jci, **part)
    # the round's metered bytes are the model's, exactly
    measured = {k: v for k, v in fp32_round["ttr"].meter.as_dict().items()
                if k in ("head_body", "body_tail", "params")}
    cc = comm.crosscheck(measured, tci)
    assert cc == jcomm.crosscheck(measured, jci)
    assert all(v["err_pct"] == 0.0 for v in cc.values()), cc
    split = SplitConfig(**SPLIT)
    a = comm.cost_inputs_from(_cfg(get_config), split, tokens_per_sample=5,
                              D=N_LOCAL)
    b = jcomm.cost_inputs_from(_cfg(jget_config), JSplitConfig(**SPLIT),
                               tokens_per_sample=5, D=N_LOCAL)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
