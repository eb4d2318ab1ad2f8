"""The port's SFPrompt round on token data against the JAX package's, on
bridged weights: reduced qwen2.5 (dense) and rwkv6 (zamba2 in
tests/test_torch_lm_round_zamba2.py, which imports this module's helpers),
d_model 64, 3 layer-pattern cycles (head 1 / body 1 / tail 1), vocab 128,
prompt 4, sequences of 16, K 2 clients of 8, batch 4, gamma 0.5: wire
bytes, kept sets and kept_frac `==`, params and losses within 1e-5, with
the fp32 wire and with the int8 wire on JAX's own noise; `evaluate`'s CE
within 1e-5 and accuracy `==`.

The int8 wire is exact only while the two packages' fp32 differences
upstream of a boundary push no element across a quantizer rounding
boundary (ROADMAP Queue 3 item 2). `INT8_SEED` fixes, per family, a JAX
init seed whose round flips none: at seed 0 the rwkv6 and zamba2 rounds
each flip a value of the backward gradient, which moves the prompt by up
to 5.6e-5 (rwkv6) and 2.4e-5 (zamba2)."""
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
from repro.runtime import WireSpec as JWireSpec  # noqa: E402
from repro_torch.bridge import jax_to_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ProtocolConfig, SFPromptTrainer,  # noqa: E402
                              SplitConfig, SplitModel)
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.runtime import WireSpec  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
K, N_LOCAL, BATCH, SEQ, VOCAB = 2, 8, 4, 16, 128
SPLIT = dict(head_cycles=1, tail_cycles=1, prompt_len=4, prune_gamma=0.5,
             local_epochs=1)
PCFG = dict(clients_per_round=K, local_epochs=1, batch_size=BATCH,
            lr_local=0.05, lr_split=0.05)
# init seeds whose int8 round flips no quantizer value (module docstring)
INT8_SEED = {"qwen2.5-14b": 0, "zamba2-2.7b": 1, "rwkv6-3b": 1}


def cfg(get, arch):
    cyc = len(get(arch).layer_pattern)
    return get(arch).reduced(n_layers=3 * cyc, d_model=64, d_ff=128,
                             vocab_size=VOCAB)


def models(arch, wire):
    return (JSplitModel(cfg(jget_config, arch), JSplitConfig(**SPLIT),
                        JWireSpec.make(wire)),
            SplitModel(cfg(get_config, arch), SplitConfig(**SPLIT),
                       WireSpec.make(wire)))


def cohort():
    clients = iid_partition(
        synthetic_lm_dataset(4 * N_LOCAL, SEQ, VOCAB, seed=0), 4, seed=0)
    return stack_clients(clients, select_clients(4, K, seed=0, round_idx=0))


def eval_data():
    return synthetic_lm_dataset(16, SEQ, VOCAB, seed=1)


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


def run_round(arch, wire):
    """One JAX round and one port round from the same (JAX-initialised)
    params, data and wire noise."""
    jm, tm = models(arch, wire)
    seed = INT8_SEED[arch] if wire == "int8" else 0
    data = cohort()
    jtr = JSFPromptTrainer(jm, JProtocolConfig(**PCFG))
    jstate = jtr.init(jax.random.PRNGKey(seed))
    jnew, jmetrics = jtr.round(jstate, {k: jnp.asarray(v)
                                        for k, v in data.items()})
    ttr = SFPromptTrainer(tm, ProtocolConfig(**PCFG), device="cpu")
    before = launch_counts()
    tnew, tmetrics = ttr.round(
        {"params": jax_to_torch(jstate["params"], "cpu"), "round": 0}, data,
        wire_noise=jax_wire_noise(0, K))
    assert launch_counts() == before         # no kernel on CPU tensors
    return dict(jm=jm, jtr=jtr, ttr=ttr, jstate=jstate, jnew=jnew,
                jmetrics=jmetrics, tnew=tnew, tmetrics=tmetrics)


def jax_phase1(r):
    """JAX's kept sets and scores for the round `r` ran: phases 1a and 1b
    of `repro/core/protocol.py::_round`, vmapped over the clients with the
    frozen head unbatched, as there (the round returns neither)."""
    jm, jtr = r["jm"], r["jtr"]
    params = r["jstate"]["params"]
    data = {k: jnp.asarray(v) for k, v in cohort().items()}
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


def assert_tree_close(t_tree, j_tree, **tol):
    jflat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, j_tree))[0]
    assert len(jflat) == len(tree_leaves(t_tree))
    for path, leaf in jflat:
        node = t_tree
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node.detach().numpy(), leaf,
                                   err_msg=jax.tree_util.keystr(path), **tol)


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
    test = eval_data()
    want = r["jtr"].evaluate(r["jnew"]["params"],
                             {k: jnp.asarray(v) for k, v in test.items()},
                             batch_size=BATCH)
    got = r["ttr"].evaluate(r["tnew"]["params"], test, batch_size=BATCH)
    np.testing.assert_allclose(got["ce"], want["ce"], **TOL)
    assert got["acc"] == want["acc"]


def round_cache():
    """`get(arch, wire)`: `run_round`'s result, run once for the module
    that owns the cache."""
    cache = {}

    def get(arch, wire):
        if (arch, wire) not in cache:
            cache[arch, wire] = run_round(arch, wire)
        return cache[arch, wire]
    return get


ARCHS = ["qwen2.5-14b", "rwkv6-3b"]


@pytest.fixture(scope="module")
def rounds():
    return round_cache()


@pytest.mark.parametrize("wire", ["fp32", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_round_matches_jax(rounds, arch, wire):
    check_round(rounds(arch, wire))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_kept_sets_match_jax(rounds, arch):
    """Phase 1 runs without the wire, so one check a family: the port's
    scores within 1e-5 of JAX's and its kept sets, in rank order, `==`."""
    check_kept(rounds(arch, "fp32"))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_evaluate_matches_jax(rounds, arch):
    check_evaluate(rounds(arch, "fp32"))
