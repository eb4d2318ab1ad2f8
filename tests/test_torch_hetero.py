"""The port's heterogeneous-cut trainer against the JAX package's, on the
CPU (tests/test_wire.py's hetero round at the reduced ViT: 5 layers,
d_model 64, d_ff 128, a "phone" group cut at 1/1 cycles and a "ws" group at
2/2). Per-group states are bridged from JAX's init and the port's trainers
get JAX's wire uniforms: prompts equal across groups, params within 1e-5,
wire bytes and the shared meter's totals `==`, `evaluate` within 1e-5.
Also the refusal of mismatched prompt lengths and the init generators.

The int8 wire rounds stochastically, and it is exact only while the two
packages' fp32 differences upstream of a boundary (~1e-7 relative) push
no element across a rounding boundary (ROADMAP Queue 3). tests/test_wire.py
runs its round on int8 without pruning: 6 phase-2 steps a client, and each
of the init draws 0-4 flips values there (params up to 1.7e-5 apart, 1.2e-7
on the fp32 wire). So that round is held to JAX's bytes, meter and prompt
on int8 and to JAX's params on fp32, and the params on int8 are held with
EL2N pruning on (gamma 0.5, 3 steps a client) at init draw 1, which flips
none."""
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from test_torch_train import _assert_tree_close, jax_wire_noise  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.core import SplitConfig as JSplitConfig  # noqa: E402
from repro.data import (DATASETS, iid_partition,  # noqa: E402
                        stack_clients, synthetic_image_dataset)
from repro.runtime import WireSpec as JWireSpec  # noqa: E402
from repro.runtime.hetero import ClientPlan as JClientPlan  # noqa: E402
from repro.runtime.hetero import \
    HeteroSFPromptTrainer as JHeteroSFPromptTrainer  # noqa: E402
from repro_torch.bridge import jax_to_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ProtocolConfig, SplitConfig  # noqa: E402
from repro_torch.core.comm import (measured_cost_inputs,  # noqa: E402
                                   sfprompt_comm_breakdown)
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.runtime import WireSpec  # noqa: E402
from repro_torch.runtime.hetero import (ClientPlan,  # noqa: E402
                                        HeteroSFPromptTrainer, group_seed)
from repro_torch.tree import tree_leaves  # noqa: E402

# name -> (wire, prune gamma, init seed)
ROUNDS = {"fp32": ("fp32", 0.0, 0), "int8": ("int8", 0.0, 0),
          "int8_pruned": ("int8", 0.5, 1)}
EXACT = ("fp32", "int8_pruned")    # the rounds that flip no int8 value
TOL = dict(atol=1e-5, rtol=1e-5)
CUTS = ((1, 1, "phone"), (2, 2, "ws"))
PCFG = dict(clients_per_round=2, local_epochs=1, batch_size=8,
            lr_local=0.01, lr_split=0.01, momentum=0.0)


def _cfg(get):
    return get("vit-base").reduced(n_layers=5, d_model=64, d_ff=128)


def _plans(Plan, Split, gamma):
    return [Plan(Split(head_cycles=h, tail_cycles=t, prompt_len=4,
                       prune_gamma=gamma, local_epochs=1), 2, name)
            for h, t, name in CUTS]


def _trainers(wire, gamma):
    jht = JHeteroSFPromptTrainer(_cfg(jget_config),
                                 _plans(JClientPlan, JSplitConfig, gamma),
                                 JProtocolConfig(**PCFG),
                                 JWireSpec.make(wire))
    tht = HeteroSFPromptTrainer(_cfg(get_config),
                                _plans(ClientPlan, SplitConfig, gamma),
                                ProtocolConfig(**PCFG), WireSpec.make(wire),
                                device="cpu")
    return jht, tht


@pytest.fixture(scope="module")
def data():
    d = synthetic_image_dataset(DATASETS["cifar10-syn"], 2 * 2 * 48, seed=0,
                                image_hw=32)
    groups = []
    for g in range(2):
        part = {k: v[g * 96:(g + 1) * 96] for k, v in d.items()}
        clients = iid_partition(part, 2, seed=g)
        groups.append(stack_clients(clients, [0, 1]))
    return d, groups


_ROUNDS = {}


def _round(data, name):
    """The JAX round and the port's from the same states and data, once per
    `ROUNDS` entry for this module."""
    if name not in _ROUNDS:
        wire, gamma, seed = ROUNDS[name]
        full, groups = data
        jht, tht = _trainers(wire, gamma)
        jstates = jht.init(jax.random.PRNGKey(seed))
        jnew, jm = jht.round(jstates, [{k: jnp.asarray(v) for k, v in
                                        g.items()} for g in groups])
        tstates = [{"params": jax_to_torch(s["params"], "cpu"), "round": 0}
                   for s in jstates]
        before = launch_counts()
        # each group's JAX trainer draws its round-0 uniforms from the
        # same key derivation
        tnew, tm = tht.round(tstates, groups, wire_noise=jax_wire_noise(0, 2))
        assert launch_counts() == before      # no kernel on CPU tensors
        _ROUNDS[name] = dict(jht=jht, tht=tht, jnew=jnew, jm=jm, tnew=tnew,
                             tm=tm, full=full)
    return _ROUNDS[name]


@pytest.mark.parametrize("name", list(ROUNDS))
def test_hetero_round_different_cut_points(data, name):
    """Two groups with different head/tail cycle counts train in one round;
    the prompt is globally aggregated, tails stay per group."""
    r = _round(data, name)
    tnew, jnew, tm, jm = r["tnew"], r["jnew"], r["tm"], r["jm"]
    t0 = tree_leaves(tnew[0]["params"]["tail"])
    t1 = tree_leaves(tnew[1]["params"]["tail"])
    assert sum(x.numel() for x in t0) != sum(x.numel() for x in t1)
    assert torch.equal(tnew[0]["params"]["prompt"],
                       tnew[1]["params"]["prompt"])
    assert set(tm) == set(jm)
    for key in jm:
        if "wire/" in key or "cohort/" in key or key.endswith("kept_frac"):
            assert tm[key] == jm[key], key
        elif name in EXACT:
            np.testing.assert_allclose(tm[key], jm[key], **TOL, err_msg=key)
        else:
            assert np.isfinite(tm[key]), key
    assert tm["wire/head_body_bytes"] > 0
    assert r["tht"].meter.rounds == r["jht"].meter.rounds == 1
    assert r["tht"].meter.state_dict() == r["jht"].meter.state_dict()
    for ts, js in zip(tnew, jnew):
        assert ts["round"] == int(js["round"]) == 1
        if name in EXACT:
            _assert_tree_close(ts["params"], js["params"], **TOL)


@pytest.mark.parametrize("name", EXACT)
def test_hetero_evaluate_matches_jax(data, name):
    r = _round(data, name)
    want = r["jht"].evaluate(r["jnew"], {k: jnp.asarray(v) for k, v in
                                         r["full"].items()})
    got = r["tht"].evaluate(r["tnew"], r["full"])
    assert set(got) == set(want)
    for k in ("ce", "acc"):
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    for g, w in zip(got["per_group"], want["per_group"]):
        for k in ("ce", "acc"):
            np.testing.assert_allclose(g[k], w[k], **TOL, err_msg=k)


def test_hetero_bytes_are_the_cost_model_summed_over_groups(data):
    """The shared meter's boundary bytes equal `sfprompt_comm_breakdown`
    bound to each group's model, summed over the groups."""
    r = _round(data, "int8_pruned")
    want = {"head_body": 0.0, "body_tail": 0.0, "params": 0.0}
    for tr in r["tht"].trainers:
        ci = measured_cost_inputs(tr.model, tokens_per_sample=4 + 1,
                                  n_local=48, batch_size=8, K=2)
        for k, v in sfprompt_comm_breakdown(ci).items():
            want[k] += v
    got = r["tht"].meter.as_dict()
    for k, v in want.items():
        assert got[k] == v, k


def test_hetero_rejects_mismatched_prompts():
    cfg = _cfg(get_config)
    plans = [ClientPlan(SplitConfig(prompt_len=4), 1),
             ClientPlan(SplitConfig(prompt_len=8), 1)]
    with pytest.raises(ValueError, match="prompt_len"):
        HeteroSFPromptTrainer(cfg, plans, ProtocolConfig(), device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        HeteroSFPromptTrainer(cfg, [], ProtocolConfig(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            HeteroSFPromptTrainer(cfg, plans[:1], ProtocolConfig())


def test_hetero_init_derives_a_generator_per_group():
    _, tht = _trainers("fp32", 0.0)
    one = tht.init(torch.Generator().manual_seed(5))
    again = tht.init(torch.Generator().manual_seed(5))
    for i, (a, b) in enumerate(zip(one, again)):
        own = tht.trainers[i].init(torch.Generator().manual_seed(
            group_seed(5, i)))
        for x, y, z in zip(tree_leaves(a["params"]), tree_leaves(b["params"]),
                           tree_leaves(own["params"])):
            assert torch.equal(x, y) and torch.equal(x, z)
    # the groups draw from different streams
    assert not torch.equal(one[0]["params"]["prompt"],
                           one[1]["params"]["prompt"])
