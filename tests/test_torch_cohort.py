"""The port's cohort sums against the JAX round's reductions, bit for bit.

`repro_torch.core.protocol.cohort_sum` reproduces XLA's CPU order: one
fused multiply-add per client up to 32 clients, and above 32 separately
rounded products summed by the tree reduction XLA compiles (windows of 32,
zero-padded on both sides, then the window partials). It is held against a
standalone jitted `(a * b).sum()` and inside one SFPrompt round at K = 33
with stragglers and dropouts, on bridged weights and JAX's wire noise."""
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
from repro.data import (DATASETS, iid_partition,  # noqa: E402
                        stack_clients, synthetic_image_dataset)
from repro.runtime import WireSpec as JWireSpec  # noqa: E402
from repro_torch.bridge import jax_to_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ProtocolConfig, SFPromptTrainer,  # noqa: E402
                              SplitConfig, SplitModel)
from repro_torch.core.protocol import cohort_sum  # noqa: E402
from repro_torch.fed.scheduler import (RoundScheduler,  # noqa: E402
                                       StragglerConfig)
from repro_torch.runtime import WireSpec  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_train import jax_wire_noise  # noqa: E402

_jit_sum = jax.jit(lambda a, b: (a * b).sum())


def _draw(rng, K):
    """Per-client wire bytes (multiples of 4, as the meter counts f32
    payloads) and straggler transmit fractions: 1 for the on-time clients,
    a uniform fraction for the rest."""
    per_client = (4 * rng.integers(1, 2_000_000, K)).astype(np.float32)
    late = rng.random(K) < 0.5
    transmit = np.where(late, rng.random(K), 1.0).astype(np.float32)
    return per_client, transmit


@pytest.mark.parametrize("K", [1, 16, 32, 33, 48, 64, 100, 1000, 1025])
def test_cohort_sum_equals_jitted_sum(K):
    rng = np.random.default_rng(K)
    draws = 100 if K <= 100 else 20
    for d in range(draws):
        per_client, transmit = _draw(rng, K)
        want = np.float32(_jit_sum(jnp.asarray(per_client),
                                   jnp.asarray(transmit)))
        got = cohort_sum(per_client, transmit)
        assert got == want, (K, d, got, want)
        # transmit.sum(): the same reduction with unit scales
        ones = np.ones_like(transmit)
        assert cohort_sum(transmit, ones) == np.float32(
            _jit_sum(jnp.asarray(transmit), jnp.asarray(ones))), (K, d)


# a round of 33 clients of 4 samples: above the 32 that one fused
# multiply-add per client covers
K, N_LOCAL, BATCH = 33, 4, 2
SPLIT = dict(head_cycles=1, tail_cycles=1, prompt_len=4, prune_gamma=0.5,
             local_epochs=1)
PCFG = dict(clients_per_round=K, local_epochs=1, batch_size=BATCH,
            lr_local=0.05, lr_split=0.05)


def _cfg(get):
    return get("vit-base").reduced(n_layers=3, d_model=64, d_ff=128)


def test_round_at_33_clients_with_stragglers_matches_jax():
    """int8 wire on JAX's uniforms, a scheduler plan with dropouts and late
    clients (partial transmit): the wire bytes, the transmit sum and the
    params bytes `==` JAX's; params within 1e-5."""
    d = synthetic_image_dataset(DATASETS["cifar10-syn"], K * N_LOCAL,
                                seed=0, image_hw=32)
    cohort = stack_clients(iid_partition(d, K, seed=0), list(range(K)))
    # scheduler seed 8: its transmit fractions make one fused multiply-add
    # per client (the order up to 32) differ from XLA's tree sum
    plan = RoundScheduler(StragglerConfig(dropout_rate=0.2,
                                          late_mode="partial"),
                          seed=8).plan(np.arange(K), 0)
    part = plan.participation()
    assert part["transmit"].min() < 1.0 and plan.dropped.any()
    assert len(np.unique(part["transmit"])) > 2
    jm = JSplitModel(_cfg(jget_config), JSplitConfig(**SPLIT),
                     JWireSpec.make("int8"))
    tm = SplitModel(_cfg(get_config), SplitConfig(**SPLIT),
                    WireSpec.make("int8"))
    jtr = JSFPromptTrainer(jm, JProtocolConfig(**PCFG))
    jstate = jtr.init(jax.random.PRNGKey(0))
    jnew, jmetrics = jtr.round(
        jstate, {k: jnp.asarray(v) for k, v in cohort.items()},
        {k: jnp.asarray(v) for k, v in part.items()})
    ttr = SFPromptTrainer(tm, ProtocolConfig(**PCFG), device="cpu")
    tnew, tmetrics = ttr.round(
        {"params": jax_to_torch(jstate["params"], "cpu"), "round": 0},
        cohort, part, wire_noise=jax_wire_noise(0, K))
    keys = [k for k in jmetrics if k.startswith(("wire/", "cohort/"))]
    assert {"wire/head_body_bytes", "wire/body_tail_bytes",
            "wire/params_bytes", "cohort/transmit_sum"} <= set(keys)
    for key in keys:
        assert np.float32(tmetrics[key]) == np.float32(jmetrics[key]), key
    jflat = jax.tree_util.tree_flatten_with_path(jnew["params"])[0]
    assert len(jflat) == len(tree_leaves(tnew["params"]))
    for path, leaf in jflat:
        node = tnew["params"]
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf),
                                   atol=1e-5, rtol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))

