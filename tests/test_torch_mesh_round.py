"""The port's SFPrompt round on a data-only mesh of host ranks, against its
own unsharded round and the JAX package's single-device round.

The setup is tests/test_mesh_round.py's: the reduced ViT (3 layers,
d_model 32, d_ff 48, prompt 2), 4 samples of 32x32 a client, batch 4,
momentum 0, K = 8 with the first 2 clients dropped and the next one late
(40% of its traffic). Four ranks are spawned once for the module (a gloo
group on the CPU, one thread each); each trains its block of 2 clients,
the blocks are assembled by all-reduces and the aggregator runs
replicated. The ranks import no JAX: the JAX round runs here, in the
pytest process, and its init, data and results reach the ranks as an
.npz file.

Held: the mesh round (clear, secure, int8 wire, FSDP) is bit-equal to the
port's unsharded round on the same rank; params within rtol 1e-5 and
atol 1e-6 of JAX's single-device round (its own mesh tests' bound),
every metric within rtol 1e-5 and every metered byte equal; the same for
`client_updates`; the frozen body held once a rank; and a
`FederatedEngine` on the mesh resumed from a checkpoint written by rank 0
continues bit for bit."""
import os

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn_ranks

K, N_LOCAL, BATCH, RANKS = 8, 4, 4, 4
SPLIT = dict(head_cycles=1, tail_cycles=1, prompt_len=2, prune_gamma=0.5,
             local_epochs=1)
PCFG = dict(clients_per_round=K, local_epochs=1, batch_size=BATCH,
            momentum=0.0)
TOL = dict(rtol=1e-5, atol=1e-6)
SECURE_SEED = 11
FSDP_THRESHOLD = 256


def reduced_vit(get_config):
    return get_config("vit-base").reduced(n_layers=3, d_model=32, d_ff=48)


def dropout_participation(k, n_dropped=2, n_late=1):
    transmit = np.ones(k, np.float32)
    aggregate = np.ones(k, np.float32)
    aggregate[:n_dropped] = 0.0
    transmit[:n_dropped] = 0.0
    transmit[n_dropped:n_dropped + n_late] = 0.4
    return {"transmit": transmit, "aggregate": aggregate}


def flat(tree, prefix=""):
    """{'a/b': numpy} of a nested dict of tensors or arrays."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (v.detach().cpu().numpy() if torch.is_tensor(v)
                               else np.asarray(v))
    return out


def nest(flat_arrays):
    out = {}
    for key, v in flat_arrays.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


# ------------------------------------------------------ the JAX side
def jax_references(path):
    """JAX's init, cohort and single-device rounds (clear and secure, the
    dropout plan) and client_updates, written to `path`."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.core import ProtocolConfig, SFPromptTrainer, SplitConfig
    from repro.core import SplitModel
    from repro.core.aggregation import get_aggregator
    from repro.data import DATASETS, synthetic_image_dataset

    data = synthetic_image_dataset(DATASETS["cifar10-syn"], K * N_LOCAL,
                                   seed=0, image_hw=32)
    cohort = {k: v.reshape((K, N_LOCAL) + v.shape[1:])
              for k, v in data.items()}
    part = dropout_participation(K)
    model = SplitModel(reduced_vit(get_config), SplitConfig(**SPLIT))
    out = {}
    for name, v in cohort.items():
        out[f"data/{name}"] = v
    init = None
    for secure in (False, True):
        agg = (get_aggregator(secure=True, impl="ref", seed=SECURE_SEED)
               if secure else None)
        tr = SFPromptTrainer(model, ProtocolConfig(**PCFG), agg)
        state = tr.init(jax.random.PRNGKey(0))
        init = state["params"]
        new, metrics = tr.round(state, {k: jnp.asarray(v)
                                        for k, v in cohort.items()},
                                {k: jnp.asarray(v) for k, v in part.items()})
        tag = "secure" if secure else "clear"
        for key, v in flat(jax.tree.map(np.asarray, new["params"])).items():
            out[f"{tag}/params/{key}"] = v
        for key, v in metrics.items():
            out[f"{tag}/metrics/{key}"] = np.float64(v)
        for key, v in tr.meter.totals.items():
            out[f"{tag}/meter/{key}"] = np.float64(v)
    for key, v in flat(jax.tree.map(np.asarray, init)).items():
        out[f"init/{key}"] = v
    tr = SFPromptTrainer(model, ProtocolConfig(
        **PCFG, return_client_trainable=True))
    contrib, _ = tr.client_updates(tr.init(jax.random.PRNGKey(0)),
                                   {k: jnp.asarray(v)
                                    for k, v in cohort.items()})
    for key, v in flat(jax.tree.map(np.asarray, contrib)).items():
        out[f"updates/{key}"] = v
    np.savez(path, **out)


def section(npz, prefix):
    return {k[len(prefix) + 1:]: npz[k] for k in npz.files
            if k.startswith(prefix + "/")}


# ------------------------------------------------------- the ranks
def _trainer(model, pcfg, secure, mesh, **kw):
    from repro_torch.core import SFPromptTrainer
    from repro_torch.core.aggregation import get_aggregator
    agg = get_aggregator(secure=True, seed=SECURE_SEED) if secure else None
    return SFPromptTrainer(model, pcfg, agg, mesh=mesh, device="cpu", **kw)


def _round(model, pcfg, init, cohort, part, *, secure=False, mesh=None,
           updates=False, **kw):
    """One round (or client_updates) from the JAX init; returns the
    whole params (or contributions), metrics, meter totals and trainer."""
    from repro_torch.bridge import jax_to_torch
    tr = _trainer(model, pcfg, secure, mesh, **kw)
    state = {"params": tr.shard_params(jax_to_torch(init, "cpu")),
             "round": 0}
    body_ptrs = [x.local.data_ptr() if hasattr(x, "local") else
                 x.data_ptr() for x in _leaves(state["params"]["body"])]
    if updates:
        contrib, metrics = tr.client_updates(state, cohort)
        return {"params": flat(contrib), "metrics": metrics}
    new, metrics = tr.round(state, cohort, part)
    after = [x.local.data_ptr() if hasattr(x, "local") else x.data_ptr()
             for x in _leaves(new["params"]["body"])]
    return {"params": flat(tr.full_params(new["params"])),
            "metrics": metrics, "meter": dict(tr.meter.totals),
            "body_kept": body_ptrs == after,
            "body": [(tuple(x.local.shape if hasattr(x, "local")
                            else x.shape), tuple(x.shape))
                     for x in _leaves(new["params"]["body"])]}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _engine(model, pcfg, data, mesh):
    from repro_torch.fed import (ClientSampler, FederatedEngine, Population,
                                 RoundScheduler, StragglerConfig)
    pop = Population.from_partition(data, 16, scheme="iid", seed=0)
    tr = _trainer(model, pcfg, False, mesh)
    return FederatedEngine(tr, pop, ClientSampler(16, K, seed=7),
                           RoundScheduler(StragglerConfig(dropout_rate=0.25),
                                          seed=7))


def rank_program(ref_path, ckpt_dir):
    """Every rank: the mesh rounds; rank 0 also the unsharded ones."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import ProtocolConfig, SplitConfig, SplitModel
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import WireSpec

    refs = np.load(ref_path)
    init = nest(section(refs, "init"))
    cohort = section(refs, "data")
    part = dropout_participation(K)
    cfg = reduced_vit(get_config)
    model = SplitModel(cfg, SplitConfig(**SPLIT))
    int8 = SplitModel(cfg, SplitConfig(**SPLIT), WireSpec.make("int8"))
    pcfg = ProtocolConfig(**PCFG)
    upcfg = dataclasses.replace(pcfg, return_client_trainable=True)
    mesh = make_host_mesh(RANKS)
    lead = dist.get_rank() == 0
    out = {"mesh": {}, "flat": {}}
    runs = {"clear": dict(model=model), "secure": dict(model=model,
                                                        secure=True),
            "int8": dict(model=int8),
            "fsdp": dict(model=model, fsdp=True,
                         fsdp_threshold=FSDP_THRESHOLD),
            "updates": dict(model=model, updates=True)}
    for name, kw in runs.items():
        kw = dict(kw)
        m = kw.pop("model")
        p = upcfg if kw.get("updates") else pcfg
        out["mesh"][name] = _round(m, p, init, cohort, part, mesh=mesh, **kw)
        if lead:
            kw.pop("fsdp", None)
            kw.pop("fsdp_threshold", None)
            out["flat"][name] = _round(m, p, init, cohort, part, **kw)

    # a FederatedEngine on the mesh: 2 rounds straight, and 1 round, a
    # checkpoint (rank 0 writes it), a new engine restored, 1 more round
    data = {k: v.reshape((K * N_LOCAL,) + v.shape[2:])
            for k, v in cohort.items()}
    gen = torch.Generator().manual_seed(0)
    straight = _engine(model, pcfg, data, mesh)
    straight.init(gen.manual_seed(0))
    for _ in range(2):
        straight.run_round()
    first = _engine(model, pcfg, data, mesh)
    first.init(gen.manual_seed(0))
    first.run_round()
    path = first.save(ckpt_dir)
    resumed = _engine(model, pcfg, data, mesh)
    assert resumed.restore(ckpt_dir)
    resumed.run_round()
    out["engine"] = {
        "straight": flat(straight.trainer.full_params(straight.params)),
        "resumed": flat(resumed.trainer.full_params(resumed.params)),
        "meters": (straight.trainer.meter.as_dict(),
                   resumed.trainer.meter.as_dict()),
        "path": path, "files": sorted(os.listdir(ckpt_dir))}
    if lead:
        one = _engine(model, pcfg, data, None)
        one.init(gen.manual_seed(0))
        for _ in range(2):
            one.run_round()
        out["engine"]["flat"] = flat(one.params)
        out["engine"]["flat_meter"] = one.trainer.meter.as_dict()
    return out


# ---------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_round")
    ref_path = str(tmp / "refs.npz")
    jax_references(ref_path)
    ckpt = tmp / "ckpt"
    ckpt.mkdir()
    ranks = spawn_ranks(rank_program, RANKS, ref_path, str(ckpt))
    return np.load(ref_path), ranks


def assert_bit_equal(a, b, label):
    assert a.keys() == b.keys(), label
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{label} {k}")


# ------------------------------------------------------------- tests
@pytest.mark.parametrize("name", ["clear", "secure", "int8", "fsdp",
                                  "updates"])
def test_data_mesh_round_bit_equal_to_unsharded(runs, name):
    _, ranks = runs
    mesh, flat_ = ranks[0]["mesh"][name], ranks[0]["flat"][name]
    assert_bit_equal(mesh["params"], flat_["params"], name)
    assert mesh["metrics"] == flat_["metrics"], name
    if "meter" in flat_:
        assert mesh["meter"] == flat_["meter"], name
    # every rank ends the round holding the same trained trees
    for r in ranks[1:]:
        assert_bit_equal(r["mesh"][name]["params"], mesh["params"], name)
        assert r["mesh"][name]["metrics"] == mesh["metrics"], name


@pytest.mark.parametrize("name", ["clear", "secure"])
def test_data_mesh_round_matches_jax(runs, name):
    refs, ranks = runs
    got = ranks[0]["mesh"][name]
    want = section(refs, f"{name}/params")
    assert got["params"].keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got["params"][k], want[k], err_msg=k,
                                   **TOL)
    jm = section(refs, f"{name}/metrics")
    assert set(got["metrics"]) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   err_msg=k)
        if k.startswith("wire/") or k.startswith("cohort/"):
            assert got["metrics"][k] == v, k        # bytes exactly
    assert got["meter"] == {k: float(v) for k, v in
                            section(refs, f"{name}/meter").items()}


def test_data_mesh_client_updates_match_jax(runs):
    refs, ranks = runs
    got = ranks[0]["mesh"]["updates"]["params"]
    want = section(refs, "updates")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == (K,) + want[k].shape[1:]
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_frozen_body_held_once_a_rank(runs):
    """The round reads the one frozen body a rank holds: no copy of it, K
    times or once, and under FSDP each large leaf holds 1/4 of its rows."""
    _, ranks = runs
    for r in ranks:
        for name in ("clear", "secure", "int8", "fsdp"):
            assert r["mesh"][name]["body_kept"], name
        plain = r["mesh"]["clear"]["body"]
        assert all(local == full for local, full in plain)
        fsdp = r["mesh"]["fsdp"]["body"]
        cut = [(local, full) for local, full in fsdp if local != full]
        assert cut
        for local, full in cut:
            assert np.prod(local) * RANKS == np.prod(full), (local, full)


def test_engine_resume_on_mesh_bit_identical(runs):
    _, ranks = runs
    eng = ranks[0]["engine"]
    assert_bit_equal(eng["resumed"], eng["straight"], "resume")
    assert eng["meters"][0] == eng["meters"][1]
    # the mesh engine is the unsharded engine, bit for bit
    assert_bit_equal(eng["straight"], eng["flat"], "flat")
    assert eng["meters"][0] == eng["flat_meter"]
    # rank 0 wrote the one checkpoint file, and every rank resumed from it
    assert eng["files"] == [os.path.basename(eng["path"])]
    for r in ranks[1:]:
        assert r["engine"]["files"] == eng["files"]
        assert_bit_equal(r["engine"]["resumed"], eng["resumed"], "rank")
