"""The port's hierarchical (client -> edge -> global) aggregation
(`repro_torch.fed.topology`, `core.aggregation.hierarchical_fedavg`) and
the cost model's edge and async functions against the JAX package's, on
the CPU, at the reduced ViT of tests/test_mesh_round.py (3 layers, d_model
32, d_ff 48): the topology's validation and layout, the two-tier mean,
clear and secure hierarchical rounds (bytes `==`, params within 1e-5 or a
fixed-point quantum), the aggregator's refusals, a resume through the
engine, the five comm functions `==`, and `launch.train --edges`.

Both packages start from the same JAX-initialized params (through
`bridge.py`); the JAX rounds are shared through module-scoped fixtures."""
import torch

torch.set_num_threads(2)

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import repro.launch.train as jtrain  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.core import SFPromptTrainer as JSFPromptTrainer  # noqa: E402
from repro.core import SplitConfig as JSplitConfig  # noqa: E402
from repro.core import SplitModel as JSplitModel  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import comm as jcomm  # noqa: E402
from repro.data import DATASETS, synthetic_image_dataset  # noqa: E402
from repro.fed import EdgeTopology as JEdgeTopology  # noqa: E402
from repro.fed import HierarchicalAggregator as JHierarchical  # noqa: E402
from repro_torch.bridge import jax_to_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ProtocolConfig, SFPromptTrainer,  # noqa: E402
                              SplitConfig, SplitModel)
from repro_torch.core import aggregation, comm  # noqa: E402
from repro_torch.fed import (ClientSampler, EdgeTopology,  # noqa: E402
                             FederatedEngine, HierarchicalAggregator,
                             Population, RoundScheduler, StragglerConfig)
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.privacy.fixed_point import roundtrip_tol  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

K, N_EDGES, N_LOCAL, BATCH = 4, 2, 4, 4
SPLIT = dict(head_cycles=1, tail_cycles=1, prompt_len=2, prune_gamma=0.5,
             local_epochs=1)
TOL = dict(atol=1e-5, rtol=1e-5)
KEY = jax.random.PRNGKey(0)


def _cfg(get):
    return get("vit-base").reduced(n_layers=3, d_model=32, d_ff=48)


def port_trainer(aggregator=None, k=K):
    model = SplitModel(_cfg(get_config), SplitConfig(**SPLIT))
    return SFPromptTrainer(model, ProtocolConfig(
        clients_per_round=k, local_epochs=1, batch_size=BATCH,
        momentum=0.0), aggregator, device="cpu")


def jax_trainer(aggregator=None, k=K):
    model = JSplitModel(_cfg(jget_config), JSplitConfig(**SPLIT))
    return JSFPromptTrainer(model, JProtocolConfig(
        clients_per_round=k, local_epochs=1, batch_size=BATCH,
        momentum=0.0), aggregator)


@pytest.fixture(scope="module")
def cohort():
    data = synthetic_image_dataset(DATASETS["cifar10-syn"], K * N_LOCAL,
                                   seed=0, image_hw=32)
    return {name: v.reshape((K, N_LOCAL) + v.shape[1:])
            for name, v in data.items()}


@pytest.fixture(scope="module")
def jparams():
    return jax_trainer().init(KEY)["params"]


def participation(*, n_dropped, n_late=0):
    """tests/test_mesh_round.py's plan: the first clients drop, the next
    are late at 0.4 of their traffic."""
    transmit = np.ones(K, np.float32)
    aggregate = np.ones(K, np.float32)
    aggregate[:n_dropped] = 0.0
    transmit[:n_dropped] = 0.0
    transmit[n_dropped:n_dropped + n_late] = 0.4
    return {"transmit": transmit, "aggregate": aggregate}


def random_cohort_tree(k, seed=0):
    rng = np.random.default_rng(seed)
    return {"tail": {"w": rng.standard_normal((k, 7, 3)).astype(np.float32),
                     "b": rng.standard_normal((k, 5)).astype(np.float32)},
            "prompt": rng.standard_normal((k, 4, 8)).astype(np.float32)}


def _assert_tree_close(t_tree, j_tree, **tol):
    jflat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, j_tree))[0]
    tflat = tree_flatten(t_tree)
    assert [tuple(p.key for p in path) for path, _ in jflat] == \
        [path for path, _ in tflat]
    for (path, leaf), (_, tleaf) in zip(jflat, tflat):
        np.testing.assert_allclose(np.asarray(tleaf), leaf,
                                   err_msg=jax.tree_util.keystr(path), **tol)


def trainable_nbytes(params):
    return float(sum(x.numel() * x.element_size() for _, x in tree_flatten(
        {"tail": params["tail"], "prompt": params["prompt"]})))


# --------------------------------------------------------------- topology
@pytest.mark.parametrize("k,e", [(0, 1), (4, 0), (4, 8), (10, 4)])
def test_edge_topology_refusals_equal_jax(k, e):
    with pytest.raises(ValueError) as te:
        EdgeTopology(k, e)
    with pytest.raises(ValueError) as je:
        JEdgeTopology(k, e)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("k,e", [(8, 2), (6, 3), (5, 5), (4, 1)])
def test_edge_topology_layout_equal_jax(k, e):
    t, j = EdgeTopology(k, e), JEdgeTopology(k, e)
    np.testing.assert_array_equal(t.assignment, j.assignment)
    assert t.assignment.dtype == j.assignment.dtype
    assert t.edge_size == j.edge_size and t.describe() == j.describe()
    assert [t.members(i) for i in range(e)] == \
        [j.members(i) for i in range(e)]


# ------------------------------------------------------ two-tier FedAvg
@pytest.mark.parametrize("weights", [
    [3.0, 2.0, 7.0, 1.0, 5.0, 4.0],       # full participation
    [3.0, 0.0, 7.0, 1.0, 0.0, 4.0],       # dropouts across edges
    [0.0, 0.0, 7.0, 1.0, 5.0, 4.0],       # edge 0 entirely dropped
])
def test_hierarchical_fedavg_matches_jax_and_flat(weights):
    k = len(weights)
    tree = random_cohort_tree(k)
    fb = {key: (np.ones_like(v[0]) if not isinstance(v, dict) else
                {kk: np.ones_like(vv[0]) for kk, vv in v.items()})
          for key, v in tree.items()}
    w = np.asarray(weights, np.float32)
    assign = EdgeTopology(k, 3).assignment
    got = aggregation.hierarchical_fedavg(
        jax_to_torch(tree, "cpu"), torch.from_numpy(w),
        jax_to_torch(fb, "cpu"), assign, 3)
    want = jagg.hierarchical_fedavg(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(w),
        jax.tree.map(jnp.asarray, fb), jnp.asarray(assign), 3)
    _assert_tree_close(got, want, atol=1e-6, rtol=0)
    flat = aggregation.fedavg_partial(jax_to_torch(tree, "cpu"),
                                      torch.from_numpy(w),
                                      jax_to_torch(fb, "cpu"))
    for (_, a), (_, b) in zip(tree_flatten(got), tree_flatten(flat)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_hierarchical_fedavg_all_dropped_falls_back_as_jax():
    tree = random_cohort_tree(4, seed=1)
    fb = {"tail": {"w": np.full((7, 3), 3.25, np.float32),
                   "b": np.full((5,), 3.25, np.float32)},
          "prompt": np.full((4, 8), 3.25, np.float32)}
    assign = EdgeTopology(4, 2).assignment
    got = aggregation.hierarchical_fedavg(
        jax_to_torch(tree, "cpu"), torch.zeros(4), jax_to_torch(fb, "cpu"),
        assign, 2)
    want = jagg.hierarchical_fedavg(
        jax.tree.map(jnp.asarray, tree), jnp.zeros((4,)),
        jax.tree.map(jnp.asarray, fb), jnp.asarray(assign), 2)
    _assert_tree_close(got, want, atol=0, rtol=0)
    _assert_tree_close(got, fb, atol=0, rtol=0)


def test_hierarchical_aggregator_refusals_equal_jax():
    agg, jag = (HierarchicalAggregator(EdgeTopology(4, 2)),
                JHierarchical(JEdgeTopology(4, 2)))
    tree = random_cohort_tree(6)
    fb = jax.tree.map(lambda x: x[0], tree)
    with pytest.raises(ValueError, match="topology") as te:
        agg.aggregate(jax_to_torch(tree, "cpu"), torch.ones(6),
                      jax_to_torch(fb, "cpu"), 0)
    with pytest.raises(ValueError) as je:
        jag.aggregate(jax.tree.map(jnp.asarray, tree), jnp.ones((6,)),
                      jax.tree.map(jnp.asarray, fb), 0)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="no options") as te:
        HierarchicalAggregator(EdgeTopology(4, 2), frac_bits=12)
    with pytest.raises(ValueError) as je:
        JHierarchical(JEdgeTopology(4, 2), frac_bits=12)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="no options"):
        aggregation.get_aggregator(n_edges=2, cohort_size=4, seed=1)
    with pytest.raises(ValueError, match="not divisible"):
        aggregation.get_aggregator(n_edges=3, cohort_size=4)
    for secure, kw in ((False, {}), (True, {"seed": 5}),
                       (True, {"seed": 5, "frac_bits": 12})):
        t = aggregation.get_aggregator(secure=secure, n_edges=2,
                                       cohort_size=4, **kw)
        j = jagg.get_aggregator(secure=secure, n_edges=2, cohort_size=4,
                                **kw)
        assert t.name == j.name == "hierarchical"
        assert t.describe() == j.describe()
        if secure:
            assert [a.seed for a in t.edge_aggs] == [5, 6]


# -------------------------------------------------------------- rounds
def _round(trainer, params, cohort, part):
    return trainer.round({"params": jax_to_torch(params, "cpu"),
                          "round": 0}, cohort, dict(part))


def _jround(trainer, params, cohort, part):
    return trainer.round({"params": params, "round": jnp.int32(0)},
                         {k: jnp.asarray(v) for k, v in cohort.items()},
                         {k: jnp.asarray(v) for k, v in part.items()})


@pytest.fixture(scope="module")
def clear_rounds(cohort, jparams):
    """The flat and the hierarchical clear round of the port, and JAX's
    hierarchical one, with one client of edge 0 dropped."""
    part = participation(n_dropped=1)
    flat = port_trainer()
    st_f, m_f = _round(flat, jparams, cohort, part)
    hier = port_trainer(aggregation.get_aggregator(n_edges=N_EDGES,
                                                   cohort_size=K))
    st_h, m_h = _round(hier, jparams, cohort, part)
    jhier = jax_trainer(jagg.get_aggregator(n_edges=N_EDGES, cohort_size=K))
    jst, jm = _jround(jhier, jparams, cohort, part)
    return dict(st_f=st_f, m_f=m_f, st_h=st_h, m_h=m_h, hier=hier,
                jst=jst, jm=jm, jhier=jhier)


def test_clear_hierarchical_round_matches_flat_and_jax(clear_rounds):
    r = clear_rounds
    for (_, a), (_, b) in zip(tree_flatten(r["st_f"]["params"]),
                              tree_flatten(r["st_h"]["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-6,
                                   atol=1e-7)
    m_f, m_h = r["m_f"], r["m_h"]
    assert m_f["wire/head_body_bytes"] == m_h["wire/head_body_bytes"]
    # the clear edges keep the seed-exact (K + survivors) * param_bytes
    assert m_f["wire/params_bytes"] == m_h["wire/params_bytes"]
    assert "wire/edge_global_bytes" not in m_f
    assert "wire/secure_bytes" not in m_h
    pb = trainable_nbytes(r["st_h"]["params"])
    expect = comm.hierarchical_edge_breakdown(param_nbytes=pb,
                                              n_edges=N_EDGES,
                                              live_edges=2.0)
    assert m_h["wire/edge_global_bytes"] == expect["edge_global"]
    assert r["hier"].meter.totals["edge_global"] == expect["edge_global"]
    jm = r["jm"]
    assert set(m_h) == set(jm)
    for key in jm:
        if key.startswith(("wire/", "cohort/")) or key == "kept_frac":
            assert m_h[key] == float(jm[key]), key
    assert r["hier"].meter.state_dict() == r["jhier"].meter.state_dict()
    _assert_tree_close(r["st_h"]["params"], r["jst"]["params"], **TOL)


def test_secure_hierarchical_round_matches_clear_and_jax(cohort, jparams,
                                                         clear_rounds):
    """Per-edge masked aggregation under a straggler plan (one drop, one
    late): within roundtrip_tol(K) of the clear hierarchical round; the
    params, secure and edge_global bytes equal JAX's bit for bit and lie
    within 5% of `hierarchical_secure_agg_breakdown`. On the CPU the
    masked encode runs its plain version."""
    part = participation(n_dropped=1, n_late=1)
    clear = port_trainer(aggregation.get_aggregator(n_edges=N_EDGES,
                                                    cohort_size=K))
    st_c, _ = _round(clear, jparams, cohort, part)
    sec = port_trainer(aggregation.get_aggregator(
        secure=True, n_edges=N_EDGES, cohort_size=K, seed=3))
    before = launch_counts()
    st_s, m_s = _round(sec, jparams, cohort, part)
    assert launch_counts() == before
    tol = roundtrip_tol(K)
    for (_, a), (_, b) in zip(tree_flatten(st_c["params"]),
                              tree_flatten(st_s["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=tol, rtol=0)

    jsec = jax_trainer(jagg.get_aggregator(
        secure=True, n_edges=N_EDGES, cohort_size=K, impl="ref", seed=3))
    jst, jm = _jround(jsec, jparams, cohort, part)
    for name in ("params", "secure", "edge_global"):
        assert m_s[f"wire/{name}_bytes"] == float(jm[f"wire/{name}_bytes"])
        assert sec.meter.totals[name] == jsec.meter.totals[name]
    _assert_tree_close(st_s["params"], jst["params"], rtol=0,
                       atol=1e-5 + 2.0 ** -16)

    params = st_s["params"]
    n_tr = sum(x.numel() for _, x in tree_flatten(
        {"tail": params["tail"], "prompt": params["prompt"]}))
    # edge 0 lost client 0, both edges live: uploads (1, 2) of sizes (2, 2)
    bd = comm.hierarchical_secure_agg_breakdown(
        n_trainable=n_tr, param_nbytes=trainable_nbytes(params),
        edge_sizes=[2, 2], edge_uploads=[1.0, 2.0])
    for name in ("params", "secure", "edge_global"):
        got = sec.meter.totals[name]
        assert abs(got - bd[name]) <= 0.05 * bd[name], (name, got, bd[name])


# ------------------------------------------------------------------ resume
def test_hierarchical_engine_resume_byte_identical(tmp_path):
    """Kill-and-restart with a hierarchical aggregator: params, meter
    totals (edge_global included) and cohorts equal the uninterrupted
    run's, and a changed topology refuses the checkpoint."""
    n_clients = 40
    data = synthetic_image_dataset(DATASETS["cifar10-syn"],
                                   n_clients * N_LOCAL, seed=0, image_hw=32)

    def build(n_edges=N_EDGES):
        pop = Population.from_partition(data, n_clients, scheme="dirichlet",
                                        alpha=0.1, seed=0)
        tr = port_trainer(aggregation.get_aggregator(n_edges=n_edges,
                                                     cohort_size=K))
        sampler = ClientSampler(pop.n_clients, K, kind="uniform", seed=7)
        sched = RoundScheduler(StragglerConfig(dropout_rate=0.25), seed=7)
        eng = FederatedEngine(tr, pop, sampler, sched)
        eng.init(torch.Generator().manual_seed(0))
        return eng

    ref = build()
    for _ in range(2):
        ref.run_round()
    eng = build()
    eng.run_round()
    ckpt = str(tmp_path / "ckpt")
    eng.save(ckpt)
    with pytest.raises(ValueError, match="trainer mismatch"):
        build(n_edges=4).restore(ckpt)
    res = build()
    assert res.restore(ckpt)
    res.run_round()
    for (_, a), (_, b) in zip(tree_flatten(ref.params),
                              tree_flatten(res.params)):
        assert torch.equal(a, b)
    assert ref.trainer.meter.as_dict() == res.trainer.meter.as_dict()
    assert ref.trainer.meter.totals["edge_global"] > 0


# ------------------------------------------------------------- cost model
def test_edge_and_async_comm_functions_equal_jax():
    for pb, e, live in ((4096.0, 2, 2.0), (28686336.0, 4, 3.0),
                        (100.0, 1, 0.0)):
        kw = dict(param_nbytes=pb, n_edges=e, live_edges=live)
        assert comm.hierarchical_edge_breakdown(**kw) == \
            jcomm.hierarchical_edge_breakdown(**kw)
    for sizes, ups in (([2, 2], [1.0, 2.0]), ([4, 4, 4], [4.0, 0.0, 3.0]),
                       ([1], [1.0])):
        kw = dict(n_trainable=7171584, param_nbytes=28686336.0,
                  edge_sizes=sizes, edge_uploads=ups)
        assert comm.hierarchical_secure_agg_breakdown(**kw) == \
            jcomm.hierarchical_secure_agg_breakdown(**kw)
    for args in ((1.5, 3.0, 0.8, 0.4, 0.15), (0.01, 20.0, 0.0, 0.3, 0.0),
                 (7.0, 0.5, 1.2, 0.1, 0.5)):
        assert comm._lognormal_moments(*args) == \
            jcomm._lognormal_moments(*args)
    for n in (0, 1, 2, 8, 100):
        for mu, sigma in ((0.3, 0.9), (-1.0, 0.1)):
            assert comm._expected_max_lognormal(n, mu, sigma) == \
                jcomm._expected_max_lognormal(n, mu, sigma)
    for kw in (dict(t_comm=1.5, t_comp=3.0, K=8, buffer_size=4,
                    concurrency=2),
               dict(t_comm=0.2, t_comp=9.0, K=16, buffer_size=8,
                    concurrency=3, group_size=4, link_sigma=1.1,
                    speed_sigma=0.2, jitter_sigma=0.3),
               dict(t_comm=4.0, t_comp=1.0, K=1, buffer_size=1,
                    concurrency=1)):
        assert comm.async_vs_sync_round_time(**kw) == \
            jcomm.async_vs_sync_round_time(**kw)


# ---------------------------------------------------------------- launcher
FLAGS = ["--reduced", "--layers", "3", "--dataset", "cifar10-syn",
         "--clients", "8", "--k", "4", "--edges", "2", "--samples", "96",
         "--image-hw", "32", "--batch-size", "8", "--local-epochs", "1",
         "--prompt-len", "4", "--rounds", "2", "--dropout-rate", "0.3",
         "--seed", "0"]
LOG = "vit-base_sfprompt_cifar10-syn.jsonl"


@pytest.mark.parametrize("secure", [False, True])
def test_edges_launcher_matches_jax_launcher_bytes(secure, tmp_path,
                                                   monkeypatch):
    """`launch.train --edges 2` on the CPU, clear and secure: each round's
    cohort, plan and metered bytes (edge_global, secure) equal the JAX
    launcher's."""
    flags = FLAGS + (["--secure-agg"] if secure else [])
    out = str(tmp_path / "port")
    engine = ttrain.main(flags + ["--out", out, "--device", "cpu"])
    agg = engine.trainer.aggregator
    assert agg.name == "hierarchical" and agg.secure == secure
    jout = str(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["train"] + flags + ["--out", jout])
    jtrain.main()
    recs = []
    for d in (out, jout):
        with open(os.path.join(d, LOG)) as f:
            recs.append([json.loads(line) for line in f])
    port, ref = recs
    assert len(port) == len(ref) == 2
    assert any(0 < r["cohort/active"] < 4 for r in port)   # a dropout
    for p, j in zip(port, ref):
        assert set(p) == set(j)
        assert p["wire/edge_global_bytes"] > 0
        assert ("wire/secure_bytes" in p) == secure
        for key in p:
            if key.startswith(("wire/", "cohort", "round")) \
                    or key == "kept_frac":
                assert p[key] == j[key], key
