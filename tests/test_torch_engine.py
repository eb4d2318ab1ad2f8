"""The port's synchronous federated runtime against the JAX package's, on
the CPU: the engine over a dropout scheduler with secure aggregation and
DP-SGD (cohorts, plans, bytes, epsilon and params), byte-identical resume,
npz checkpoints readable by both packages, the fingerprint check that
refuses a JAX engine checkpoint, the population's state, and the
`repro_torch.launch.train` launcher (JSONL records against the JAX
launcher's, resume, the slice-H flags' refusals, the async and edge flags
and JAX's refusals of their mixes, and the trace flags: the exports and
tools/trace_check.py, metrics snapshots, the step level's phase spans)."""
import torch

torch.set_num_threads(2)

import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import repro.launch.train as jtrain  # noqa: E402
from repro.checkpoint import load_checkpoint as jload  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.core import SFPromptTrainer as JSFPromptTrainer  # noqa: E402
from repro.core import SplitConfig as JSplitConfig  # noqa: E402
from repro.core import SplitModel as JSplitModel  # noqa: E402
from repro.core.aggregation import get_aggregator as jget_aggregator  # noqa: E402
from repro.data import DATASETS, synthetic_image_dataset  # noqa: E402
from repro.fed import ClientSampler as JClientSampler  # noqa: E402
from repro.fed import FederatedEngine as JFederatedEngine  # noqa: E402
from repro.fed import Population as JPopulation  # noqa: E402
from repro.fed import RoundScheduler as JRoundScheduler  # noqa: E402
from repro.fed import StragglerConfig as JStragglerConfig  # noqa: E402
from repro.runtime import WireSpec as JWireSpec  # noqa: E402
from repro_torch.bridge import jax_to_torch  # noqa: E402
from repro_torch.checkpoint import (all_checkpoints,  # noqa: E402
                                    load_checkpoint, save_checkpoint)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ProtocolConfig, SFPromptTrainer,  # noqa: E402
                              SplitConfig, SplitModel)
from repro_torch.core.aggregation import get_aggregator  # noqa: E402
from repro_torch.fed import (AsyncConfig, AsyncRoundEngine,  # noqa: E402
                             ClientSampler, FederatedEngine, Population,
                             RoundScheduler, StragglerConfig)
from repro_torch.fed.engine import trainer_fingerprint  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.privacy.fixed_point import roundtrip_tol  # noqa: E402
from repro_torch.runtime import WireSpec  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

N_CLIENTS, N_LOCAL, BATCH, K = 12, 8, 4, 3
SPLIT = dict(head_cycles=1, tail_cycles=1, prompt_len=2, prune_gamma=0.3,
             local_epochs=1)
PCFG = dict(clients_per_round=K, local_epochs=1, batch_size=BATCH,
            momentum=0.0, dp_clip=1.0, dp_noise_multiplier=0.8)
SEED = 7
KEY = jax.random.PRNGKey(0)


def _cfg(get):
    return get("vit-base").reduced(n_layers=3, d_model=32, d_ff=64)


@pytest.fixture(scope="module")
def data():
    return synthetic_image_dataset(DATASETS["cifar10-syn"],
                                   N_CLIENTS * N_LOCAL, seed=0, image_hw=32)


def jax_wire_noise(round_idx, k):
    """The uniforms the JAX round draws (see tests/test_torch_train.py)."""
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(23),
                                               round_idx), k)

    def noise(client, step, name, shape):
        k_hb, k_bt = jax.random.split(jax.random.fold_in(keys[client], step))
        kf, kb = jax.random.split(k_hb if name == "head_body" else k_bt)
        return tuple(torch.from_numpy(np.array(
            jax.random.uniform(key, shape, jnp.float32))) for key in (kf, kb))
    return noise


def jax_dp_noise(round_idx, k, reference):
    """The unit normals of the JAX round's DP noise: fold_in(PRNGKey(97),
    round) -> split(K) -> split(n_leaves) in `jax.tree` order -> normal."""
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(97),
                                               round_idx), k)
    index = {p: i for i, (p, _) in enumerate(tree_flatten(reference))}

    def noise(client, path, shape):
        leaf_keys = jax.random.split(keys[client], len(index))
        return torch.from_numpy(np.array(jax.random.normal(
            leaf_keys[index[path]], shape, jnp.float32)))
    return noise


def jax_engine(data, *, secure=True, dp=True):
    model = JSplitModel(_cfg(jget_config), JSplitConfig(**SPLIT),
                        JWireSpec.make("fp32"))
    pcfg = dict(PCFG) if dp else dict(PCFG, dp_clip=0.0,
                                      dp_noise_multiplier=0.0)
    agg = jget_aggregator(secure=True, impl="ref", seed=SEED) \
        if secure else None
    tr = JSFPromptTrainer(model, JProtocolConfig(**pcfg), agg)
    pop = JPopulation.from_partition(data, N_CLIENTS, scheme="dirichlet",
                                     alpha=0.1, seed=0)
    return JFederatedEngine(
        tr, pop, JClientSampler(N_CLIENTS, K, seed=SEED),
        JRoundScheduler(JStragglerConfig(dropout_rate=0.3, late_mode="drop"),
                        seed=SEED))


def port_engine(data, *, personalize=False):
    model = SplitModel(_cfg(get_config), SplitConfig(**SPLIT),
                       WireSpec.make("fp32"))
    tr = SFPromptTrainer(model, ProtocolConfig(
        **PCFG, return_client_trainable=personalize),
        get_aggregator(secure=True, seed=SEED), device="cpu")
    pop = Population.from_partition(data, N_CLIENTS, scheme="dirichlet",
                                    alpha=0.1, seed=0)
    return FederatedEngine(
        tr, pop, ClientSampler(N_CLIENTS, K, seed=SEED),
        RoundScheduler(StragglerConfig(dropout_rate=0.3, late_mode="drop"),
                       seed=SEED), personalize_tails=personalize)


def _assert_tree_close(t_tree, j_tree, **tol):
    jflat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, j_tree))[0]
    tflat = tree_flatten(t_tree)
    assert [tuple(p.key for p in path) for path, _ in jflat] == \
        [path for path, _ in tflat]
    for (path, leaf), (_, tleaf) in zip(jflat, tflat):
        np.testing.assert_allclose(np.asarray(tleaf), leaf,
                                   err_msg=jax.tree_util.keystr(path), **tol)


# ------------------------------------------------------------- the engine
def test_engine_two_secure_dp_rounds_match_jax(data):
    jeng = jax_engine(data)
    jeng.init(KEY)
    teng = port_engine(data)
    teng.state = {"params": jax_to_torch(jeng.state["params"], "cpu"),
                  "round": 0}
    drops = 0
    for r in range(2):
        params = teng.params
        reference = {"tail": params["tail"], "prompt": params["prompt"]}
        jplan, jm = jeng.run_round()
        tplan, tm = teng.run_round(wire_noise=jax_wire_noise(r, K),
                                   dp_noise=jax_dp_noise(r, K, reference))
        for field in ("cohort", "transmit", "aggregate", "dropped", "late",
                      "latency_s"):
            np.testing.assert_array_equal(getattr(tplan, field),
                                          getattr(jplan, field))
        assert tplan.deadline_s == jplan.deadline_s
        assert set(tm) == set(jm)
        for key in tm:
            if key.startswith(("wire/", "cohort/", "dp/epsilon")) \
                    or key == "kept_frac":
                assert tm[key] == jm[key], (r, key)
        drops += int(0 < tplan.n_active < K)
        _assert_tree_close(teng.params, jeng.params,
                           atol=roundtrip_tol(K) + 1e-5, rtol=0)
    assert drops >= 1             # the recovery path ran
    assert teng.trainer.meter.as_dict() == jeng.trainer.meter.as_dict()
    assert teng.trainer.accountant.epsilon() == \
        jeng.trainer.accountant.epsilon()
    np.testing.assert_array_equal(teng.population.times_sampled,
                                  jeng.population.times_sampled)
    np.testing.assert_array_equal(teng.population.last_round,
                                  jeng.population.last_round)


@pytest.mark.parametrize("personalize", [False, True])
def test_engine_resume_byte_identical(data, tmp_path, personalize):
    """Kill-and-restart with secure aggregation, DP and dropouts: params,
    metered bytes and the zCDP ledger of the resumed run equal the
    uninterrupted run's."""
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    ref = port_engine(data, personalize=personalize)
    ref.init(gen())
    for _ in range(3):
        ref.run_round()
    eng = port_engine(data, personalize=personalize)
    eng.init(gen())
    for _ in range(2):
        eng.run_round()
    ckpt = str(tmp_path / "ckpt")
    eng.save(ckpt)
    res = port_engine(data, personalize=personalize)
    assert res.restore(ckpt)
    assert res.round_idx == 2 and res.trainer.accountant.releases == 2
    assert res.trainer.accountant.rho == eng.trainer.accountant.rho
    res.run_round()
    for (pa, a), (pb, b) in zip(tree_flatten(ref.params),
                                tree_flatten(res.params)):
        assert pa == pb
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert ref.trainer.meter.as_dict() == res.trainer.meter.as_dict()
    assert ref.trainer.accountant.epsilon() == \
        res.trainer.accountant.epsilon()
    if personalize:
        assert ref.population._tails.keys() == res.population._tails.keys()
        for cid, tail in ref.population._tails.items():
            for (_, a), (_, b) in zip(tree_flatten(tail),
                                      tree_flatten(res.population
                                                   ._tails[cid])):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a resume that changed the DP mechanism is refused
    changed = port_engine(data)
    changed.trainer.accountant.noise_multiplier = 0.5
    with pytest.raises(ValueError, match="mismatch"):
        changed.restore(ckpt)


def test_jax_engine_checkpoint_is_refused(data, tmp_path):
    """`ProtocolConfig.impl` exists only in the JAX package, so the trainer
    fingerprints differ and a JAX engine checkpoint does not resume
    silently in the port."""
    jeng = jax_engine(data)
    jeng.state = jeng.trainer.init(KEY)
    ckpt = str(tmp_path / "ckpt")
    jeng.save(ckpt)
    teng = port_engine(data)
    assert int(trainer_fingerprint(teng.trainer)) != \
        int(jeng._trainer_fingerprint())
    with pytest.raises(ValueError, match="hyperparameters"):
        teng.restore(ckpt)
    assert teng.state is None


def test_checkpoints_load_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"params": {"tail": {"w": rng.standard_normal((3, 4))
                                .astype(np.float32)},
                       "prompt": rng.standard_normal((2, 8))
                       .astype(np.float32)},
            "round": np.int32(5), "scale": np.float64(0.25),
            "ids": np.arange(4, dtype=np.int64), "nothing": None,
            "deep": {"x": {"y": np.bool_(True)}}}

    def check(got, want):
        if isinstance(want, dict):
            assert got.keys() == want.keys()
            for k in want:
                check(got[k], want[k])
        elif want is None:
            assert got is None
        else:
            want = np.asarray(want)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)

    jpath = jsave(str(tmp_path / "j"), tree, step=3, keep_last=2)
    check(load_checkpoint(jpath), tree)
    ttree = dict(tree, params=jax_to_torch(tree["params"], "cpu"))
    for step in range(4):
        tpath = save_checkpoint(str(tmp_path / "t"), ttree, step=step,
                                keep_last=2)
    assert os.path.basename(tpath) == os.path.basename(jpath)
    assert [os.path.basename(p) for p in all_checkpoints(
        str(tmp_path / "t"))] == ["ckpt_00000002.npz", "ckpt_00000003.npz"]
    check(jload(tpath), tree)
    with pytest.raises(ValueError, match="keep_last"):
        save_checkpoint(str(tmp_path / "t"), ttree, keep_last=2)


def test_population_matches_jax(data):
    jpop = JPopulation.from_partition(data, N_CLIENTS, scheme="dirichlet",
                                      alpha=0.1, seed=0)
    tpop = Population.from_partition(data, N_CLIENTS, scheme="dirichlet",
                                     alpha=0.1, seed=0)
    cohort = np.array([4, 0, 9])
    for k, v in jpop.gather(cohort).items():
        np.testing.assert_array_equal(tpop.gather(cohort)[k], v)
    np.testing.assert_array_equal(tpop.cohort_sizes(cohort),
                                  jpop.cohort_sizes(cohort))
    rng = np.random.default_rng(1)
    tails = {"w": rng.standard_normal((3, 2, 5)).astype(np.float32),
             "b": rng.standard_normal((3, 5)).astype(np.float32)}
    for pop in (jpop, tpop):
        pop.set_tails(cohort, tails)
        pop.record_participation(cohort[:2], 3)
    js, ts = jpop.state_dict(), tpop.state_dict()

    def flat(d, prefix=""):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[prefix + k] = np.asarray(v)
        return out
    fj, ft = flat(js), flat(ts)
    assert fj.keys() == ft.keys()
    for k in fj:
        np.testing.assert_array_equal(ft[k], fj[k])
    fresh = Population.from_partition(data, N_CLIENTS, scheme="dirichlet",
                                      alpha=0.1, seed=0)
    fresh.load_state_dict(js)
    fresh.restore_tails({"w": np.zeros((2, 5)), "b": np.zeros(5)})
    for cid in cohort:
        np.testing.assert_array_equal(fresh._tails[int(cid)]["w"],
                                      tails["w"][list(cohort).index(cid)])


# ------------------------------------------------------------ the launcher
FLAGS = ["--reduced", "--layers", "3", "--dataset", "cifar10-syn",
         "--clients", "8", "--k", "3", "--samples", "96", "--image-hw", "32",
         "--batch-size", "8", "--local-epochs", "1", "--prompt-len", "4",
         "--rounds", "2", "--secure-agg", "--dp-epsilon", "8",
         "--dropout-rate", "0.3", "--ckpt-every", "1", "--seed", "0"]
LOG = "vit-base_sfprompt_cifar10-syn.jsonl"


def _records(out):
    with open(os.path.join(out, LOG)) as f:
        return [json.loads(line) for line in f]


def test_launcher_matches_jax_launcher_and_resumes(tmp_path, monkeypatch):
    out = str(tmp_path / "port")
    engine = ttrain.main(FLAGS + ["--out", out, "--device", "cpu"])
    port = _records(out)
    jout = str(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["train"] + FLAGS + ["--out", jout])
    jtrain.main()
    ref = _records(jout)
    assert len(port) == len(ref) == 2
    assert any(0 < r["cohort/active"] < 3 for r in port)   # a dropout
    for p, j in zip(port, ref):
        assert set(p) == set(j)
        for key in p:
            if key.startswith(("wire/", "cohort", "dp/epsilon", "round")) \
                    or key == "kept_frac":
                assert p[key] == j[key], key
    final = load_checkpoint(os.path.join(out, "final.npz"))
    for (_, a), (_, b) in zip(tree_flatten(final),
                              tree_flatten(engine.params)):
        np.testing.assert_array_equal(a, b.numpy())

    # a kill after round 1: drop the newest checkpoint and resume
    killed = str(tmp_path / "killed")
    shutil.copytree(out, killed)
    os.remove(os.path.join(killed, "ckpt", "ckpt_00000002.npz"))
    resumed = ttrain.main(FLAGS + ["--out", killed, "--device", "cpu",
                                   "--resume"])
    assert resumed.round_idx == 2
    for (_, a), (_, b) in zip(tree_flatten(engine.params),
                              tree_flatten(resumed.params)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert resumed.trainer.meter.as_dict() == engine.trainer.meter.as_dict()
    again = _records(killed)
    assert [r["round"] for r in again] == [0, 1]
    for p, q in zip(port, again):
        assert {k: v for k, v in p.items() if k != "wall_s"} == \
            {k: v for k, v in q.items() if k != "wall_s"}


def test_launcher_asks_for_cuda_by_default(tmp_path):
    _, args = ttrain.parse_args(FLAGS + ["--out", str(tmp_path)])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.main(FLAGS + ["--out", str(tmp_path)])


LM_FLAGS = ["--reduced", "--dataset", "lm-syn", "--clients", "2", "--k",
            "2", "--samples", "16", "--seq-len", "16", "--batch-size", "4",
            "--local-epochs", "1", "--rounds", "1", "--prompt-len", "4",
            "--seed", "0", "--device", "cpu"]


@pytest.mark.parametrize("extra,slice_", [
    (["--arch", "phi3.5-moe-42b-a6.6b", "--layers", "3", "--mesh-devices",
      "2", "--mesh-model", "2"], "slice H"),
    (["--arch", "zamba2-2.7b", "--layers", "18", "--mesh-devices", "4",
      "--mesh-model", "2", "--fsdp"], "slice H"),
    (["--arch", "qwen2-vl-72b", "--layers", "3", "--mesh-devices", "2",
      "--mesh-model", "2"], "slice H"),
])
def test_unported_flags_name_their_slice(extra, slice_, capsys, tmp_path):
    """The families slice H part 2 brought to the mesh run from the
    launcher's flags (tests/test_torch_mesh_{moe,scans,encdec}.py hold
    their rounds against JAX): the ranks start, rank 0 writes one round's
    log with finite losses and nothing names a refused slice."""
    out = str(tmp_path / "mesh")
    assert ttrain.main(LM_FLAGS + ["--out", out] + extra) is None
    arch = extra[1]
    with open(os.path.join(out, f"{arch}_sfprompt_lm-syn.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["round"] for r in recs] == [0]
    assert np.isfinite(recs[0]["split_loss"])
    assert slice_ not in capsys.readouterr().err


@pytest.mark.parametrize("extra,message", [
    (["--edges", "2"], "--k 3 must divide evenly into --edges 2"),
    (["--async-buffer", "4", "--personalize-tails"], "mutually exclusive"),
    (["--async-buffer", "4", "--k", "4", "--edges", "2"],
     "the flush cohort is the buffer"),
])
def test_async_and_edge_mixes_refused_as_jax(extra, message, capsys,
                                             tmp_path, monkeypatch):
    """The JAX launcher's refusals of an uneven edge layout and of async
    with personalized tails or edges, with its messages."""
    errors = []
    for run in ("port", "jax"):
        with pytest.raises(SystemExit) as exc:
            if run == "port":
                ttrain.main(FLAGS + ["--out", str(tmp_path), "--device",
                                     "cpu"] + extra)
            else:
                monkeypatch.setattr(sys, "argv", ["train"] + FLAGS + [
                    "--out", str(tmp_path)] + extra)
                jtrain.main()
        assert exc.value.code == 2
        err = capsys.readouterr().err.strip().splitlines()[-1]
        errors.append(err.split("error: ", 1)[1])
    assert errors[0] == errors[1] and message in errors[0]


ONE_ROUND = FLAGS[:FLAGS.index("--rounds")] + [
    "--rounds", "1", "--secure-agg", "--dp-epsilon", "8",
    "--dropout-rate", "0.3",
    "--seed", "0", "--device", "cpu"]


@pytest.mark.parametrize("extra", [
    ["--async-buffer", "3"],
    ["--async-buffer", "3", "--async-concurrency", "1"],
    ["--async-buffer", "3", "--staleness-alpha", "2"],
    ["--async-buffer", "3", "--staleness-beta", "0"],
    ["--edges", "3"],
])
def test_async_and_edge_flags_parse_and_run(extra, tmp_path, capsys):
    """Each async and edge flag now parses into its engine and runs one
    round (a flush under --async-buffer) of the private launcher."""
    engine = ttrain.main(ONE_ROUND + ["--out", str(tmp_path)] + extra)
    out = capsys.readouterr().out
    rec = _records(str(tmp_path))
    assert len(rec) == 1 and np.isfinite(rec[0]["eval_ce"])
    if "--edges" in extra:
        assert isinstance(engine, FederatedEngine)
        agg = engine.trainer.aggregator
        assert agg.describe() == "hier(edges=3x1; edge=secure(" \
            "frac_bits=16, seed=0))"
        assert rec[0]["wire/edge_global_bytes"] > 0
        return
    _, args = ttrain.parse_args(ONE_ROUND + ["--out", str(tmp_path)]
                                + extra)
    assert isinstance(engine, AsyncRoundEngine) and engine.version == 1
    assert engine.acfg == AsyncConfig(
        buffer_size=3, concurrency=args.async_concurrency,
        staleness_alpha=args.staleness_alpha,
        staleness_beta=args.staleness_beta)
    # the trainer stays clear; the flush is the secure cohort
    assert engine.trainer.aggregator.name == "clear"
    assert engine.aggregator.describe() == "secure(frac_bits=16, seed=0)"
    assert engine.trainer.pcfg.return_client_trainable
    assert rec[0]["flushes"] == 1.0 and "t_sim" in rec[0]
    assert f"async: 1 flush(es) over {engine.t_sim:.1f} simulated s" in out


# the launcher's trace flags (slice F): two rounds, no privacy, so the runs
# stay short
TRACE_FLAGS = FLAGS[:FLAGS.index("--rounds")] + [
    "--rounds", "2", "--seed", "0", "--device", "cpu"]
PHASES = ["phase1a", "phase1b", "phase2", "phase3"]


def _trace_check():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "trace_check", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools", "trace_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_out_writes_the_three_exports_and_passes_trace_check(
        tmp_path, capsys):
    """--trace-out alone raises the level to `round`: round spans and the
    meter's byte events, no per-phase spans; JSONL, Chrome trace and the
    registry's Prometheus text are written and trace_check accepts the
    JSONL."""
    base = str(tmp_path / "run")
    engine = ttrain.main(TRACE_FLAGS + ["--out", str(tmp_path / "o"),
                                        "--trace-out", base])
    out = capsys.readouterr().out
    for ext in ("jsonl", "trace.json", "prom"):
        assert os.path.exists(f"{base}.{ext}") and f"{base}.{ext}" in out
    with open(f"{base}.jsonl") as f:
        recs = [json.loads(line) for line in f]
    with open(f"{base}.jsonl") as f:
        assert _trace_check().check(f) == 0
    assert [r["name"] for r in recs] == ["meter.absorb", "round"] * 2 + [
        "meter.final"]
    meter = engine.trainer.meter
    assert recs[-1]["attrs"]["params"] == meter.totals["params"]
    prom = open(f"{base}.prom").read()
    assert f"meter_totals_head_body {meter.totals['head_body']}" in prom


def test_metrics_every_prints_one_snapshot_a_round(tmp_path, capsys):
    ttrain.main(TRACE_FLAGS + ["--out", str(tmp_path), "--metrics-every",
                               "1"])
    snaps = [json.loads(line)["metrics"]
             for line in capsys.readouterr().out.splitlines()
             if line.startswith('{"metrics"')]
    # one a round, and no final one: the tracer is off
    assert [s["meter/rounds"] for s in snaps] == [1.0, 2.0]
    assert snaps[1]["meter/totals/head_body"] == \
        2 * snaps[0]["meter/totals/head_body"]


def test_trace_level_step_alone_emits_the_phase_spans(tmp_path, capsys):
    """--trace-level step without --trace-out: the dispatch event and the
    per-phase spans inside each round, and the registry's snapshot printed
    at the end."""
    engine = ttrain.main(TRACE_FLAGS + ["--out", str(tmp_path),
                                        "--trace-level", "step"])
    names = [r["name"] for r in engine.trainer.tracer.records()]
    assert names == (["round.dispatch"] + PHASES
                     + ["meter.absorb", "round"]) * 2
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["metrics"]["meter/rounds"] == 2.0
