"""The port's FL, SFL+FF and SFL+Linear baselines against the JAX package's,
on the CPU, at the reduced ViT of tests/test_protocol.py (3 layers, d_model
64, d_ff 128, 32x32 images): one round on bridged JAX params and the same
numpy client data, K 2 and 3, on the fp32 and the int8 wire (params and
`train_loss` within 1e-5); which subtrees each method trains; the
launcher's `--method fl|sfl-ff|sfl-linear` runs and its refusals of
sfprompt-only flags; a baseline engine's checkpoint and resume; and the
cost model's comparison functions `==` JAX's (the Table-1 orderings and
the model binding of tests/test_properties.py and tests/test_system.py).

The int8 wire rounds to nearest in both packages. It is exact only while
their fp32 differences upstream of a boundary (~1e-7 relative) push no
element across a quantizer rounding boundary (ROADMAP Queue 3): at some
init draws one value flips and the params move by up to 1.2e-4. The int8
cases run at init seeds (`INT8_SEED`) whose round flips none."""
import torch

torch.set_num_threads(2)

import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from test_torch_train import _assert_tree_close  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import BaselineConfig as JBaselineConfig  # noqa: E402
from repro.core import FLTrainer as JFLTrainer  # noqa: E402
from repro.core import SFLTrainer as JSFLTrainer  # noqa: E402
from repro.core import SplitConfig as JSplitConfig  # noqa: E402
from repro.core import SplitModel as JSplitModel  # noqa: E402
from repro.core import comm as jcomm  # noqa: E402
from repro.data import (DATASETS, iid_partition,  # noqa: E402
                        select_clients, stack_clients,
                        synthetic_image_dataset)
from repro.runtime import WireSpec as JWireSpec  # noqa: E402
from repro_torch.bridge import jax_to_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (BaselineConfig, FLTrainer,  # noqa: E402
                              SFLTrainer, SplitConfig, SplitModel)
from repro_torch.core import comm  # noqa: E402
from repro_torch.core.baselines import cohort_mean  # noqa: E402
from repro_torch.core.protocol import xla_sum  # noqa: E402
from repro_torch.fed import (ClientSampler, FederatedEngine,  # noqa: E402
                             Population)
from repro_torch.fed.engine import trainer_fingerprint  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.runtime import WireSpec  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
N_LOCAL = 24
SPLIT = dict(head_cycles=1, tail_cycles=1, prompt_len=4, prune_gamma=0.5,
             local_epochs=1)
BCFG = dict(local_epochs=1, batch_size=8, lr=0.05)
METHODS = ("fl", "sfl-ff", "sfl-linear")
# init seeds of the int8 rounds that flip no quantizer rounding boundary
# (seed 0 flips one value in FL at K 2 and 3; seed 2 flips one in SFL+FF
# at K 3)
INT8_SEED = {("fl", 2): 2, ("fl", 3): 2, ("sfl-ff", 2): 2,
             ("sfl-ff", 3): 5, ("sfl-linear", 2): 2, ("sfl-linear", 3): 2}


def _cfg(get):
    return get("vit-base").reduced(n_layers=3, d_model=64, d_ff=128)


def _trainers(method, wire):
    jm = JSplitModel(_cfg(jget_config), JSplitConfig(**SPLIT),
                     JWireSpec.make(wire))
    tm = SplitModel(_cfg(get_config), SplitConfig(**SPLIT),
                    WireSpec.make(wire))
    if method == "fl":
        return (JFLTrainer(jm, JBaselineConfig(**BCFG)),
                FLTrainer(tm, BaselineConfig(**BCFG), device="cpu"))
    mode = method.split("-")[1]
    return (JSFLTrainer(jm, JBaselineConfig(**BCFG), mode=mode),
            SFLTrainer(tm, BaselineConfig(**BCFG), mode=mode, device="cpu"))


@pytest.fixture(scope="module")
def clients():
    d = synthetic_image_dataset(DATASETS["cifar10-syn"], 8 * N_LOCAL,
                                seed=0, image_hw=32)
    return iid_partition(d, 8, seed=0)


_ROUNDS = {}


def _round(clients, method, wire, K):
    """One JAX round and one port round from the same params and data,
    run once per (method, wire, K) for the tests of this module."""
    key = (method, wire, K)
    if key not in _ROUNDS:
        cohort = stack_clients(clients, select_clients(8, K, seed=0,
                                                       round_idx=0))
        jtr, ttr = _trainers(method, wire)
        seed = INT8_SEED[(method, K)] if wire == "int8" else 0
        jstate = jtr.init(jax.random.PRNGKey(seed))
        jnew, jm = jtr.round(jstate, {k: jnp.asarray(v)
                                      for k, v in cohort.items()})
        before = launch_counts()
        tnew, tm = ttr.round({"params": jax_to_torch(jstate["params"],
                                                     "cpu"), "round": 0},
                             cohort)
        assert launch_counts() == before      # no kernel on CPU tensors
        _ROUNDS[key] = dict(jstate=jstate, jnew=jnew, jm=jm, tnew=tnew,
                            tm=tm)
    return _ROUNDS[key]


# ----------------------------------------------------------- the rounds
@pytest.mark.parametrize("K", [2, 3])
@pytest.mark.parametrize("wire", ["fp32", "int8"])
@pytest.mark.parametrize("method", METHODS)
def test_baseline_round_matches_jax(clients, method, wire, K):
    r = _round(clients, method, wire, K)
    assert set(r["tm"]) == set(r["jm"]) == {"train_loss"}
    np.testing.assert_allclose(r["tm"]["train_loss"],
                               r["jm"]["train_loss"], **TOL)
    assert r["tnew"]["round"] == int(r["jnew"]["round"]) == 1
    _assert_tree_close(r["tnew"]["params"], r["jnew"]["params"], **TOL)


def _changed(new, old):
    return [not np.array_equal(a.numpy(), np.asarray(b)) for (_, a), (_, b)
            in zip(tree_flatten(new), tree_flatten(jax.tree.map(
                np.asarray, old)))]


@pytest.mark.parametrize("method", METHODS)
def test_baseline_trains_its_subtrees(clients, method):
    """FL trains every segment, SFL+FF head, body and tail, SFL+Linear only
    the task head; no baseline trains the prompt."""
    r = _round(clients, method, "fp32", 2)
    new, old = r["tnew"]["params"], r["jstate"]["params"]
    changed = {seg: _changed(new[seg], old[seg])
               for seg in ("head", "body", "tail", "prompt")}
    assert not any(changed["prompt"])
    if method == "sfl-linear":
        assert not any(changed["head"]) and not any(changed["body"])
        assert all(_changed(new["tail"]["head"], old["tail"]["head"]))
        rest = {k: v for k, v in new["tail"].items() if k != "head"}
        assert not any(_changed(rest, {k: v for k, v in
                                       old["tail"].items() if k != "head"}))
    else:
        assert any(changed["head"]) and any(changed["body"])
        assert any(changed["tail"])


def test_cohort_mean_follows_xla_order():
    """The SFL server step's mean gradient: `jnp.mean(axis=0)` of K client
    gradients, summed in order up to 32 clients and in XLA's tree of
    windows of 32 above (`core/protocol.py::xla_sum`), then times the
    f32 reciprocal of K."""
    rng = np.random.default_rng(11)
    for K in (1, 2, 3, 32, 33, 70):
        x = (rng.standard_normal((K, 5)) * 10.0 ** rng.integers(
            -3, 4, (K, 5))).astype(np.float32)
        got = cohort_mean([torch.from_numpy(r) for r in x]).numpy()
        want = np.asarray(jax.jit(lambda a: jnp.mean(a, axis=0))(
            jnp.asarray(x)))
        np.testing.assert_array_equal(got, want)
        if K > 32:
            np.testing.assert_array_equal(
                got[0], xla_sum(list(x[:, 0]), np.float32(0.0))
                * np.float32(1 / K))


def test_baseline_trainers_ask_for_cuda_and_check_mode():
    tm = SplitModel(_cfg(get_config), SplitConfig(**SPLIT))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            FLTrainer(tm, BaselineConfig())
        with pytest.raises(RuntimeError, match="CUDA"):
            SFLTrainer(tm, BaselineConfig())
    with pytest.raises(ValueError, match="'ff' or 'linear'"):
        SFLTrainer(tm, BaselineConfig(), mode="lora", device="cpu")
    assert not getattr(FLTrainer(tm, BaselineConfig(), device="cpu"),
                       "supports_partial", False)


# ------------------------------------------------------- engine, resume
def _engine(data, lr=0.05):
    tm = SplitModel(_cfg(get_config), SplitConfig(**SPLIT),
                    WireSpec.make("int8"))
    tr = SFLTrainer(tm, BaselineConfig(**dict(BCFG, lr=lr)), device="cpu")
    pop = Population.from_partition(data, 6, scheme="iid", seed=0)
    return FederatedEngine(tr, pop, ClientSampler(6, 2, seed=3))


def test_baseline_engine_checkpoint_and_resume(tmp_path):
    """The engine runs a baseline synchronously (no participation dict);
    a resume after round 1 gives the uninterrupted run's params and
    cohorts, and a resume with another learning rate is refused (the
    fingerprint covers `BaselineConfig`)."""
    data = synthetic_image_dataset(DATASETS["cifar10-syn"], 6 * 16, seed=2,
                                   image_hw=32)
    gen = lambda: torch.Generator().manual_seed(1)  # noqa: E731
    ref = _engine(data)
    ref.init(gen())
    for _ in range(2):
        _, m = ref.run_round()
        assert np.isfinite(m["train_loss"]) and m["cohort/sampled"] == 2
    eng = _engine(data)
    eng.init(gen())
    eng.run_round()
    ckpt = str(tmp_path / "ckpt")
    eng.save(ckpt)
    res = _engine(data)
    assert res.restore(ckpt) and res.round_idx == 1
    res.run_round()
    assert [c.tolist() for c in ref.cohort_history][1] == \
        res.cohort_history[0].tolist()
    for (pa, a), (pb, b) in zip(tree_flatten(ref.params),
                                tree_flatten(res.params)):
        assert pa == pb
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    other = _engine(data, lr=0.01)
    assert int(trainer_fingerprint(other.trainer)) != \
        int(trainer_fingerprint(eng.trainer))
    with pytest.raises(ValueError, match="hyperparameters"):
        other.restore(ckpt)


# ---------------------------------------------------------- the launcher
FLAGS = ["--reduced", "--layers", "3", "--dataset", "cifar10-syn",
         "--clients", "4", "--k", "2", "--samples", "64", "--image-hw", "32",
         "--batch-size", "8", "--local-epochs", "1", "--rounds", "1",
         "--wire", "int8", "--seed", "0", "--device", "cpu"]


@pytest.mark.parametrize("method", METHODS)
def test_launcher_runs_baselines(method, tmp_path, capsys):
    out = str(tmp_path)
    engine = ttrain.main(FLAGS + ["--method", method, "--out", out])
    assert engine.round_idx == 1
    with open(os.path.join(out, f"vit-base_{method}_cifar10-syn.jsonl")) \
            as f:
        recs = [json.loads(line) for line in f]
    assert len(recs) == 1
    assert np.isfinite(recs[0]["train_loss"])
    assert not any(k.startswith(("eval_", "wire/")) for k in recs[0])
    assert os.path.exists(os.path.join(out, "final.npz"))
    assert "saved" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [
    ["--personalize-tails"], ["--dropout-rate", "0.3"], ["--straggle"],
    ["--secure-agg"], ["--dp-epsilon", "8"], ["--edges", "2"],
    ["--mesh-devices", "4"], ["--fsdp"], ["--async-buffer", "4"],
])
def test_launcher_refuses_sfprompt_flags_for_baselines(extra, capsys,
                                                        tmp_path):
    for method in METHODS:
        with pytest.raises(SystemExit) as exc:
            ttrain.main(FLAGS + ["--method", method, "--out",
                                 str(tmp_path)] + extra)
        assert exc.value.code == 2
        assert "sfprompt method" in capsys.readouterr().err


# ------------------------------------------------------------ cost model
COMPARISONS = ("fl_compute", "sfl_compute", "sfprompt_compute_paper",
               "fl_latency", "sfl_latency", "sfprompt_latency", "summarize")


@given(W=st.floats(1e3, 1e12), alpha=st.floats(0.0, 0.3),
       tau=st.floats(0.1, 0.69), q=st.floats(1.0, 1e7),
       D=st.integers(1, 10_000), U=st.integers(1, 20), E=st.integers(1, 4),
       K=st.integers(1, 64), p=st.floats(0.0, 1e5),
       gamma_keep=st.floats(0.01, 1.0), R=st.floats(1e3, 1e10),
       P_C=st.floats(1e9, 1e14), P_S=st.floats(1e11, 1e16),
       bytes_smashed=st.sampled_from([1.0, 1.25, 2.0, 4.0]))
@settings(max_examples=60, deadline=None)
def test_cost_comparisons_equal_jax(**kw):
    t = comm.CostInputs(**kw)
    j = jcomm.CostInputs(**kw)
    for fn in COMPARISONS:
        assert getattr(comm, fn)(t) == getattr(jcomm, fn)(j), fn


def test_cost_model_binds_to_models():
    """tests/test_system.py's check against the port: at ViT-Base, SFPrompt
    moves fewer bytes than SFL and computes under 1% of FL on the client."""
    split = SplitConfig(head_cycles=1, tail_cycles=1, prompt_len=16,
                        prune_gamma=0.8)
    ci = comm.cost_inputs_from(get_config("vit-base"), split,
                               tokens_per_sample=197, D=1000, K=5, U=10)
    s = comm.summarize(ci)
    assert s["SFPrompt"]["comm_bytes"] < s["SFL"]["comm_bytes"]
    assert s["SFPrompt"]["client_flops"] < s["FL"]["client_flops"] * 0.01
    jci = jcomm.cost_inputs_from(
        jget_config("vit-base"),
        JSplitConfig(head_cycles=1, tail_cycles=1, prompt_len=16,
                     prune_gamma=0.8),
        tokens_per_sample=197, D=1000, K=5, U=10)
    assert dataclasses.asdict(ci) == dataclasses.asdict(jci)
    assert s == jcomm.summarize(jci)


@given(W=st.floats(1e6, 1e12), D=st.integers(10, 10_000),
       U=st.integers(1, 20), gamma_keep=st.floats(0.05, 1.0),
       q=st.floats(1e3, 1e7))
@settings(max_examples=25, deadline=None)
def test_cost_model_orderings(W, D, U, gamma_keep, q):
    """tests/test_properties.py's Table-1 claims against the port: SFPrompt
    comm < SFL comm; pruning more never raises SFPrompt comm; the split
    methods' client compute is below FL's."""
    c = comm.CostInputs(W=W, alpha=0.1, tau=0.8, q=q, D=D, U=U,
                        gamma_keep=gamma_keep)
    assert comm.sfprompt_comm(c) < comm.sfl_comm(c)
    c_less = comm.CostInputs(W=W, alpha=0.1, tau=0.8, q=q, D=D, U=U,
                             gamma_keep=gamma_keep * 0.5)
    assert comm.sfprompt_comm(c_less) <= comm.sfprompt_comm(c) + 1e-6
    assert comm.sfprompt_compute_paper(c) < comm.fl_compute(c)
    assert comm.sfl_compute(c) < comm.fl_compute(c)
