"""The two MoE families through the port's serving engine, training rounds
and launchers against the JAX package's, on bridged weights: reduced
phi3.5-moe and deepseek-v3 (tests/test_torch_moe.py's `family_cfg`: 3
MoE layers, deepseek-v3 also its dense prefix layer with MLA throughout
and the MTP head in the tail; d_model 64, vocab 128, top-2 of 4).

* the dense `ServeEngine` (int8 wire; 3 requests on 2 slots, a queued
  request joining a retired slot; tails jittered by 0.2 a tenant):
  tokens and wire bytes `==`, logits within 1e-5;
* one SFPrompt round on token data (int8 wire, JAX's noise; K 2 of 8
  sequences of 16, as tests/test_torch_lm_round.py) and its `evaluate`:
  wire bytes, kept sets and kept_frac `==`, params and losses within 1e-5;
* one FL round on the same data (every segment trained, expert weights
  included): params and loss within 1e-5;
* `repro_torch.launch.serve --arch` on JAX-initialised params and
  `repro_torch.launch.train --arch ... --dataset lm-syn --method
  sfprompt|fl` (phi3.5-moe with one, deepseek-v3 with the other) against
  the JAX launchers on the same flags.

Every port run's router margin (tests/test_torch_moe.py) is printed and
asserted: above 1e-4 for the engine and the serve launcher, above
`ROUND_MARGIN` 1e-5 for the rounds and `evaluate`. A round routes about
1700 tokens a layer pass (local epochs, scoring, split epochs), and at the
reduced width the router is nearly uniform (logits of std 0.16), so some
token's k-th and (k+1)-th probabilities almost always lie within 1e-4:
of JAX init seeds 0-229 (phi3.5-moe) and 0-157 (deepseek-v3), none and
3 kept the fp32 round above 1e-4, none kept round and `evaluate` both
above it. 1e-5 is still 100 times the two packages' difference in these
probabilities (the logits agree within 2.4e-7). `ROUND_SEED` fixes init
draws whose SFPrompt rounds (fp32 and int8), `evaluate` and FL round stay
above 1e-5: at seed 0 phi3.5-moe's round had a gap of 1.0e-6, and
deepseek-v3's FL round one of 6.1e-6. The launchers' train rounds draw
each package's own init, so their margins are printed only. Where a draw
is fixed, the test says which draws fell below and by how much."""
import torch

torch.set_num_threads(2)

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import repro.launch.serve as jserve  # noqa: E402
import repro.launch.train as jtrain  # noqa: E402
from test_torch_lm_round import (BATCH, K, N_LOCAL, PCFG,  # noqa: E402
                                 assert_tree_close, check_evaluate,
                                 check_round, cohort, jax_wire_noise,
                                 models)
from test_torch_moe import ARCHS, assert_margin, build, margin_probe  # noqa: E402
from test_torch_recurrent_serve import MAX_SEQ, REQS, jax_bank  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import BaselineConfig as JBaselineConfig  # noqa: E402
from repro.core import FLTrainer as JFLTrainer  # noqa: E402
from repro.core import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.core import SFPromptTrainer as JSFPromptTrainer  # noqa: E402
from repro.core import SplitConfig as JSplitConfig  # noqa: E402
from repro.core import SplitModel as JSplitModel  # noqa: E402
from repro.core.local_update import local_epochs as jlocal  # noqa: E402
from repro.core.pruning import score_client_data as jscore  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.bridge import bank_from_arrays, jax_to_torch  # noqa: E402
from repro_torch.core import (BaselineConfig, FLTrainer,  # noqa: E402
                              ProtocolConfig, SFPromptTrainer)
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
# JAX init seeds whose runs keep every router margin above 1e-4 (each
# test's docstring gives the draws below it)
ENGINE_SEED = {"phi3.5-moe-42b-a6.6b": 0, "deepseek-v3-671b": 1}
ROUND_SEED = {"phi3.5-moe-42b-a6.6b": 44, "deepseek-v3-671b": 5}
ROUND_MARGIN = 1e-5


# ------------------------------------------------------------ the engine
@pytest.mark.parametrize("arch,decode_block", [(ARCHS[0], 1),
                                               (ARCHS[1], 4)])
def test_engine_matches_jax_engine(arch, decode_block):
    """Tokens ==, per-step logits within 1e-5, wire bytes and counters ==
    on the int8 wire; this draw flips no payload value (ROADMAP Queue 3
    item 2). Init seeds `ENGINE_SEED`: at seed 0 a deepseek-v3 prefill
    token's two closest router probabilities lie 6.5e-6 apart."""
    jm, tm, params, tparams = build(arch, "int8", seed=ENGINE_SEED[arch])
    jb = jax_bank(params)
    want = JServeEngine(jm, params, jb,
                        JServeConfig(n_slots=2, max_seq=MAX_SEQ,
                                     decode_block=decode_block),
                        collect_logits=True).run(REQS)
    with margin_probe() as margins:
        got = ServeEngine(tm, tparams,
                          bank_from_arrays(jb.tails, jb.prompts, "cpu"),
                          ServeConfig(n_slots=2, max_seq=MAX_SEQ,
                                      decode_block=decode_block),
                          collect_logits=True, device="cpu").run(REQS)
    assert_margin(f"{arch} engine, decode_block {decode_block}", margins)
    assert got["n_finished"] == want["n_finished"] == len(REQS)
    w_by = {f.req.rid: f for f in want["finished"]}
    for f in got["finished"]:
        np.testing.assert_array_equal(f.tokens, w_by[f.req.rid].tokens)
        np.testing.assert_allclose(f.logits, w_by[f.req.rid].logits, **TOL)
    assert got["wire_bytes"] == want["wire_bytes"]
    for key in ("tokens_out", "decode_steps", "prefills", "occupancy"):
        assert got[key] == want[key], key


# ------------------------------------------------------------ the rounds
_ROUNDS = {}


def sfprompt_round(arch, wire="int8"):
    """One JAX SFPrompt round and one port round from the same
    (JAX-initialised) params, data and wire noise, run once a case."""
    if (arch, wire) not in _ROUNDS:
        jm, tm = models(arch, wire)
        data = cohort()
        jtr = JSFPromptTrainer(jm, JProtocolConfig(**PCFG))
        jstate = jtr.init(jax.random.PRNGKey(ROUND_SEED[arch]))
        jnew, jmetrics = jtr.round(jstate, {k: jnp.asarray(v)
                                            for k, v in data.items()})
        ttr = SFPromptTrainer(tm, ProtocolConfig(**PCFG), device="cpu")
        before = launch_counts()
        with margin_probe() as margins:
            tnew, tmetrics = ttr.round(
                {"params": jax_to_torch(jstate["params"], "cpu"),
                 "round": 0}, data, wire_noise=jax_wire_noise(0, K))
        assert launch_counts() == before     # no kernel on CPU tensors
        _ROUNDS[arch, wire] = dict(
            jm=jm, jtr=jtr, ttr=ttr, jstate=jstate, jnew=jnew,
            jmetrics=jmetrics, tnew=tnew, tmetrics=tmetrics,
            margins=margins)
    return _ROUNDS[arch, wire]


@pytest.mark.parametrize("arch", ARCHS)
def test_sfprompt_round_matches_jax(arch):
    """On the int8 wire, this draw flips no quantizer value (ROADMAP Queue
    3 item 2)."""
    r = sfprompt_round(arch)
    assert_margin(f"{arch} SFPrompt round int8", r["margins"],
                  ROUND_MARGIN)
    check_round(r)
    if arch == "deepseek-v3-671b":
        # the MTP head rides in the tail: uploaded, averaged, never trained
        # by the split loss (its gradient is zero in both packages)
        assert_tree_close(r["tnew"]["params"]["tail"]["mtp"],
                          r["jstate"]["params"]["tail"]["mtp"], **TOL)


def jax_phase1(r):
    """JAX's kept sets and scores for the round `r` ran: phases 1a and 1b
    of `repro/core/protocol.py::_round` one client at a time (jitted, not
    vmapped: JAX's `ragged_dot` has no vmap rule for this gradient), from
    the same params and data."""
    jm, jtr = r["jm"], r["jtr"]
    params = r["jstate"]["params"]
    data = {k: jnp.asarray(v) for k, v in cohort().items()}
    opt = jtr.opt_local

    @jax.jit
    def client(d):
        tr = {"tail": params["tail"], "prompt": params["prompt"]}
        tr, _, _ = jlocal(jm, params["head"], tr, opt, opt.init(tr), d,
                          batch_size=BATCH, n_epochs=1, impl="ref")
        return jscore(jm, params["head"], tr["tail"], tr["prompt"], d,
                      batch_size=BATCH, impl="ref")

    scores = jnp.stack([client(jax.tree.map(lambda x: x[c], data))
                        for c in range(K)])
    keep = jtr.phase2_keep(N_LOCAL)
    return (np.asarray(jnp.argsort(-scores, axis=1)[:, :keep]),
            np.asarray(scores))


@pytest.mark.parametrize("arch", ARCHS)
def test_sfprompt_round_kept_sets_and_evaluate_match_jax(arch):
    r = sfprompt_round(arch)
    kept, scores = jax_phase1(r)
    np.testing.assert_allclose(r["ttr"].last_scores.numpy(), scores, **TOL)
    np.testing.assert_array_equal(r["ttr"].last_kept.numpy(), kept)
    with margin_probe() as margins:
        check_evaluate(r)
    assert_margin(f"{arch} evaluate", margins, ROUND_MARGIN)


@pytest.mark.parametrize("arch", ARCHS)
def test_fl_round_matches_jax(arch):
    """FL trains head, body and tail, the expert weights and deepseek-v3's
    dense prefix included (the MTP head gets a zero gradient in both)."""
    jm, tm = models(arch, "fp32")
    data = cohort()
    bcfg = dict(local_epochs=1, batch_size=BATCH, lr=0.05)
    jtr = JFLTrainer(jm, JBaselineConfig(**bcfg))
    jstate = jtr.init(jax.random.PRNGKey(ROUND_SEED[arch]))
    jnew, jmetrics = jtr.round(jstate, {k: jnp.asarray(v)
                                        for k, v in data.items()})
    ttr = FLTrainer(tm, BaselineConfig(**bcfg), device="cpu")
    with margin_probe() as margins:
        tnew, tmetrics = ttr.round(
            {"params": jax_to_torch(jstate["params"], "cpu"), "round": 0},
            data)
    assert_margin(f"{arch} FL round", margins, ROUND_MARGIN)
    np.testing.assert_allclose(tmetrics["train_loss"],
                               jmetrics["train_loss"], **TOL)
    assert_tree_close(tnew["params"], jnew["params"], **TOL)
    moved = tnew["params"]["body"]["stack"]["pos0"]["moe"]["experts"]["up"]
    assert not torch.equal(
        moved, jax_to_torch(jstate["params"], "cpu")["body"]["stack"][
            "pos0"]["moe"]["experts"]["up"])


# --------------------------------------------------------- the launchers
SERVE = ["--requests", "3", "--slots", "2", "--tenants", "1",
         "--prompt-choices", "6", "10", "--new-token-choices", "4",
         "--decode-block", "2", "--wire", "int8"]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_arch_matches_jax(arch, tmp_path):
    """`--arch` with JAX-initialised params (`--params`, the launcher's
    reduced config), one tenant: tokens and wire bytes == the JAX
    launcher's on the same file."""
    cfg = jget_config(arch)
    jm = JSplitModel(cfg.reduced(n_layers=3 * len(cfg.layer_pattern)),
                     JSplitConfig(head_cycles=1, tail_cycles=1,
                                  prompt_len=4))
    path = str(tmp_path / "params.npz")
    jsave(path, jm.init(jax.random.PRNGKey(3)))
    args = SERVE + ["--arch", arch, "--params", path]
    with margin_probe() as margins:
        got = tserve.main(args + ["--device", "cpu"])
    assert_margin(f"{arch} serve launcher", margins)
    want = jserve.main(args)
    assert got["n_finished"] == want["n_finished"] == 3
    assert {f.req.rid: np.asarray(f.tokens).tolist()
            for f in got["finished"]} == \
        {f.req.rid: np.asarray(f.tokens).tolist() for f in want["finished"]}
    assert got["wire_bytes"] == want["wire_bytes"]


TRAIN = ["--reduced", "--layers", "3", "--dataset", "lm-syn", "--clients",
         "2", "--k", "2", "--samples", "16", "--seq-len", "16",
         "--batch-size", "4", "--local-epochs", "1", "--rounds", "1",
         "--prompt-len", "4", "--seed", "0"]


def _records(out, arch, method):
    with open(os.path.join(out, f"{arch}_{method}_lm-syn.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("arch,method", [(ARCHS[0], "sfprompt"),
                                         (ARCHS[1], "fl")])
def test_train_launcher_arch_matches_jax(arch, method, tmp_path,
                                         monkeypatch):
    """One round through each launcher on the same flags: the records'
    keys, wire bytes, cohort and kept_frac ==, every number finite (the
    two packages draw their own init)."""
    args = TRAIN + ["--arch", arch, "--method", method]
    out = str(tmp_path / "port")
    with margin_probe() as margins:
        ttrain.main(args + ["--out", out, "--device", "cpu"])
    print(f"{arch} {method} launcher: router margin {min(margins):.3g} "
          f"(own init, not compared value for value)")
    jout = str(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["train"] + args + ["--out", jout])
    jtrain.main()
    port, ref = _records(out, arch, method), _records(jout, arch, method)
    assert len(port) == len(ref) == 1
    assert set(port[0]) == set(ref[0])
    for key in port[0]:
        if key.startswith(("wire/", "cohort", "round")) or \
                key == "kept_frac":
            assert port[0][key] == ref[0][key], key
        elif isinstance(port[0][key], float):
            assert np.isfinite(port[0][key]), key
