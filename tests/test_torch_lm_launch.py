"""The launchers on token models: `repro_torch.launch.train --arch
qwen2.5-14b --reduced --dataset lm-syn --device cpu` runs an SFPrompt
round end to end (its record's bytes, cohort and kept_frac `==` the JAX
launcher's on the same flags), and `repro_torch.launch.serve --params`
serves a checkpoint written by the port's train launcher, and one written
by the JAX package's `save_checkpoint` from JAX-initialised params, with
the same tokens as the JAX serve launcher on the same file; a checkpoint
that does not fit the model raises."""
import torch

torch.set_num_threads(2)

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import repro.launch.serve as jserve  # noqa: E402
import repro.launch.train as jtrain  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import SplitConfig as JSplitConfig  # noqa: E402
from repro.core import SplitModel as JSplitModel  # noqa: E402
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

TRAIN = ["--arch", "qwen2.5-14b", "--reduced", "--layers", "3",
         "--dataset", "lm-syn", "--clients", "2", "--k", "2", "--samples",
         "16", "--seq-len", "16", "--batch-size", "4", "--local-epochs", "1",
         "--rounds", "1", "--prompt-len", "4", "--seed", "0"]
LOG = "qwen2.5-14b_sfprompt_lm-syn.jsonl"
# one tenant: the launchers' demo banks jitter the other tenants' tails
# from their own packages' generators
SERVE = ["--requests", "3", "--slots", "2", "--tenants", "1",
         "--prompt-choices", "6", "10", "--new-token-choices", "4",
         "--decode-block", "2"]


def _records(out):
    with open(os.path.join(out, LOG)) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("lm") / "port")
    engine = ttrain.main(TRAIN + ["--out", out, "--device", "cpu"])
    return engine, out


def test_train_launcher_lm_round_matches_jax_launcher(port_run, tmp_path,
                                                      monkeypatch, capsys):
    engine, out = port_run
    port = _records(out)
    jout = str(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["train"] + TRAIN + ["--out", jout])
    jtrain.main()
    ref = _records(jout)
    assert len(port) == len(ref) == 1
    assert set(port[0]) == set(ref[0])
    for key in port[0]:
        if key.startswith(("wire/", "cohort", "round")) or \
                key == "kept_frac":
            assert port[0][key] == ref[0][key], key
    for key in ("local_loss", "split_loss", "el2n_mean", "eval_ce",
                "eval_acc"):
        assert np.isfinite(port[0][key]), key
    assert port[0]["kept_frac"] == 0.5
    assert engine.round_idx == 1
    assert engine.trainer.meter.totals["head_body"] == \
        port[0]["wire/head_body_bytes"]


def _serve_tokens(stats):
    return {f.req.rid: np.asarray(f.tokens).tolist()
            for f in stats["finished"]}


def _serve_both(path):
    got = tserve.main(SERVE + ["--params", path, "--device", "cpu"])
    want = jserve.main(SERVE + ["--params", path])
    assert got["n_finished"] == want["n_finished"] == 3
    assert _serve_tokens(got) == _serve_tokens(want)
    assert got["wire_bytes"] == want["wire_bytes"]
    return got


def test_serve_params_from_port_train_checkpoint(port_run):
    """The port's train launcher's final.npz (trained params, not the
    init) serves as in the JAX launcher."""
    engine, out = port_run
    path = os.path.join(out, "final.npz")
    stats = _serve_both(path)
    fresh = tserve.main(SERVE + ["--device", "cpu"])
    assert _serve_tokens(stats) != _serve_tokens(fresh)
    assert np.array_equal(load_checkpoint(path)["prompt"],
                          engine.params["prompt"].numpy())


def test_serve_params_from_jax_checkpoint(tmp_path):
    """JAX-initialised params written by the JAX package's
    save_checkpoint, at the serve launcher's reduced config."""
    cfg = jget_config("qwen2.5-14b")
    jm = JSplitModel(cfg.reduced(n_layers=3 * len(cfg.layer_pattern)),
                     JSplitConfig(head_cycles=1, tail_cycles=1,
                                  prompt_len=4))
    path = str(tmp_path / "jax_params.npz")
    jsave(path, jm.init(jax.random.PRNGKey(3)))
    _serve_both(path)


def test_serve_params_refuses_a_checkpoint_that_does_not_fit(port_run,
                                                             tmp_path):
    """A missing, an extra or a misshapen leaf raises naming it; nothing
    falls back to a fresh init."""
    _, out = port_run
    params = load_checkpoint(os.path.join(out, "final.npz"))
    cases = {
        "missing tail/final_norm/scale": dict(
            params, tail={k: v for k, v in params["tail"].items()
                          if k != "final_norm"}),
        "unexpected extra": dict(params, extra=np.zeros(3, np.float32)),
        "prompt: float32[3, 256]": dict(params,
                                        prompt=params["prompt"][:3]),
    }
    for i, (msg, tree) in enumerate(cases.items()):
        path = str(tmp_path / f"bad{i}.npz")
        save_checkpoint(path, tree)
        with pytest.raises(ValueError, match=msg.replace("[", r"\[")):
            tserve.main(SERVE + ["--params", path, "--device", "cpu"])
