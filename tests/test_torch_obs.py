"""The port's observability against the contract of tests/test_obs.py and
against the JAX package's traces: tracing off is bit-identical to tracing
on (a round, a paged serve run), traced bytes sum exactly to the meter,
traces are deterministic modulo wall time, the metrics registry reads a
live port engine, tools/trace_check.py accepts a real port export and
rejects byte drift, the serve launcher's trace flags, and the
`strip_times` record streams of one SFPrompt round and of one dense serve
trace equal JAX's on bridged weights (at level `step` once the port's
per-phase spans are taken out)."""
import torch

torch.set_num_threads(2)

import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.core import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.core import SFPromptTrainer as JSFPromptTrainer  # noqa: E402
from repro.obs import Tracer as JTracer  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.bridge import jax_to_torch  # noqa: E402
from repro_torch.core import ProtocolConfig, SFPromptTrainer  # noqa: E402
from repro_torch.data import (DATASETS, iid_partition,  # noqa: E402
                              select_clients, stack_clients,
                              synthetic_image_dataset)
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.obs import (NOOP, MetricsRegistry, Tracer,  # noqa: E402
                             export_all, strip_times, sum_stream)
from repro_torch.obs.export import write_jsonl  # noqa: E402
from repro_torch.serve import (PagedServeConfig,  # noqa: E402
                               PagedServeEngine, ServeConfig, ServeEngine)
from repro_torch.tree import tree_leaves  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_paged as tpaged  # noqa: E402
import test_torch_serve as tserve  # noqa: E402
import test_torch_train as ttrain  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE_CHECK = os.path.join(REPO, "tools", "trace_check.py")
# the spans the port's round adds at level step, one a protocol phase,
# each closed after a device sync (core/protocol.py `_phase`)
PHASE_SPANS = ("phase1a", "phase1b", "phase2", "phase3")
PCFG = dict(ttrain.PCFG, momentum=0.0)


# ------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def clients():
    """The reduced ViT's clients of tests/test_torch_train.py (8 of 24)."""
    d = synthetic_image_dataset(DATASETS["cifar10-syn"], 8 * 24, seed=0,
                                image_hw=32)
    return iid_partition(d, 8, seed=0)


def _cohort(clients, r):
    return stack_clients(clients, select_clients(8, 2, seed=0, round_idx=r))


def _port_rounds(clients, tracer=None, n=2, wire="int8", params=None):
    _, tm = ttrain._models(wire)
    tr = SFPromptTrainer(tm, ProtocolConfig(**PCFG), tracer=tracer,
                         device="cpu")
    state = {"params": params if params is not None else
             tm.init(torch.Generator().manual_seed(0), device="cpu"),
             "round": 0}
    for r in range(n):
        state, _ = tr.round(state, _cohort(clients, r),
                            wire_noise=ttrain.jax_wire_noise(r, 2))
    return tr, state


@pytest.fixture(scope="module")
def g1():
    return tpaged._build("g1")


def _paged_run(g, tracer=None):
    eng = PagedServeEngine(
        g["tm"], g["tparams"], g["tbank"],
        PagedServeConfig(n_slots=2, max_seq=tpaged.MAX_SEQ, decode_block=2,
                         page_size=8, shared_prefix=(3, 5, 7, 11),
                         prefill_chunk=8),
        collect_logits=True, tracer=tracer, device="cpu")
    return eng, eng.run(list(tpaged.REQS_HIT))


@pytest.fixture(scope="module")
def trace_check():
    spec = importlib.util.spec_from_file_location("trace_check",
                                                  TRACE_CHECK)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------- tracing off == never happened
def test_round_bit_identical_with_and_without_tracing(clients):
    tr_off, st_off = _port_rounds(clients)
    tr_on, st_on = _port_rounds(clients, tracer=Tracer("step"))
    assert tr_off.tracer is NOOP and tr_off.tracer.records() == ()
    for a, b in zip(tree_leaves(st_off["params"]),
                    tree_leaves(st_on["params"])):
        assert torch.equal(a, b)
    assert tr_off.meter.totals == tr_on.meter.totals
    assert len(tr_on.tracer.records()) > 0


def test_serve_bit_identical_with_and_without_tracing(g1):
    _, off = _paged_run(g1)
    eng_on, on = _paged_run(g1, tracer=Tracer("step"))
    offs = {f.req.rid: f for f in off["finished"]}
    ons = {f.req.rid: f for f in on["finished"]}
    assert set(offs) == set(ons) == {r.rid for r in tpaged.REQS_HIT}
    for rid in offs:
        np.testing.assert_array_equal(offs[rid].tokens, ons[rid].tokens)
        np.testing.assert_array_equal(offs[rid].logits, ons[rid].logits)
    assert off["wire_bytes"] == on["wire_bytes"]
    names = {r["name"] for r in eng_on.tracer.records()}
    assert {"serve.admit", "serve.chunk", "serve.decode", "serve.retire",
            "page.alloc", "page.free", "meter.absorb"} <= names


# -------------------------------------------------- exact byte accounting
def test_round_trace_bytes_sum_exactly_to_meter(clients):
    tr, _ = _port_rounds(clients, tracer=Tracer("step"), n=3)
    recs = tr.tracer.records()
    for stream, total in tr.meter.totals.items():
        assert sum_stream(recs, "meter.absorb", stream) == total
    spans = [r for r in recs if r["name"] == "round"]
    assert len(spans) == 3
    for stream in ("head_body", "body_tail", "params"):
        assert sum(s["attrs"][stream] for s in spans) == \
            tr.meter.totals[stream]
    assert [r["name"] for r in recs if r["name"] in PHASE_SPANS] == \
        list(PHASE_SPANS) * 3


def test_serve_trace_bytes_sum_exactly_to_meter(g1):
    eng, _ = _paged_run(g1, tracer=Tracer("step"))
    recs = eng.tracer.records()
    for stream, total in eng.meter.totals.items():
        assert sum_stream(recs, "meter.absorb", stream) == total


# ------------------------------------------------------------ determinism
def test_traces_deterministic_modulo_walltime(clients, g1):
    a, _ = _port_rounds(clients, tracer=Tracer("step"))
    b, _ = _port_rounds(clients, tracer=Tracer("step"))
    assert strip_times(a.tracer.records()) == \
        strip_times(b.tracer.records())
    e1, _ = _paged_run(g1, tracer=Tracer("step"))
    e2, _ = _paged_run(g1, tracer=Tracer("step"))
    assert strip_times(e1.tracer.records()) == \
        strip_times(e2.tracer.records())


# ------------------------------------------------------- metrics registry
def test_registry_binds_live_port_engine(g1):
    eng, stats = _paged_run(g1)
    reg = MetricsRegistry()
    reg.bind_engine(eng)
    reg.bind_pool(eng.pool_alloc)
    snap = reg.snapshot()
    assert snap["serve/tokens_out"] == stats["tokens_out"]
    assert snap["serve/prefills"] == stats["prefills"]
    assert snap["serve/wire_bytes/total"] == stats["wire_bytes"]["total"]
    assert snap["pages/n_pages"] == eng.pool_alloc.n_pages
    assert snap["pages/n_used"] == eng.pool_alloc.n_used == 0
    # the binding is lazy: a later run shows up in the next snapshot
    eng.reset_stats()
    assert reg.snapshot()["serve/tokens_out"] == 0


def test_registry_binds_trainer_meter(clients):
    tr, _ = _port_rounds(clients, n=1)
    reg = MetricsRegistry()
    reg.bind_meter(tr.meter)
    snap = reg.snapshot()
    assert snap["meter/rounds"] == 1
    assert snap["meter/totals/head_body"] == tr.meter.totals["head_body"]
    assert snap["meter/total_bytes"] == tr.meter.total_bytes()


# ------------------------------------------------------- trace_check
def test_trace_check_accepts_real_port_export(trace_check, tmp_path,
                                              clients):
    tr, _ = _port_rounds(clients, tracer=Tracer("step"))
    paths = export_all(tr.tracer, str(tmp_path / "run"), meter=tr.meter)
    assert sorted(paths) == ["chrome", "jsonl"]
    with open(paths["jsonl"]) as f:
        assert trace_check.check(f) == 0
    with open(paths["chrome"]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e["name"] == "phase2" and e["ph"] == "X" for e in events)
    res = subprocess.run([sys.executable, TRACE_CHECK, paths["jsonl"]],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    assert "meter.final" in res.stdout


def test_trace_check_rejects_byte_drift_in_port_export(trace_check,
                                                       tmp_path, clients):
    tr, _ = _port_rounds(clients, tracer=Tracer("round"), n=1)
    recs = [dict(r) for r in tr.tracer.records()]
    absorb = next(r for r in recs if r["name"] == "meter.absorb")
    absorb["attrs"] = dict(absorb["attrs"],
                           head_body=absorb["attrs"]["head_body"] + 1.0)
    path = str(tmp_path / "drift.jsonl")
    write_jsonl(path, recs, tr.meter)
    with open(path) as f:
        assert trace_check.check(f) == 1


# ------------------------------------------------- the same as JAX's
def _drop_phases(recs):
    """The records without the port's per-phase spans, `seq` renumbered
    (the spans took sequence numbers of their own)."""
    kept = [dict(r) for r in recs if r["name"] not in PHASE_SPANS]
    for i, r in enumerate(kept):
        r["seq"] = i
    return kept


@pytest.mark.parametrize("level", ["round", "step"])
def test_round_trace_equals_jax(clients, level):
    """Two SFPrompt rounds (reduced ViT, int8 wire on JAX's noise) traced
    by both packages: the same records in the same order with the same
    attributes — the byte floats included — once times are stripped."""
    jm, _ = ttrain._models("int8")
    jtr = JSFPromptTrainer(jm, JProtocolConfig(**PCFG),
                           tracer=JTracer(level))
    jstate = jtr.init(jax.random.PRNGKey(0))
    tparams = jax_to_torch(jstate["params"], "cpu")
    for r in range(2):
        jstate, _ = jtr.round(jstate, {k: jnp.asarray(v) for k, v in
                                       _cohort(clients, r).items()})
    ttr, _ = _port_rounds(clients, tracer=Tracer(level), params=tparams)
    want = strip_times(jtr.tracer.records())
    got = strip_times(ttr.tracer.records())
    assert [r["name"] for r in want].count("round.dispatch") == \
        (2 if level == "step" else 0)
    if level == "step":
        assert [r["name"] for r in got if r["name"] in PHASE_SPANS] == \
            list(PHASE_SPANS) * 2
        got = _drop_phases(got)
    assert got == want


@pytest.mark.parametrize("level", ["round", "step"])
def test_dense_serve_trace_equals_jax(level):
    (jm, params, jb), (tm, tparams, tbank) = tserve.build("int8")
    jeng = JServeEngine(jm, params, jb,
                        JServeConfig(n_slots=2, max_seq=tserve.MAX_SEQ,
                                     decode_block=2), tracer=JTracer(level))
    jeng.run(tserve.REQS)
    teng = ServeEngine(tm, tparams, tbank,
                       ServeConfig(n_slots=2, max_seq=tserve.MAX_SEQ,
                                   decode_block=2),
                       tracer=Tracer(level), device="cpu")
    teng.run(tserve.REQS)
    want = strip_times(jeng.tracer.records())
    assert strip_times(teng.tracer.records()) == want
    assert ("serve.decode" in {r["name"] for r in want}) == \
        (level == "step")


# ---------------------------------------------- the serve launcher's flags
LAUNCH = ["--device", "cpu", "--requests", "3", "--slots", "2", "--tenants",
          "2", "--wire", "int8", "--prompt-choices", "6", "10",
          "--new-token-choices", "3", "--decode-block", "2"]


@pytest.mark.parametrize("paged", [False, True])
def test_serve_launcher_trace_out_exports_and_passes_trace_check(
        tmp_path, capsys, trace_check, paged):
    """--trace-out alone raises the level to `round` and writes the JSONL,
    the Chrome trace and the Prometheus text of the registry."""
    base = str(tmp_path / "serve")
    extra = ["--page-size", "8"] if paged else []
    stats = launch_serve.main(LAUNCH + extra + ["--trace-out", base])
    out = capsys.readouterr().out
    for ext in ("jsonl", "trace.json", "prom"):
        assert os.path.exists(f"{base}.{ext}")
        assert f"{base}.{ext}" in out
    with open(f"{base}.jsonl") as f:
        recs = [json.loads(line) for line in f]
    with open(f"{base}.jsonl") as f:
        assert trace_check.check(f) == 0
    names = {r["name"] for r in recs}
    # level round: admissions and retirements, no per-step records
    assert ("serve.admit" if paged else "serve.prefill") in names
    assert "serve.retire" in names and "serve.decode" not in names
    assert recs[-1]["attrs"]["head_body"] == \
        stats["wire_bytes"]["head_body"]
    prom = open(f"{base}.prom").read()
    assert f"serve_tokens_out {float(stats['tokens_out'])}" in prom
    assert ("pages_n_pages" in prom) == paged


def test_serve_launcher_metrics_every_and_trace_level(capsys):
    """--metrics-every N prints a registry snapshot every N engine steps;
    --trace-level without --trace-out prints the final snapshot."""
    stats = launch_serve.main(LAUNCH + ["--metrics-every", "2",
                                        "--trace-level", "step"])
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines() if line.startswith("{")]
    steps = [r for r in lines if "step" in r]
    assert steps and all(r["step"] % 2 == 0 for r in steps)
    assert [r["step"] for r in steps] == sorted({r["step"] for r in steps})
    assert all(r["metrics"]["serve/step_idx"] == r["step"] for r in steps)
    assert lines[-1] == {"metrics": lines[-1]["metrics"]}
    assert lines[-1]["metrics"]["serve/tokens_out"] == stats["tokens_out"]
