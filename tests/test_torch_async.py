"""The port's buffered async runtime (`repro_torch.fed.buffer`,
`repro_torch.fed.async_engine`, `SFPromptTrainer.client_updates`) against
the JAX package's, on the CPU, at the reduced ViT of tests/test_async.py
(3 layers, d_model 32): staleness weights, flush weights, the buffer and
the ledger `==`; the clock-only engine's clock, meter and sim-clock trace
`==`; the sync anchor (one flush == one synchronous round, bit for bit);
a dropout run's clock, ledger and bytes `==` and params within 1e-5; the
secure flush under dropout; byte-identical resume through a non-empty
buffer and the refusals with JAX's messages; and `launch.train
--async-buffer` against the JAX launcher.

Both packages start from the same JAX-initialized params (through
`bridge.py`); the JAX runs are shared through module-scoped fixtures.
With the fp32 wire no rounding noise is drawn."""
import torch

torch.set_num_threads(2)

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import repro.launch.train as jtrain  # noqa: E402
from repro.checkpoint.io import load_latest as jload_latest  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.core import SFPromptTrainer as JSFPromptTrainer  # noqa: E402
from repro.core import SplitConfig as JSplitConfig  # noqa: E402
from repro.core import SplitModel as JSplitModel  # noqa: E402
from repro.core.aggregation import get_aggregator as jget_aggregator  # noqa: E402
from repro.data import DATASETS, synthetic_image_dataset  # noqa: E402
from repro.fed import AsyncConfig as JAsyncConfig  # noqa: E402
from repro.fed import AsyncRoundEngine as JAsyncRoundEngine  # noqa: E402
from repro.fed import ClientSampler as JClientSampler  # noqa: E402
from repro.fed import Population as JPopulation  # noqa: E402
from repro.fed import RoundScheduler as JRoundScheduler  # noqa: E402
from repro.fed import StragglerConfig as JStragglerConfig  # noqa: E402
from repro.fed import buffer as jbuffer  # noqa: E402
from repro.obs.trace import Tracer as JTracer  # noqa: E402
from repro.obs.trace import strip_times as jstrip_times  # noqa: E402
from repro.runtime import WireSpec as JWireSpec  # noqa: E402
from repro_torch.bridge import jax_to_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (BaselineConfig, FLTrainer,  # noqa: E402
                              ProtocolConfig, SFPromptTrainer, SplitConfig,
                              SplitModel)
from repro_torch.core.aggregation import get_aggregator  # noqa: E402
from repro_torch.fed import (AsyncConfig, AsyncRoundEngine,  # noqa: E402
                             ClientSampler, FederatedEngine, Population,
                             RoundScheduler, StragglerConfig)
from repro_torch.fed import buffer as tbuffer  # noqa: E402
from repro_torch.fed.engine import _flatten_numeric  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.obs.trace import Tracer, strip_times  # noqa: E402
from repro_torch.privacy.fixed_point import roundtrip_tol  # noqa: E402
from repro_torch.privacy.secure_agg import SecureAggregator  # noqa: E402
from repro_torch.runtime import WireSpec  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

N_CLIENTS, N_LOCAL, BATCH, K = 40, 8, 4, 4
SPLIT = dict(head_cycles=1, tail_cycles=1, prompt_len=2, prune_gamma=0.3,
             local_epochs=1)
PCFG = dict(clients_per_round=K, local_epochs=1, batch_size=BATCH,
            momentum=0.0)
TOL = dict(atol=1e-5, rtol=1e-5)
# the dropout run: buffer 3, two groups in flight, staleness decay 0.5
ACFG = dict(buffer_size=3, concurrency=2, staleness_beta=0.5)
KEY = jax.random.PRNGKey(0)


def _cfg(get):
    return get("vit-base").reduced(n_layers=3, d_model=32, d_ff=64)


@pytest.fixture(scope="module")
def data():
    return synthetic_image_dataset(DATASETS["cifar10-syn"],
                                   N_CLIENTS * N_LOCAL, seed=0, image_hw=32)


@pytest.fixture(scope="module")
def jparams():
    """The JAX init both packages start from."""
    model = JSplitModel(_cfg(jget_config), JSplitConfig(**SPLIT),
                        JWireSpec.make("fp32"))
    return model.init(KEY)


def port_trainer(*, return_client=True, aggregator=None, **pcfg):
    model = SplitModel(_cfg(get_config), SplitConfig(**SPLIT),
                       WireSpec.make("fp32"))
    return SFPromptTrainer(model, ProtocolConfig(
        **dict(PCFG, **pcfg), return_client_trainable=return_client),
        aggregator, device="cpu")


def jax_trainer(*, return_client=True, aggregator=None):
    model = JSplitModel(_cfg(jget_config), JSplitConfig(**SPLIT),
                        JWireSpec.make("fp32"))
    return JSFPromptTrainer(model, JProtocolConfig(
        **PCFG, return_client_trainable=return_client), aggregator)


def port_pop(data):
    return Population.from_partition(data, N_CLIENTS, scheme="dirichlet",
                                     alpha=0.1, seed=0)


def jax_pop(data):
    return JPopulation.from_partition(data, N_CLIENTS, scheme="dirichlet",
                                      alpha=0.1, seed=0)


def wan(sched, cfg, *, seed=3, dropout=0.0):
    return sched(cfg(regime="wan", dropout_rate=dropout), seed=seed,
                 round_bytes_per_client=1e6, round_flops_per_client=1e12)


def port_engine(data, params, *, acfg=None, aggregator=None, dropout=0.2,
                trainer=None):
    eng = AsyncRoundEngine(
        trainer or port_trainer(), port_pop(data),
        ClientSampler(N_CLIENTS, K, seed=3),
        wan(RoundScheduler, StragglerConfig, dropout=dropout),
        AsyncConfig(**(acfg or ACFG)), aggregator=aggregator)
    eng.init(torch.Generator().manual_seed(0))
    eng.state = {"params": jax_to_torch(params, "cpu"), "round": 0}
    return eng


def jax_engine(data, *, aggregator=None, dropout=0.2):
    eng = JAsyncRoundEngine(
        jax_trainer(), jax_pop(data), JClientSampler(N_CLIENTS, K, seed=3),
        wan(JRoundScheduler, JStragglerConfig, dropout=dropout),
        JAsyncConfig(**ACFG), aggregator=aggregator)
    eng.init(KEY)
    return eng


def _assert_tree_close(t_tree, j_tree, **tol):
    jflat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, j_tree))[0]
    tflat = tree_flatten(t_tree)
    assert [tuple(p.key for p in path) for path, _ in jflat] == \
        [path for path, _ in tflat]
    for (path, leaf), (_, tleaf) in zip(jflat, tflat):
        np.testing.assert_allclose(np.asarray(tleaf), leaf,
                                   err_msg=jax.tree_util.keystr(path), **tol)


def _trees_equal(a, b):
    fa, fb = tree_flatten(a), tree_flatten(b)
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(fa, fb))


def _ledger_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for key in sa:
        np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)
        assert np.asarray(sa[key]).dtype == np.asarray(sb[key]).dtype, key


# ------------------------------------------------------ buffer and ledger
def test_staleness_and_flush_weights_equal_jax():
    s = np.arange(0, 9)
    for alpha, beta in ((1.0, 0.5), (1.0, 0.0), (0.25, 2.0), (3.0, 0.7)):
        a = tbuffer.staleness_weight(s, alpha=alpha, beta=beta)
        b = jbuffer.staleness_weight(s, alpha=alpha, beta=beta)
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    assert tbuffer.staleness_weight(3, alpha=1.0, beta=0.5) == \
        jbuffer.staleness_weight(3, alpha=1.0, beta=0.5)
    with pytest.raises(ValueError, match="staleness must be >= 0"):
        tbuffer.staleness_weight([-1])

    def entries(mod):
        spec = [(0, 3, 8, 6, False), (1, 1, 7, 6, False),
                (2, 3, 9, 6, True), (3, 0, 11, 5, False)]
        return [mod.BufferEntry(client_id=c, dispatch_idx=0, position=c,
                                version=v, size=size, keep=keep,
                                contribution=None, arrival_t=float(c),
                                dropped=dropped)
                for c, v, size, keep, dropped in spec]

    for alpha, beta in ((1.0, 0.5), (2.0, 0.0), (0.5, 1.5)):
        a = tbuffer.flush_weights(entries(tbuffer), alpha=alpha, beta=beta,
                                  version=3)
        b = jbuffer.flush_weights(entries(jbuffer), alpha=alpha, beta=beta,
                                  version=3)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        assert a[2] == 0.0


def test_buffer_fill_drain_and_ledger_round_trip_equal_jax():
    def fill(mod):
        buf = mod.DeltaBuffer(buffer_size=2)
        states = []
        for cid, dropped in ((2, True), (1, False), (0, False)):
            buf.append(mod.BufferEntry(
                client_id=cid, dispatch_idx=cid % 2, position=cid,
                version=0, size=8, keep=6, contribution=None,
                arrival_t=0.0, dropped=dropped))
            states.append((len(buf), buf.n_live, buf.full))
        return states, [e.client_id for e in buf.drain()], len(buf)

    assert fill(tbuffer) == fill(jbuffer)
    with pytest.raises(ValueError, match="buffer_size must be >= 1"):
        tbuffer.DeltaBuffer(buffer_size=0)
    with pytest.raises(ValueError, match="empty flush cohort"):
        tbuffer.DeltaBuffer.stacked([])

    t, j = tbuffer.StalenessLedger(5), jbuffer.StalenessLedger(5)
    for led in (t, j):
        for cid, s in ((0, 0), (1, 3), (0, 1), (4, 2)):
            led.record(cid, s)
    _ledger_equal(t, j)
    assert t.mean_staleness() == j.mean_staleness()
    fresh = tbuffer.StalenessLedger(5)
    fresh.load_state_dict(j.state_dict())
    _ledger_equal(fresh, t)
    with pytest.raises(ValueError) as te:
        tbuffer.StalenessLedger(6).load_state_dict(t.state_dict())
    with pytest.raises(ValueError) as je:
        jbuffer.StalenessLedger(6).load_state_dict(j.state_dict())
    assert str(te.value) == str(je.value)


# ------------------------------------------------------ clock-only engine
def test_clock_only_engine_equals_jax_bit_for_bit():
    """Concurrency 3, groups of 4 out of cohorts of 8, buffer 4, WAN, six
    flushes: the simulated clock, flush history, ledger, meter (bytes and
    wall streams) and the sim-clock trace records equal JAX's exactly, and
    the groups overlap (parallelism > 1)."""
    acfg = dict(buffer_size=4, concurrency=3, group_size=4)
    t = AsyncRoundEngine(None, None, ClientSampler(N_CLIENTS, 8, seed=3),
                         wan(RoundScheduler, StragglerConfig),
                         AsyncConfig(**acfg), tracer=Tracer("step"))
    j = JAsyncRoundEngine(None, None, JClientSampler(N_CLIENTS, 8, seed=3),
                          wan(JRoundScheduler, JStragglerConfig),
                          JAsyncConfig(**acfg), tracer=JTracer("step"))
    t.init(None)
    j.init(None)
    ts, js = t.run_flushes(6), j.run_flushes(6)
    assert ts == js and ts["flushes"] == 6
    assert t.t_sim == j.t_sim and t.arrivals == j.arrivals
    assert t.flush_history == j.flush_history
    _ledger_equal(t.ledger, j.ledger)
    assert t.meter.state_dict() == j.meter.state_dict()
    assert t.meter.overlap() == j.meter.overlap()
    assert t.meter.overlap()["parallelism"] > 1.0
    trec, jrec = t.tracer.records(), j.tracer.records()
    assert [r["name"] for r in trec] == [r["name"] for r in jrec]
    names = {r["name"] for r in trec}
    assert {"async.dispatch", "async.client", "async.arrival",
            "async.flush", "buffer.append", "buffer.drain"} <= names
    # sim-clock records carry t_sim (and dur_sim); the drain is host-timed
    for a, b in zip(trec, jrec):
        if "t_sim" in a:
            assert a["t_sim"] == b["t_sim"] and a.get("dur_sim") == \
                b.get("dur_sim"), a["name"]
    assert strip_times(trec) == jstrip_times(jrec)


# ------------------------------------------------------------ sync anchor
def test_sync_anchor_one_flush_is_one_sync_round(data, jparams):
    """buffer_size == K, concurrency 1, beta 0: one flush IS one sync
    round of the port — params and every metered byte stream identical."""
    tr_s = port_trainer()
    sync = FederatedEngine(tr_s, port_pop(data),
                           ClientSampler(N_CLIENTS, K, seed=3))
    sync.state = {"params": jax_to_torch(jparams, "cpu"), "round": 0}
    sync.run_round()
    # no scheduler in either engine: every client on time
    eng = AsyncRoundEngine(port_trainer(), port_pop(data),
                           ClientSampler(N_CLIENTS, K, seed=3),
                           acfg=AsyncConfig(buffer_size=K, concurrency=1,
                                            staleness_beta=0.0))
    eng.state = {"params": jax_to_torch(jparams, "cpu"), "round": 0}
    stats = eng.run_flushes(1)
    assert stats["flushes"] == 1 and stats["arrivals"] == K
    assert stats["max_staleness"] == 0
    assert _trees_equal(sync.params, eng.params)
    sm, am = tr_s.meter.as_dict(), eng.meter.as_dict()
    assert set(sm) == set(am)
    for k in sm:
        assert sm[k] == am[k], f"meter stream {k}: {sm[k]} != {am[k]}"
    # the dispatch round billed the downlink alone, the arrivals the rest
    assert eng.last_dispatch_metrics["cohort/active"] == 0.0


# ------------------------------------------------- against the JAX engine
@pytest.fixture(scope="module")
def dropout_runs(data, jparams):
    """Four flushes of each package's engine under WAN with dropouts."""
    j = jax_engine(data)
    jstats = [j.run_flushes(1) for _ in range(4)]
    t = port_engine(data, jparams)
    tstats = [t.run_flushes(1) for _ in range(4)]
    return t, j, tstats, jstats


def test_dropout_run_matches_jax(dropout_runs):
    t, j, tstats, jstats = dropout_runs
    assert tstats == jstats
    assert t.t_sim == j.t_sim and t.arrivals == j.arrivals
    assert t.dispatch_idx == j.dispatch_idx
    assert t.flush_history == j.flush_history
    _ledger_equal(t.ledger, j.ledger)
    assert t.ledger.max_staleness >= 1          # staleness was exercised
    assert t.meter.state_dict() == j.meter.state_dict()
    _assert_tree_close(t.params, j.params, **TOL)
    assert {(f.client_id, f.dispatch_idx, f.finish_t, f.dropped)
            for f in t.in_flight} == \
        {(f.client_id, f.dispatch_idx, f.finish_t, f.dropped)
         for f in j.in_flight}


def test_contributions_stay_detached_device_tensors(dropout_runs):
    t = dropout_runs[0]
    held = [f.contribution for f in t.in_flight] + \
        [e.contribution for e in t.buffer.entries]
    assert held
    for tree in held:
        for _, x in tree_flatten(tree):
            assert isinstance(x, torch.Tensor) and x.grad_fn is None
            assert not x.requires_grad and x.device.type == "cpu"
            assert x._base is None                # its own storage


# ----------------------------------------------------------------- resume
def test_resume_byte_identical_with_nonempty_buffer(data, jparams,
                                                    dropout_runs, tmp_path):
    """Kill mid-flush (entries buffered, clients in flight), restore into a
    fresh engine, drive both to four flushes: params, meter, clock and
    ledger equal the uninterrupted run's (the module's dropout run)."""
    ref = dropout_runs[0]
    a = port_engine(data, jparams)
    a.run_flushes(2)
    a.step_event()
    a.step_event()
    assert len(a.buffer) > 0 and len(a.in_flight) > 0
    a.save(str(tmp_path))
    b = port_engine(data, jparams)
    b.state = None
    assert b.restore(str(tmp_path))
    assert len(b.buffer.entries) == len(a.buffer.entries)
    assert len(b.in_flight) == len(a.in_flight)
    for x, y in zip(sorted(a.in_flight, key=lambda f: f.order_key()),
                    sorted(b.in_flight, key=lambda f: f.order_key())):
        assert x.finish_t == y.finish_t and _trees_equal(x.contribution,
                                                         y.contribution)
    for eng in (a, b):
        while eng.version < 4:
            eng.step_event()
    for other in (a, b):
        assert _trees_equal(ref.params, other.params)
        assert other.t_sim == ref.t_sim
        assert other.arrivals == ref.arrivals
        assert other.meter.state_dict() == ref.meter.state_dict()
        _ledger_equal(other.ledger, ref.ledger)


def test_resume_refusals_carry_jax_messages(data, jparams, tmp_path):
    """A changed async config, flush aggregator or trainer is refused with
    the JAX engine's message (the JAX engine restores the port's npz)."""
    trained = str(tmp_path / "trained")
    a = port_engine(data, jparams, acfg=dict(buffer_size=2, concurrency=1))
    a.run_flushes(1)
    a.save(trained)
    clock = str(tmp_path / "clock")
    c = AsyncRoundEngine(None, None, ClientSampler(N_CLIENTS, K, seed=3),
                         wan(RoundScheduler, StragglerConfig),
                         AsyncConfig(buffer_size=2, concurrency=1))
    c.init(None)
    c.run_flushes(1)
    c.save(clock)

    def refusal(engine, ckpt):
        with pytest.raises(ValueError) as exc:
            engine.restore(ckpt)
        return str(exc.value)

    def clock_only(pkg, **acfg):
        secure = acfg.pop("secure", False)
        if pkg == "port":
            return AsyncRoundEngine(
                None, None, ClientSampler(N_CLIENTS, K, seed=3),
                wan(RoundScheduler, StragglerConfig),
                AsyncConfig(**dict(dict(buffer_size=2, concurrency=1),
                                   **acfg)),
                aggregator=(get_aggregator(secure=True, seed=1)
                            if secure else None))
        return JAsyncRoundEngine(
            None, None, JClientSampler(N_CLIENTS, K, seed=3),
            wan(JRoundScheduler, JStragglerConfig),
            JAsyncConfig(**dict(dict(buffer_size=2, concurrency=1),
                                **acfg)),
            aggregator=(jget_aggregator(secure=True, seed=1)
                        if secure else None))

    # async config: buffer 3 against the checkpoint's 2
    msg = refusal(clock_only("port", buffer_size=3), clock)
    assert "async config mismatch" in msg and "buffer_size" in msg
    assert msg == refusal(clock_only("jax", buffer_size=3), clock)
    # flush aggregator: secure against the checkpoint's clear
    msg = refusal(clock_only("port", secure=True), clock)
    assert msg.startswith("flush aggregator mismatch")
    assert msg == refusal(clock_only("jax", secure=True), clock)
    # a trained checkpoint into a clock-only engine
    msg = refusal(clock_only("port"), trained)
    assert msg == refusal(clock_only("jax"), trained)
    assert "clock-only" in msg
    # a clock-only checkpoint into an engine with a trainer
    msg = refusal(port_engine(data, jparams,
                              acfg=dict(buffer_size=2, concurrency=1)),
                  clock)
    assert "clock-only checkpoint resumed with a trainer" in msg
    # a trainer built with other hyperparameters
    other = port_engine(data, jparams, trainer=port_trainer(lr_split=0.5),
                        acfg=dict(buffer_size=2, concurrency=1))
    msg = refusal(other, trained)
    assert msg.startswith("trainer mismatch on resume")
    jeng = JAsyncRoundEngine(
        jax_trainer(), jax_pop(data), JClientSampler(N_CLIENTS, K, seed=3),
        wan(JRoundScheduler, JStragglerConfig),
        JAsyncConfig(buffer_size=2, concurrency=1))
    assert msg == refusal(jeng, trained)


def test_misconfigured_trainers_refused_as_jax(data):
    """Every construction refusal of the JAX engine, with its message."""
    sampler, jsampler = (ClientSampler(N_CLIENTS, K, seed=3),
                         JClientSampler(N_CLIENTS, K, seed=3))
    cases = [
        (lambda: (port_trainer(return_client=False), port_pop(data), {}),
         lambda: (jax_trainer(return_client=False), jax_pop(data), {}),
         "return_client_trainable"),
        (lambda: (port_trainer(aggregator=get_aggregator(secure=True,
                                                         seed=0)),
                  port_pop(data), {}),
         lambda: (jax_trainer(aggregator=jget_aggregator(secure=True,
                                                         seed=0)),
                  jax_pop(data), {}),
         "CLEAR aggregator"),
        (lambda: (port_trainer(), None, {}),
         lambda: (jax_trainer(), None, {}), "population"),
        (lambda: (None, None, {"acfg": AsyncConfig(group_size=K + 1)}),
         lambda: (None, None, {"acfg": JAsyncConfig(group_size=K + 1)}),
         "group_size"),
    ]
    for port_args, jax_args, match in cases:
        tr, pop, kw = port_args()
        with pytest.raises(ValueError, match=match) as te:
            AsyncRoundEngine(tr, pop, sampler, **kw)
        tr, pop, kw = jax_args()
        with pytest.raises(ValueError) as je:
            JAsyncRoundEngine(tr, pop, jsampler, **kw)
        assert str(te.value) == str(je.value)
    model = SplitModel(_cfg(get_config), SplitConfig(**SPLIT),
                       WireSpec.make("fp32"))
    with pytest.raises(ValueError, match="cannot run async dispatch"):
        AsyncRoundEngine(FLTrainer(model, BaselineConfig(), device="cpu"),
                         port_pop(data), sampler)
    for bad, match in ((dict(buffer_size=0), "buffer_size"),
                       (dict(concurrency=0), "concurrency"),
                       (dict(group_size=-1), "group_size"),
                       (dict(staleness_alpha=0.0), "staleness_alpha"),
                       (dict(staleness_beta=-1.0), "staleness_beta")):
        with pytest.raises(ValueError, match=match):
            AsyncConfig(**bad)
    with pytest.raises(RuntimeError, match="init"):
        AsyncRoundEngine(None, None, sampler).run_flushes(1)


# ----------------------------------------------------------- secure flush
class _Recording(SecureAggregator):
    """The secure aggregator, keeping each flush's weights."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.weights = []

    def aggregate(self, client_trees, weights, fallback, round_idx):
        self.weights.append(np.asarray(weights, np.float32))
        return super().aggregate(client_trees, weights, fallback, round_idx)


def test_secure_flush_under_dropout(data, jparams):
    """The flush cohort is the secure-agg unit: a flush that carries a
    dropped passenger (dangling-mask recovery) lands within roundtrip_tol
    of the clear flush and bills a secure stream; against JAX's secure
    flush its params and secure bytes are `==` and its params within 1e-5
    plus one fixed-point quantum. On the CPU the masked encode runs its
    plain version: no kernel launch."""
    n = ACFG["buffer_size"]

    def one_flush(aggregator):
        eng = port_engine(data, jparams, aggregator=aggregator,
                          dropout=0.3)
        before = launch_counts()
        eng.run_flushes(1)
        assert launch_counts() == before
        return eng

    spy = _Recording(seed=0)
    secure, clear = one_flush(spy), one_flush(None)
    assert any((w == 0).any() for w in spy.weights)   # a passenger rode
    assert secure.t_sim == clear.t_sim
    assert secure.arrivals == clear.arrivals
    err = max(float((a - b).abs().max()) for (_, a), (_, b) in
              zip(tree_flatten(clear.params), tree_flatten(secure.params)))
    assert err <= roundtrip_tol(n)
    assert secure.meter.totals["secure"] > 0.0
    assert secure.meter.totals["params"] > 0.0

    jeng = jax_engine(data, dropout=0.3,
                      aggregator=jget_aggregator(secure=True, impl="ref",
                                                 seed=0))
    jeng.run_flushes(1)
    assert secure.t_sim == jeng.t_sim
    for stream in ("params", "secure"):
        assert secure.meter.totals[stream] == jeng.meter.totals[stream]
    assert secure.meter.state_dict() == jeng.meter.state_dict()
    _assert_tree_close(secure.params, jeng.params, rtol=0,
                       atol=1e-5 + 2.0 ** -16)


def test_client_updates_leave_globals_and_bill_the_downlink(data, jparams):
    tr = port_trainer()
    state = {"params": jax_to_torch(jparams, "cpu"), "round": 0}
    cohort = port_pop(data).gather(np.arange(K))
    per_client, m = tr.client_updates(state, cohort,
                                      np.array([1, 1, 0.5, 1], np.float32))
    assert tr.meter.totals["params"] == m["wire/params_bytes"]
    pb = sum(x.numel() * 4 for _, x in tree_flatten(
        {"tail": state["params"]["tail"],
         "prompt": state["params"]["prompt"]}))
    assert m["wire/params_bytes"] == K * pb and m["cohort/active"] == 0.0
    assert per_client["prompt"].shape[0] == K
    assert not per_client["prompt"].requires_grad
    with pytest.raises(ValueError) as te:
        port_trainer(return_client=False).client_updates(state, cohort)
    with pytest.raises(ValueError) as je:
        jax_trainer(return_client=False).client_updates(
            {"params": jparams, "round": 0}, cohort)
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------- launcher
FLAGS = ["--reduced", "--layers", "3", "--dataset", "cifar10-syn",
         "--clients", "8", "--k", "3", "--samples", "96", "--image-hw", "32",
         "--batch-size", "8", "--local-epochs", "1", "--prompt-len", "4",
         "--rounds", "2", "--async-buffer", "4", "--regime", "wan",
         "--dropout-rate", "0.2", "--seed", "0", "--ckpt-every", "1"]
LOG = "vit-base_sfprompt_cifar10-syn.jsonl"


def test_async_launcher_matches_jax_launcher(tmp_path, monkeypatch,
                                             capsys):
    """`launch.train --async-buffer 4` on the CPU from the JAX launcher's
    initial params: every JSONL record, less `wall_s`, equals the JAX
    launcher's (the eval floats within 1e-5), and so do the checkpointed
    meter, ledger and clock."""
    jcfg = jget_config("vit-base").reduced(n_layers=3)
    jm = JSplitModel(jcfg, JSplitConfig(head_cycles=1, tail_cycles=1,
                                        prompt_len=4, prune_gamma=0.5,
                                        local_epochs=1))
    init = jm.init(jax.random.PRNGKey(0))
    monkeypatch.setattr(
        SFPromptTrainer, "init",
        lambda self, gen: {"params": jax_to_torch(init, "cpu"), "round": 0})
    out = str(tmp_path / "port")
    engine = ttrain.main(FLAGS + ["--out", out, "--device", "cpu"])
    assert isinstance(engine, AsyncRoundEngine) and engine.version == 2
    printed = capsys.readouterr().out
    assert f"async: 2 flush(es) over {engine.t_sim:.1f} simulated s" in \
        printed
    jout = str(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["train"] + FLAGS + ["--out", jout])
    jtrain.main()
    recs = []
    for d in (out, jout):
        with open(os.path.join(d, LOG)) as f:
            recs.append([json.loads(line) for line in f])
    port, ref = recs
    assert len(port) == len(ref) == 2
    for p, j in zip(port, ref):
        assert set(p) == set(j)
        for key in p:
            if key.startswith("eval_"):
                np.testing.assert_allclose(p[key], j[key], **TOL)
            elif key != "wall_s":
                assert p[key] == j[key], key
    run = jload_latest(os.path.join(jout, "ckpt"))
    assert _flatten_numeric(run["meter"]) == engine.meter.state_dict()
    assert float(run["t_sim"]) == engine.t_sim
    jled = run["ledger"]
    for key, v in engine.ledger.state_dict().items():
        np.testing.assert_array_equal(v, jled[key])
