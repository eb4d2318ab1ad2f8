"""The port's copies of JAX-free modules match their originals, and the
port imports neither JAX nor the JAX package."""
import torch

torch.set_num_threads(2)

import dataclasses  # noqa: E402
import re  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.data as jdata  # noqa: E402
import repro.models.config as jmc  # noqa: E402
from repro.fed import sampler as jsampler  # noqa: E402
from repro.fed import scheduler as jscheduler  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.runtime import codec as jcodec  # noqa: E402
from repro.runtime import meter as jmeter  # noqa: E402
from repro.serve import paging as jpaging  # noqa: E402
from repro.serve import workload as jworkload  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
import repro_torch.models.config as tmc  # noqa: E402
from repro_torch.fed import sampler as tsampler  # noqa: E402
from repro_torch.fed import scheduler as tscheduler  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.runtime import codec as tcodec  # noqa: E402
from repro_torch.runtime import meter as tmeter  # noqa: E402
from repro_torch.serve import paging as tpaging  # noqa: E402
from repro_torch.serve import workload as tworkload  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("cls", ["MLAConfig", "AttentionConfig", "MoEConfig",
                                 "Mamba2Config", "RWKV6Config",
                                 "EncoderConfig", "ModelConfig"])
def test_config_dataclass_fields(cls):
    jf = [(f.name, f.type, f.default) for f in
          dataclasses.fields(getattr(jmc, cls))]
    tf = [(f.name, f.type, f.default) for f in
          dataclasses.fields(getattr(tmc, cls))]
    assert jf == tf
    assert jmc.ATTN_KINDS == tmc.ATTN_KINDS
    assert jmc.SSM_KINDS == tmc.SSM_KINDS


@pytest.mark.parametrize("name", sorted(jconfigs._MODULES))
def test_every_config_and_its_reduction(name):
    j, t = jconfigs.get_config(name), tconfigs.get_config(name)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.param_count() == t.param_count()
    for kw in ({}, dict(n_layers=3, d_model=64, d_ff=128, vocab_size=128)):
        assert dataclasses.asdict(j.reduced(**kw)) == \
            dataclasses.asdict(t.reduced(**kw))
    assert jconfigs.ASSIGNED == tconfigs.ASSIGNED


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_synthetic_requests_identical(seed):
    kw = dict(n_requests=24, mean_interarrival=0.7, prompt_choices=(6, 32),
              new_token_choices=(3, 16), n_tenants=5, vocab_size=300,
              seed=seed)
    a = jworkload.synthetic_requests(jworkload.WorkloadConfig(**kw))
    b = tworkload.synthetic_requests(tworkload.WorkloadConfig(**kw))
    assert len(a) == len(b) == 24
    for ra, rb in zip(a, b):
        assert (ra.rid, ra.tenant, ra.max_new, ra.arrival) == \
            (rb.rid, rb.tenant, rb.max_new, rb.arrival)
        np.testing.assert_array_equal(ra.tokens, rb.tokens)
        assert ra.tokens.dtype == rb.tokens.dtype


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 7])
def test_data_copies_identical(seed):
    """The copied `data/` gives the same arrays as the original for the
    same seed: datasets, IID and Dirichlet partitions, client selection and
    stacking."""
    assert {k: dataclasses.asdict(v) for k, v in jdata.DATASETS.items()} \
        == {k: dataclasses.asdict(v) for k, v in tdata.DATASETS.items()}
    for name in sorted(jdata.DATASETS):
        _assert_trees_equal(
            jdata.synthetic_image_dataset(jdata.DATASETS[name], 40,
                                          seed=seed, image_hw=32),
            tdata.synthetic_image_dataset(tdata.DATASETS[name], 40,
                                          seed=seed, image_hw=32))
    _assert_trees_equal(jdata.synthetic_lm_dataset(12, 20, 300, seed=seed),
                        tdata.synthetic_lm_dataset(12, 20, 300, seed=seed))
    base = jdata.synthetic_image_dataset(jdata.DATASETS["cifar10-syn"], 90,
                                         seed=seed, image_hw=32)
    for part in ("iid_partition", "dirichlet_partition"):
        a = getattr(jdata, part)(base, 6, seed=seed)
        b = getattr(tdata, part)(base, 6, seed=seed)
        _assert_trees_equal(a, b)
        for r in range(3):
            ia = jdata.select_clients(6, 3, seed=seed, round_idx=r)
            ib = tdata.select_clients(6, 3, seed=seed, round_idx=r)
            np.testing.assert_array_equal(ia, ib)
            _assert_trees_equal(jdata.stack_clients(a, ia),
                                tdata.stack_clients(b, ib))


@pytest.mark.parametrize("kind", ["uniform", "weighted", "round_robin"])
def test_sampler_copy_identical(kind):
    """The copied `fed/sampler.py` draws the same cohorts as the original
    for the same seed, and its state round-trips the same."""
    assert jsampler.SAMPLER_KINDS == tsampler.SAMPLER_KINDS
    weights = np.linspace(1.0, 3.0, 40) if kind == "weighted" else None
    for seed in (0, 7, 2 ** 40 + 3):
        a = jsampler.ClientSampler(40, 6, kind=kind, seed=seed,
                                   weights=weights)
        b = tsampler.ClientSampler(40, 6, kind=kind, seed=seed,
                                   weights=weights)
        for r in range(12):
            np.testing.assert_array_equal(a.sample(r), b.sample(r))
        assert {k: int(v) for k, v in a.state_dict().items()} == \
            {k: int(v) for k, v in b.state_dict().items()}
        b.load_state_dict(a.state_dict())
    with pytest.raises(ValueError, match="sampler mismatch"):
        tsampler.ClientSampler(41, 6, kind=kind, weights=(
            np.ones(41) if kind == "weighted" else None)).load_state_dict(
            a.state_dict())


@pytest.mark.parametrize("late_mode", ["drop", "partial"])
def test_scheduler_copy_identical(late_mode):
    """The copied `fed/scheduler.py` gives the same plans as the original:
    latencies, deadlines, dropouts, late clients, participation."""
    assert jscheduler.LINK_REGIMES == tscheduler.LINK_REGIMES
    assert jscheduler.LATE_MODES == tscheduler.LATE_MODES
    for regime in sorted(jscheduler.LINK_REGIMES):
        kw = dict(seed=5, round_bytes_per_client=3e7,
                  round_flops_per_client=2e13)
        cfg = dict(regime=regime, dropout_rate=0.3, late_mode=late_mode,
                   deadline_factor=1.2)
        a = jscheduler.RoundScheduler(jscheduler.StragglerConfig(**cfg), **kw)
        b = tscheduler.RoundScheduler(tscheduler.StragglerConfig(**cfg), **kw)
        for r in range(6):
            cohort = np.arange(r, r + 8)
            pa, pb = a.plan(cohort, r), b.plan(cohort, r)
            for field in ("cohort", "latency_s", "transmit", "aggregate",
                          "dropped", "late"):
                np.testing.assert_array_equal(getattr(pa, field),
                                              getattr(pb, field))
            assert pa.deadline_s == pb.deadline_s
            assert pa.n_active == pb.n_active
        assert a.state_dict() == b.state_dict()
        b.load_state_dict(a.state_dict())
    full = [m.FullParticipationScheduler(seed=3).plan([4, 2, 9], 1)
            for m in (jscheduler, tscheduler)]
    np.testing.assert_array_equal(full[0].aggregate, full[1].aggregate)


def _drive_pool(mod, seed, n_ops=400):
    """A random alloc / alloc_many / share / free sequence (misuse
    included) on a small pool; returns everything observable after each
    operation: the result or the exception's type and message, the free
    list and the refcounts."""
    rng = np.random.default_rng(seed)
    pool = mod.PagePool(11, 4)
    held, log = [], []
    for _ in range(n_ops):
        op = rng.integers(0, 5)
        try:
            if op == 0:
                res = pool.alloc()
                held.append(res)
            elif op == 1:
                res = pool.alloc_many(int(rng.integers(0, 5)))
                held.extend(res)
            elif op == 2 and held:
                res = pool.share(held[rng.integers(len(held))])
                held.append(res)
            elif op == 3 and held:
                res = pool.free(held.pop(rng.integers(len(held))))
            else:   # misuse: reserved, unallocated or double frees
                res = pool.free(int(rng.integers(0, 11)))
        except (RuntimeError, ValueError) as exc:
            res = (type(exc).__name__, str(exc))
        log.append((op, res, pool.free_list(), pool.n_free, pool.n_used,
                    [pool.refcount(i) for i in range(11)]))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_pool_identical(seed):
    """The copied `serve/paging.py` behaves as the original on the same
    random operation sequence: results, exceptions, free lists and
    refcounts after every step."""
    assert _drive_pool(jpaging, seed) == _drive_pool(tpaging, seed)
    assert [(f.name, f.default) for f in
            dataclasses.fields(jpaging.PrefixEntry)] == \
        [(f.name, f.default) for f in dataclasses.fields(tpaging.PrefixEntry)]
    for name in ("NULL_PAGE", "SCRATCH_PAGE", "N_RESERVED"):
        assert getattr(jpaging.PagePool, name) == \
            getattr(tpaging.PagePool, name)
    with pytest.raises(tpaging.PagePoolExhausted):
        tpaging.PagePool(3, 1).alloc_many(2)


def test_traffic_meter_state_identical():
    meters = [jmeter.TrafficMeter(), tmeter.TrafficMeter()]
    for m in meters:
        m.absorb({"head_body": 1234.0, "body_tail": 99.5}, clients=3)
        m.absorb({"head_body": 7.25, "params": 4096.0, "bogus": 1.0})
        m.absorb_wall(server_busy_s=1.5, client_compute_s=2.0, wire_s=0.5,
                      span_s=2.5)
    a, b = meters
    assert a.state_dict() == b.state_dict()
    assert a.as_dict() == b.as_dict()
    assert a.per_token(17) == b.per_token(17)
    assert a.per_client_round() == b.per_client_round()
    assert a.overlap() == b.overlap()
    assert a.report() == b.report()
    c = tmeter.TrafficMeter()
    c.load_state_dict(a.state_dict())
    assert c.state_dict() == a.state_dict()
    assert jmeter.MB == tmeter.MB


@pytest.mark.parametrize("name", ["fp32", "bf16", "int8", "raw"])
def test_codec_payload_nbytes(name):
    j, t = jcodec.get_codec(name), tcodec.get_codec(name)
    for shape in [(1, 1, 64), (3, 17, 5120), (8, 1, 5120), (7,), (2, 9)]:
        assert j.payload_nbytes(shape) == t.payload_nbytes(shape), shape
        assert j.bytes_per_float(shape) == t.bytes_per_float(shape), shape
    assert j.stochastic == t.stochastic


def test_tracer_records_identical_without_times():
    recs = []
    for mod in (jtrace, ttrace):
        tr = mod.make_tracer("step", capacity=8)
        with tr.span("outer", a=1) as sp:
            tr.event("inner", level=2, b=2.5)
            sp.set(c="x")
            with tr.span("skipped", level=3):
                pass
        tr.event_at("sim", 1.25, d=4)
        tr.span_at("lane", 0.5, 2.0, lane=3)
        for i in range(10):
            tr.event("ring", i=i)
        recs.append((mod.strip_times(tr.records()), tr.dropped,
                     mod.sum_stream(tr.records(), "ring", "i"),
                     mod.to_jsonl(mod.strip_times(tr.records()))))
        assert mod.make_tracer("off") is mod.NOOP
    assert recs[0][0] == recs[1][0]
    assert recs[0][1:] == recs[1][1:]
    assert jtrace.LEVELS == ttrace.LEVELS


@pytest.mark.parametrize("module", ["metrics.py", "export.py"])
def test_obs_registry_and_exporters_copied_byte_for_byte(module):
    """`obs/metrics.py` and `obs/export.py` import only the standard
    library: the port's are the JAX package's files, byte for byte."""
    jax_file = ROOT / "src" / "repro" / "obs" / module
    port_file = ROOT / "src" / "repro_torch" / "obs" / module
    assert port_file.read_bytes() == jax_file.read_bytes()
    assert not re.search(r"^\s*(?:import|from)\s+(?!__future__|typing|json|"
                         r"bisect)\w", port_file.read_text(), re.MULTILINE)


def test_obs_package_exports_the_same_names():
    import repro.obs as jobs
    import repro_torch.obs as tobs
    from repro.obs import export as jexport
    from repro_torch.obs import export as texport
    public = {n for n in dir(jobs) if not n.startswith("_")} - {
        "trace", "metrics", "export"}
    assert public <= set(dir(tobs))
    assert {n for n in dir(tobs) if not n.startswith("_")} - {
        "trace", "metrics", "export"} == public
    # the copies behave as the originals on the same records and snapshot
    recs = []
    for trace, export in ((jtrace, jexport), (ttrace, texport)):
        tr = trace.Tracer("step")
        with tr.span("round", cohort=2):
            tr.event("meter.absorb", head_body=64.0)
        tr.span_at("async.client", 0.5, 2.0, lane=4)
        events = export.chrome_trace(tr.records())["traceEvents"]
        recs.append(([{k: v for k, v in e.items() if k not in ("ts", "dur")}
                      for e in events],
                     export.prometheus_text({"a/b-c.d": 2, "x": "skip"})))
    assert recs[0][1] == recs[1][1] == "a_b_c_d 2.0\n"
    assert recs[0][0] == recs[1][0]


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|$)"
    r"|import_module\(\s*f?[\"'](?:jax|repro)\.", re.MULTILINE)


def test_port_imports_no_jax_and_no_repro():
    for bad in ("import jax.numpy as jnp", "from repro.core import X",
                "    import jax.profiler", "import repro.configs",
                'importlib.import_module(f"repro.configs.{m}")'):
        assert _FORBIDDEN.search(bad), bad
    assert not _FORBIDDEN.search("from repro_torch.core import X")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    names = {p.name for p in files}
    assert {"paging.py", "paged_engine.py", "protocol.py", "losses.py",
            "pruning.py", "local_update.py", "aggregation.py",
            "secure_agg.py", "optimizers.py", "schedules.py",
            "synthetic.py", "federated.py", "sampler.py", "scheduler.py",
            "population.py", "engine.py", "io.py", "train.py", "dp.py",
            "masking.py", "fixed_point.py"} <= names
    for kernel in ("el2n", "secure_mask"):
        assert (ROOT / "src" / "repro_torch" / "kernels" / kernel
                / "kernel.py") in files
    # the chunked plain version of the Mamba-2 scan (tests and chip_smoke)
    assert (ROOT / "src" / "repro_torch" / "kernels" / "mamba2_scan"
            / "ref.py") in files
    offenders = {str(p.relative_to(ROOT)): _FORBIDDEN.findall(p.read_text())
                 for p in files}
    assert {k: v for k, v in offenders.items() if v} == {}
