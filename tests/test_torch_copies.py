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
import repro.models.config as jmc  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.runtime import codec as jcodec  # noqa: E402
from repro.runtime import meter as jmeter  # noqa: E402
from repro.serve import workload as jworkload  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
import repro_torch.models.config as tmc  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.runtime import codec as tcodec  # noqa: E402
from repro_torch.runtime import meter as tmeter  # noqa: E402
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
    offenders = {str(p.relative_to(ROOT)): _FORBIDDEN.findall(p.read_text())
                 for p in files}
    assert {k: v for k, v in offenders.items() if v} == {}
