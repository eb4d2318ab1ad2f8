"""The port's ServeEngine against the JAX ServeEngine on bridged weights
and bank: continuous batching with mid-flight joins and slot reuse over the
trace of tests/test_serve.py, tenant isolation, metered bytes against the
analytical model, stats replay, the launcher, and the device rule."""
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import SplitConfig as JSplitConfig  # noqa: E402
from repro.core import SplitModel as JSplitModel  # noqa: E402
from repro.runtime import WireSpec as JWireSpec  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import TenantBank as JTenantBank  # noqa: E402
from repro_torch.bridge import bank_from_arrays, jax_to_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import SplitConfig, SplitModel  # noqa: E402
from repro_torch.core.comm import serve_comm_breakdown  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.runtime import WireSpec  # noqa: E402
from repro_torch.serve import (Request, ServeConfig,  # noqa: E402
                               ServeEngine, WorkloadConfig,
                               synthetic_requests)

MAX_SEQ = 48
PROMPT_LEN = 4
TOL = dict(atol=1e-5, rtol=1e-5)

# the trace of tests/test_serve.py: 4 requests, 3 tenants, 2 slots —
# queueing, mid-flight joins and slot reuse
REQS = [
    Request(rid=0, tenant=0, tokens=np.arange(9, dtype=np.int32) % 128,
            max_new=5, arrival=0),
    Request(rid=1, tenant=1, tokens=(np.arange(14, dtype=np.int32) * 3)
            % 128, max_new=4, arrival=0),
    Request(rid=2, tenant=2, tokens=(np.arange(6, dtype=np.int32) * 7)
            % 128, max_new=6, arrival=2),
    Request(rid=3, tenant=1, tokens=(np.arange(11, dtype=np.int32) * 5)
            % 128, max_new=3, arrival=3),
]


def _cfg(get):
    return get("qwen2.5-14b").reduced(n_layers=3, d_model=64, d_ff=128,
                                      vocab_size=128)


def jax_bank(params, n_tenants=3, jitter=0.2):
    """Distinct per-tenant (tail, prompt), as tests/test_serve.py builds."""
    tails, prompts = [], []
    for t in range(n_tenants):
        key = jax.random.fold_in(jax.random.PRNGKey(7), t)
        leaves, treedef = jax.tree.flatten(params["tail"])
        ks = jax.random.split(key, len(leaves) + 1)
        tails.append(jax.tree.unflatten(treedef, [
            x + jitter * jax.random.normal(k, x.shape, x.dtype)
            for x, k in zip(leaves, ks[:-1])]))
        prompts.append(params["prompt"] + jitter * jax.random.normal(
            ks[-1], params["prompt"].shape))
    return JTenantBank.from_lists(tails, prompts)


def build(wire="fp32", n_tenants=3):
    """(JAX model, params, bank), (port model, params, bank) on the same
    weights."""
    split = dict(head_cycles=1, tail_cycles=1, prompt_len=PROMPT_LEN)
    jm = JSplitModel(_cfg(jget_config), JSplitConfig(**split),
                     JWireSpec.make(wire))
    tm = SplitModel(_cfg(get_config), SplitConfig(**split),
                    WireSpec.make(wire))
    params = jm.init(jax.random.PRNGKey(0))
    jb = jax_bank(params, n_tenants)
    return ((jm, params, jb),
            (tm, jax_to_torch(params, "cpu"),
             bank_from_arrays(jb.tails, jb.prompts, "cpu")))


def port_engine(tm, tparams, tbank, **cfg):
    return ServeEngine(tm, tparams, tbank,
                       ServeConfig(max_seq=MAX_SEQ, **cfg),
                       collect_logits=True, device="cpu")


@pytest.mark.parametrize("wire", ["fp32", "int8"])
@pytest.mark.parametrize("decode_block", [1, 4])
def test_engine_matches_jax_engine(wire, decode_block):
    """Tokens ==, per-step logits within 1e-5 and metered wire bytes ==."""
    (jm, params, jb), (tm, tparams, tbank) = build(wire)
    jeng = JServeEngine(jm, params, jb,
                        JServeConfig(n_slots=2, max_seq=MAX_SEQ,
                                     decode_block=decode_block),
                        collect_logits=True)
    want = jeng.run(REQS)
    got = port_engine(tm, tparams, tbank, n_slots=2,
                      decode_block=decode_block).run(REQS)
    assert got["n_finished"] == want["n_finished"] == len(REQS)
    w_by = {f.req.rid: f for f in want["finished"]}
    for f in got["finished"]:
        np.testing.assert_array_equal(f.tokens, w_by[f.req.rid].tokens)
        np.testing.assert_allclose(f.logits, w_by[f.req.rid].logits, **TOL)
    assert got["wire_bytes"] == want["wire_bytes"]
    for key in ("tokens_out", "decode_steps", "prefills", "occupancy"):
        assert got[key] == want[key], key


def test_tenant_isolation_mid_batch_join():
    """Tenant A's outputs are bit-identical whether or not tenant B's
    request joins the batch mid-flight."""
    _, (tm, tparams, tbank) = build()
    a = Request(rid=0, tenant=0,
                tokens=np.arange(8, dtype=np.int32), max_new=6, arrival=0)
    b = Request(rid=1, tenant=2,
                tokens=(np.arange(12, dtype=np.int32) * 11) % 128,
                max_new=4, arrival=2)

    def run(reqs):
        eng = port_engine(tm, tparams, tbank, n_slots=2, decode_block=2)
        return {f.req.rid: f for f in eng.run(reqs)["finished"]}

    alone = run([a])[0]
    joined = run([a, b])[0]
    np.testing.assert_array_equal(alone.tokens, joined.tokens)
    np.testing.assert_array_equal(alone.logits, joined.logits)


@pytest.mark.parametrize("wire", ["fp32", "bf16", "int8"])
def test_metered_bytes_match_analytical(wire):
    """Measured wire traffic vs the port's `serve_comm_breakdown` <= 5% per
    boundary (decode bytes counted per OCCUPIED slot only)."""
    _, (tm, tparams, tbank) = build(wire, n_tenants=2)
    wl = WorkloadConfig(n_requests=6, mean_interarrival=1.0,
                        prompt_choices=(6, 10), new_token_choices=(3, 5),
                        n_tenants=2, vocab_size=128, seed=3)
    reqs = synthetic_requests(wl)
    stats = port_engine(tm, tparams, tbank, n_slots=3,
                        decode_block=4).run(reqs)
    analytical = serve_comm_breakdown(
        tm.wire, d_model=tm.cfg.d_model, soft_prompt_len=PROMPT_LEN,
        requests=[(len(r.tokens), r.max_new) for r in reqs])
    for name, ref in analytical.items():
        got = stats["wire_bytes"][name]
        assert ref > 0
        assert abs(got - ref) / ref <= 0.05, (name, got, ref)
    assert stats["wire_per_token"]["total"] == pytest.approx(
        stats["wire_bytes"]["total"] / stats["tokens_out"])


def test_reset_stats_replays_trace_identically():
    _, (tm, tparams, tbank) = build()
    engine = port_engine(tm, tparams, tbank, n_slots=2)
    first = engine.run(REQS)
    snap1 = (engine.decode_steps, engine.tokens_out, engine.prefill_count,
             first["wire_bytes"]["total"])
    engine.reset_stats()
    assert engine.decode_steps == 0 and engine.tokens_out == 0
    second = engine.run(REQS)
    snap2 = (engine.decode_steps, engine.tokens_out, engine.prefill_count,
             second["wire_bytes"]["total"])
    assert snap1 == snap2
    toks1 = {f.req.rid: f.tokens.tolist() for f in first["finished"]}
    toks2 = {f.req.rid: f.tokens.tolist() for f in second["finished"]}
    assert toks1 == toks2
    engine.submit(REQS[0])
    engine.step()
    with pytest.raises(RuntimeError):
        engine.reset_stats()


def test_admission_control_and_validation():
    _, (tm, tparams, tbank) = build()
    engine = ServeEngine(tm, tparams, tbank,
                         ServeConfig(n_slots=1, max_seq=MAX_SEQ, max_queue=2),
                         device="cpu")
    mk = lambda rid: Request(rid=rid, tenant=0,
                             tokens=np.arange(4, dtype=np.int32),
                             max_new=2, arrival=0)
    assert engine.submit(mk(0)) and engine.submit(mk(1))
    assert not engine.submit(mk(2))          # queue full -> rejected
    assert engine.rejected == 1
    with pytest.raises(ValueError):          # window overflow
        engine.submit(Request(rid=9, tenant=0,
                              tokens=np.zeros(MAX_SEQ, np.int32),
                              max_new=8, arrival=0))
    with pytest.raises(ValueError):          # unknown tenant
        engine.submit(Request(rid=10, tenant=99,
                              tokens=np.arange(4, dtype=np.int32),
                              max_new=2, arrival=0))


def test_launcher_main_on_cpu(capsys):
    stats = launch_serve.main([
        "--device", "cpu", "--requests", "5", "--slots", "3", "--tenants",
        "2", "--wire", "int8", "--prompt-choices", "6", "10",
        "--new-token-choices", "3", "5", "--decode-block", "4"])
    assert stats["n_finished"] == 5
    out = capsys.readouterr().out
    assert "tok/s" in out and "MB analytical" in out
    # tensor-parallel serving runs (tests/test_torch_mesh_tp.py), and since
    # slice H part 2 so does a recurrent family (tests/test_torch_mesh_
    # scans.py holds it against JAX): rank 0's stats come back
    stats = launch_serve.main(["--device", "cpu", "--mesh-model", "2",
                               "--arch", "rwkv6-3b", "--requests", "2",
                               "--prompt-choices", "6",
                               "--new-token-choices", "3"])
    assert stats["n_finished"] == 2


def test_engine_without_device_refuses_cpu_fallback():
    """The entry points default to CUDA; on a box without one they raise
    instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks a CUDA-less box")
    _, (tm, tparams, tbank) = build()
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(tm, tparams, tbank, ServeConfig(n_slots=2, max_seq=32))
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init_cache(2, seq_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--requests", "1"])
