"""The port at bf16 against the JAX package at bf16, on the CPU: each
kernel's plain version fed the same bf16 values as the JAX op (run as
tests/test_kernels.py runs it: the Pallas kernel in interpret mode, or its
reference), both serving engines with `ServeConfig(dtype=bfloat16)` on
bridged weights, the dtype dispatch of the launch wrappers, the
embedding's gather-then-cast, and the recurrent families' bf16 refusal,
which mirrors the JAX engine's failure.

Inputs are f32 numpy arrays rounded to bf16 in each package (both round
to nearest even), so both packages see the same bf16 values."""
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.kernels.el2n.ops import el2n_scores as jel2n  # noqa: E402
from repro.kernels.flash_attention.decode import \
    decode_attention as jdecode  # noqa: E402
from repro.kernels.flash_attention.decode import \
    paged_decode_attention as jpaged  # noqa: E402
from repro.kernels.flash_attention.ops import \
    flash_attention as jflash  # noqa: E402
from repro.kernels.mamba2_scan.ops import mamba2_scan as jmamba2  # noqa: E402
from repro.kernels.quant.ops import \
    dequantize_int8 as jdequantize  # noqa: E402
from repro.kernels.quant.ops import quantize_int8 as jquantize  # noqa: E402
from repro.kernels.rwkv6_scan.ops import rwkv6_scan as jrwkv6  # noqa: E402
from repro.kernels.secure_mask import ops as jmask  # noqa: E402
from repro.serve import PagedServeConfig as JPagedServeConfig  # noqa: E402
from repro.serve import PagedServeEngine as JPagedServeEngine  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve.steps import \
    make_batched_decode_step as jmake_decode  # noqa: E402
from repro.serve.steps import \
    make_tenant_prefill_step as jmake_prefill  # noqa: E402
from repro_torch.kernels import dtype_code, launch_counts  # noqa: E402
from repro_torch.kernels.el2n.kernel import el2n_fwd  # noqa: E402
from repro_torch.kernels.el2n.ops import el2n_scores  # noqa: E402
from repro_torch.kernels.flash_attention.decode import (  # noqa: E402
    decode_attention, decode_attention_fwd, paged_decode_attention,
    paged_decode_attention_fwd)
from repro_torch.kernels.flash_attention.kernel import \
    flash_attention_fwd  # noqa: E402
from repro_torch.kernels.flash_attention.ops import \
    prefill_attention  # noqa: E402
from repro_torch.kernels.mamba2_scan.kernel import mamba2_fwd  # noqa: E402
from repro_torch.kernels.mamba2_scan.ops import mamba2_scan  # noqa: E402
from repro_torch.kernels.quant.kernel import (dequantize_fwd,  # noqa: E402
                                              quantize_fwd)
from repro_torch.kernels.quant.ops import (dequantize_int8,  # noqa: E402
                                           quantize_int8)
from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_fwd  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan  # noqa: E402
from repro_torch.kernels.secure_mask.kernel import \
    masked_encode_fwd  # noqa: E402
from repro_torch.kernels.secure_mask.ops import masked_encode  # noqa: E402
from repro_torch.serve import (PagedServeConfig,  # noqa: E402
                               PagedServeEngine, ServeConfig, ServeEngine)
from repro_torch.serve.steps import forced_logits  # noqa: E402

import test_torch_paged as tpaged  # noqa: E402
import test_torch_recurrent_serve as trec  # noqa: E402
import test_torch_serve as tserve  # noqa: E402

BF16_TOL = dict(atol=2e-2, rtol=2e-2)   # tests/test_kernels.py's bf16 _tol
EL2N_TOL = dict(atol=1e-5, rtol=1e-5)
STATE_TOL = dict(atol=1e-3, rtol=1e-3)  # the scans' f32 state, as there


def _bf(a):
    """The same bf16 values in both packages."""
    return (torch.from_numpy(np.asarray(a, np.float32)).bfloat16(),
            jnp.asarray(a, jnp.float32).astype(jnp.bfloat16))


def _f32(t):
    """A torch or JAX array as f32 numpy (bf16 widens exactly)."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t.astype(jnp.float32))


# ---------------------------------------------------------------- kernels
@pytest.mark.parametrize("shape", [(37, 160), (3, 5120)])
def test_quant_bf16_bit_equal_to_jax(shape):
    """bf16 x: payload and scales == the jitted JAX op (reference and
    Pallas interpret); the payload dequantized to bf16 == JAX's."""
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape) * rng.exponential(3.0, (shape[0], 1))
    tx, jx = _bf(x)
    u = rng.random(shape).astype(np.float32)
    v, s = quantize_int8(tx, torch.from_numpy(u))
    for impl in ("ref", "interpret"):
        jv, js = jquantize(jx, jnp.asarray(u), impl=impl)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv), impl)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js), impl)
        out = dequantize_int8(v, s, dtype=torch.bfloat16)
        assert out.dtype == torch.bfloat16
        np.testing.assert_array_equal(_f32(out), _f32(jdequantize(
            jv, js, dtype=jnp.bfloat16, impl=impl)), impl)


@pytest.mark.parametrize("causal", [True, False])
def test_prefill_bf16_matches_jax_kernel(causal):
    B, S, Hq, Hkv, Dh = 1, 45, 10, 2, 16
    rng = np.random.default_rng(S + causal)
    (tq, jq), (tk, jk), (tv, jv) = (
        _bf(rng.standard_normal((B, S, h, Dh))) for h in (Hq, Hkv, Hkv))
    got = prefill_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    want = jflash(jq, jk, jv, causal=causal, impl="interpret", block_q=16,
                  block_kv=16)
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL)


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16"])
def test_decode_bf16_matches_jax_kernel(kv_dtype):
    """q bf16 over an f32 cache (the engines' case) and over a bf16 one."""
    q, k, v, qp, kvp = _decode_inputs()
    tq, jq = _bf(q)
    if kv_dtype == "bf16":
        (tk, jk), (tv, jv) = _bf(k), _bf(v)
    else:
        tk, jk, tv, jv = (torch.from_numpy(k), jnp.asarray(k),
                          torch.from_numpy(v), jnp.asarray(v))
    got = decode_attention(tq, tk, tv, q_positions=torch.from_numpy(qp),
                           kv_positions=torch.from_numpy(kvp),
                           sliding_window=12)
    assert got.dtype == torch.bfloat16
    want = jdecode(jq, jk, jv, q_positions=jnp.asarray(qp),
                   kv_positions=jnp.asarray(kvp), sliding_window=12,
                   impl="interpret")
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL)


def _decode_inputs():
    """Ragged, empty and ring-wrapped slots (tests/test_torch_kernels_plain
    DECODE_CASES' last but one)."""
    rng = np.random.default_rng(3)
    B, W, Hq, Hkv, Dh = 4, 64, 10, 2, 16
    q = rng.standard_normal((B, 1, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, W, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, W, Hkv, Dh)).astype(np.float32)
    kvp = np.full((B, W), -1, np.int32)
    qp = np.zeros((B,), np.int32)
    for b, n in enumerate([9, 0, 50, 64]):
        if b == 3:
            pos = np.arange(n, W + n, dtype=np.int32)
            kvp[b, pos % W] = pos
            qp[b] = W + n - 1
        elif n:
            kvp[b, :n] = np.arange(n)
            qp[b] = n - 1
    return q, k, v, qp, kvp


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16"])
def test_paged_decode_bf16_matches_jax_kernel(kv_dtype):
    B, nb, page, Hq, Hkv, Dh = 3, 4, 8, 10, 2, 16
    q, kp, vp, tables, qpos, kvpos = tpaged._paged_inputs(
        45, B, nb, page, Hq, Hkv, Dh, [13, None, 32])
    tq, jq = _bf(q)
    if kv_dtype == "bf16":
        (tk, jk), (tv, jv) = _bf(kp), _bf(vp)
    else:
        tk, jk, tv, jv = (torch.from_numpy(kp), jnp.asarray(kp),
                          torch.from_numpy(vp), jnp.asarray(vp))
    got = paged_decode_attention(
        tq, tk, tv, block_tables=torch.from_numpy(tables),
        q_positions=torch.from_numpy(qpos),
        kv_positions=torch.from_numpy(kvpos), sliding_window=6, softcap=15.0)
    assert got.dtype == torch.bfloat16
    want = jpaged(jq, jk, jv, block_tables=jnp.asarray(tables),
                  q_positions=jnp.asarray(qpos),
                  kv_positions=jnp.asarray(kvpos), sliding_window=6,
                  softcap=15.0, impl="interpret")
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL)


def test_el2n_bf16_matches_jax_kernel():
    """bf16 logits: f32 EL2N and CE within 1e-5 of the JAX kernel
    (interpret) and of its one-pass XLA form."""
    rng = np.random.default_rng(11)
    N, V = 12, 300
    tl, jl = _bf(3.0 * rng.standard_normal((N, V)))
    labels = rng.integers(0, V, N).astype(np.int32)
    e, c = el2n_scores(tl, torch.from_numpy(labels))
    assert e.dtype == c.dtype == torch.float32
    for impl in ("interpret", "fused"):
        je, jc = jel2n(jl, jnp.asarray(labels), impl=impl, block_n=4,
                       block_v=128)
        np.testing.assert_allclose(e.numpy(), np.asarray(je), **EL2N_TOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **EL2N_TOL)


def test_masked_encode_bf16_bit_equal_to_jax():
    rng = np.random.default_rng(5)
    n = 896
    tx, jx = _bf(rng.standard_normal(n) * 3)
    seeds = np.array([0, 0xFFFFFFFF, 12345], np.uint32)
    signs = np.array([1, -1, 1], np.int32)
    got = masked_encode(tx, torch.from_numpy(seeds.astype(np.int64)),
                        torch.from_numpy(signs))
    want = jmask.masked_encode(jx, jnp.asarray(seeds), jnp.asarray(signs),
                               impl="ref")
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(want))


def test_mamba2_bf16_layer_mix_matches_jax_kernel():
    """The layer's dtype mix (models/layers.py): x, B and C bf16, dt, A
    and the state f32; y in x's dtype, the state f32."""
    rng = np.random.default_rng(2)
    B, T, H, P, N, G = 2, 40, 4, 8, 8, 2
    tx, jx = _bf(rng.standard_normal((B, T, H, P)))
    tb, jb = _bf(rng.standard_normal((B, T, G, N)))
    tc, jc = _bf(rng.standard_normal((B, T, G, N)))
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    y, h = mamba2_scan(tx, torch.from_numpy(dt), torch.from_numpy(A), tb, tc,
                       torch.from_numpy(h0))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    jy, jh = jmamba2(jx, jnp.asarray(dt), jnp.asarray(A), jb, jc,
                     jnp.asarray(h0), impl="interpret", chunk=16)
    np.testing.assert_allclose(_f32(y), _f32(jy), **BF16_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **STATE_TOL)


def test_rwkv6_bf16_matches_jax_kernel():
    """Every input bf16 but the f32 state, as tests/test_kernels.py:105."""
    rng = np.random.default_rng(4)
    B, T, H, K = 2, 40, 2, 16
    (tr, jr), (tk, jk), (tv, jv) = (
        _bf(rng.standard_normal((B, T, H, K))) for _ in range(3))
    tw, jw = _bf(-np.exp(rng.standard_normal((B, T, H, K))))
    tu, ju = _bf(rng.standard_normal((H, K)))
    s0 = rng.standard_normal((B, H, K, K)).astype(np.float32)
    y, S = rwkv6_scan(tr, tk, tv, tw, tu, torch.from_numpy(s0))
    assert y.dtype == torch.bfloat16 and S.dtype == torch.float32
    jy, jS = jrwkv6(jr, jk, jv, jw, ju, jnp.asarray(s0), impl="interpret",
                    chunk=16)
    np.testing.assert_allclose(_f32(y), _f32(jy), **BF16_TOL)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), **STATE_TOL)


# ------------------------------------------------------------- dispatch
def test_dtype_codes_and_wrappers_dispatch():
    """The wrappers take f32, bf16 and f16 and refuse f64, naming the
    input; on the CPU a bf16 or f16 input passes the dtype check and is
    refused only for its device (the kernels run on the card: the card
    cases are in tests/test_torch_cuda.py), and no kernel launches."""
    assert dtype_code("x", torch.float32) == 0
    assert dtype_code("x", torch.bfloat16) == 1
    assert dtype_code("x", torch.float16) == 2
    q16 = torch.zeros((1, 1, 2, 8))
    pos = torch.zeros((1,), dtype=torch.int32)

    def calls(dt):
        x, q = torch.zeros((2, 8), dtype=dt), q16.to(dt)
        return [
            lambda: quantize_fwd(x, torch.full((2, 8), 0.5)),
            lambda: dequantize_fwd(torch.zeros((2, 8), dtype=torch.int8),
                                   torch.ones((2, 1)), dt),
            lambda: flash_attention_fwd(q, q, q, causal=True,
                                        sliding_window=None, softcap=None,
                                        scale=1.0, kv_len=1),
            lambda: decode_attention_fwd(q, q, q, pos, pos[:, None],
                                         scale=1.0, sliding_window=None,
                                         softcap=None),
            lambda: paged_decode_attention_fwd(
                q, q, q, pos[:, None], pos, pos[:, None], scale=1.0,
                sliding_window=None, softcap=None),
            lambda: el2n_fwd(x, torch.zeros((2,), dtype=torch.int32)),
            lambda: masked_encode_fwd(x.view(-1), pos, pos + 1, n=16,
                                      frac_bits=16),
            lambda: mamba2_fwd(q, torch.ones((1, 1, 2)), -torch.ones((2,)),
                               torch.zeros((1, 1, 1, 8)),
                               torch.zeros((1, 1, 1, 8))),
            lambda: rwkv6_fwd(q, q, q, q, x),
        ]
    before = launch_counts()
    for call in calls(torch.float64):
        with pytest.raises(ValueError,
                           match="float32, bfloat16 or float16"):
            call()
    for dt in (torch.bfloat16, torch.float16):
        for call in calls(dt):
            with pytest.raises(ValueError, match="CUDA"):
                call()
    assert launch_counts() == before


# -------------------------------------------------------------- engines
def _bf16_gap_rule(jm, params, jb, tm, tparams, tbank, reqs, max_seq):
    """The gap rule: every request teacher-forced through the step
    functions on the JAX bf16 run's greedy tokens, in the JAX package at
    bf16 and at f32 and in the port at bf16. The mean |port_bf16 -
    JAX_bf16| over every logit of the prefill token and each decode step
    may not exceed the mean |JAX_bf16 - JAX_f32| on the same requests.
    Returns (port gap, bf16-vs-f32 gap) as arrays."""
    shared = {"head": params["head"], "body": params["body"]}
    tshared = {"head": tparams["head"], "body": tparams["body"]}

    steps = {dt: (jax.jit(jmake_prefill(jm, dtype=dt)),
                  jax.jit(jmake_decode(jm, dtype=dt)))
             for dt in (jnp.bfloat16, jnp.float32)}

    def jax_forced(dtype, req, tokens):
        prefill, decode = steps[dtype]
        tok, logits, cache, _ = prefill(
            shared, jb.tail(req.tenant), jb.prompt(req.tenant),
            {"tokens": jnp.asarray(np.asarray(req.tokens)[None])},
            jm.blank_slot_cache(max_seq))
        rows, own = [np.asarray(logits[0])], [int(tok[0])]
        pos = len(req.tokens) + jm.split.prompt_len
        for t in range(req.max_new - 1):
            feed = own[-1] if tokens is None else tokens[t]
            tok, logits, cache, _ = decode(
                shared, jb.tails, jnp.asarray([req.tenant], jnp.int32),
                jnp.asarray([feed], jnp.int32), jnp.asarray([pos], jnp.int32),
                jnp.asarray([True]), cache)
            rows.append(np.asarray(logits[0]))
            own.append(int(tok[0]))
            pos += 1
        return np.stack(rows), own

    gaps, ref_gaps = [], []
    for req in reqs:
        jbf, toks = jax_forced(jnp.bfloat16, req, None)
        jf32, _ = jax_forced(jnp.float32, req, toks)
        tbf = forced_logits(tm, tshared, tbank, req, toks,
                            dtype=torch.bfloat16, max_seq=max_seq,
                            device="cpu")
        assert np.isfinite(tbf).all()
        gaps.append(np.abs(tbf - jbf).ravel())
        ref_gaps.append(np.abs(jbf - jf32).ravel())
    gap, ref = np.concatenate(gaps), np.concatenate(ref_gaps)
    assert gap.mean() <= ref.mean(), (gap.mean(), ref.mean())
    return gap, ref


def test_dense_engine_bf16_matches_jax_engine():
    """The reduced Qwen of tests/test_torch_serve.py on the int8 wire at
    bf16: wire bytes and counters == the JAX engine's; the gap rule."""
    (jm, params, jb), (tm, tparams, tbank) = tserve.build("int8")
    kw = dict(n_slots=2, max_seq=tserve.MAX_SEQ, decode_block=2)
    want = JServeEngine(jm, params, jb, JServeConfig(
        dtype=jnp.bfloat16, **kw)).run(tserve.REQS)
    got = ServeEngine(tm, tparams, tbank, ServeConfig(
        dtype=torch.bfloat16, **kw), device="cpu").run(tserve.REQS)
    assert got["n_finished"] == want["n_finished"] == len(tserve.REQS)
    assert got["wire_bytes"] == want["wire_bytes"]
    for key in ("tokens_out", "decode_steps", "prefills", "occupancy"):
        assert got[key] == want[key], key
    _bf16_gap_rule(jm, params, jb, tm, tparams, tbank, tserve.REQS,
                   tserve.MAX_SEQ)


def test_paged_engine_bf16_matches_jax_and_dense():
    """GQA 5 of tests/test_torch_paged.py at bf16 with a shared prefix and
    chunked prefill: wire bytes and every page counter == the JAX paged
    engine's. Without them the port's paged engine equals its dense engine
    at bf16 bit for bit, so the gap rule, held by the dense steps on this
    model, holds for the paged engine's logits too."""
    d = tpaged._build("gqa5")
    kw = dict(n_slots=3, max_seq=tpaged.MAX_SEQ, decode_block=2,
              page_size=tpaged.PAGE)
    chunked = dict(kw, shared_prefix=tpaged.PREFIX, prefill_chunk=3)
    want = JPagedServeEngine(d["jm"], d["params"], d["jb"], JPagedServeConfig(
        dtype=jnp.bfloat16, **chunked)).run(tpaged.REQS_HIT)
    got = PagedServeEngine(d["tm"], d["tparams"], d["tbank"], PagedServeConfig(
        dtype=torch.bfloat16, **chunked), device="cpu").run(tpaged.REQS_HIT)
    assert got["wire_bytes"] == want["wire_bytes"]
    for key in tpaged.COUNTERS:
        assert got[key] == want[key], key
    dense = ServeEngine(d["tm"], d["tparams"], d["tbank"], ServeConfig(
        n_slots=3, max_seq=tpaged.MAX_SEQ, decode_block=2,
        dtype=torch.bfloat16), collect_logits=True,
        device="cpu").run(tpaged.REQS)
    paged = PagedServeEngine(d["tm"], d["tparams"], d["tbank"],
                             PagedServeConfig(dtype=torch.bfloat16, **kw),
                             collect_logits=True,
                             device="cpu").run(tpaged.REQS)
    by = {f.req.rid: f for f in dense["finished"]}
    for f in paged["finished"]:
        np.testing.assert_array_equal(f.tokens, by[f.req.rid].tokens)
        np.testing.assert_array_equal(f.logits, by[f.req.rid].logits)
    assert paged["wire_bytes"] == dense["wire_bytes"]
    _bf16_gap_rule(d["jm"], d["params"], d["jb"], d["tm"], d["tparams"],
                   d["tbank"], tpaged.REQS, tpaged.MAX_SEQ)


def test_bf16_prefill_head_gathers_then_casts():
    """The embedding gathers its rows, then casts them to bf16: the head's
    output is bit-identical to the old form, which cast the whole table
    first (a table already at bf16 gathers exactly that)."""
    _, (tm, tparams, _) = tserve.build("fp32")
    toks = torch.from_numpy(tserve.REQS[1].tokens[None])
    head = tparams["head"]
    cast_first = dict(head, embed=dict(
        head["embed"], tok=head["embed"]["tok"].bfloat16()))
    outs = [tm.head_fwd(h, None, {"tokens": toks}, mode="prefill",
                        dtype=torch.bfloat16)["smashed"]
            for h in (head, cast_first)]
    assert outs[0].dtype == torch.bfloat16
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("arch", trec.ARCHS)
def test_recurrent_families_refuse_bf16_as_jax_fails(arch):
    """At bf16 the JAX engine fails on Mamba-2 and RWKV-6 blocks (the scan
    carry's f32 state meets bf16 activations); the port's engines refuse
    them at construction and name that failure. f32 still serves."""
    jm, tm, params, tparams = trec.build(arch)
    jb = trec.jax_bank(params)
    from repro_torch.bridge import bank_from_arrays
    tbank = bank_from_arrays(jb.tails, jb.prompts, "cpu")
    with pytest.raises(TypeError, match="carry"):
        JServeEngine(jm, params, jb, JServeConfig(
            n_slots=2, max_seq=trec.MAX_SEQ,
            dtype=jnp.bfloat16)).run(trec.REQS[:1])
    with pytest.raises(ValueError, match="scan-carry TypeError"):
        ServeEngine(tm, tparams, tbank, ServeConfig(
            n_slots=2, max_seq=trec.MAX_SEQ, dtype=torch.bfloat16),
            device="cpu")
    with pytest.raises(ValueError, match="paged serving unsupported"):
        PagedServeEngine(tm, tparams, tbank, PagedServeConfig(
            n_slots=2, max_seq=trec.MAX_SEQ, page_size=8,
            dtype=torch.bfloat16), device="cpu")
    ServeEngine(tm, tparams, tbank, ServeConfig(n_slots=2,
                                                max_seq=trec.MAX_SEQ),
                device="cpu")
