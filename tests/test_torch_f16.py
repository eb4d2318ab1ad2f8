"""The port at f16 against the JAX package at f16, on the CPU: each
kernel's plain version fed the same f16 values as the JAX op (run as
tests/test_kernels.py runs it: the Pallas kernel in interpret mode, or its
reference). The kernels take f16 as their JAX kernels do (each reads it
with astype(f32) and writes the dtype the JAX kernel writes); the card
cases are in tests/test_torch_cuda.py.

Inputs are f32 numpy arrays rounded to f16 in each package (both round to
nearest even), so both packages see the same f16 values. f16 keeps 11
significant bits and both packages round each output once, so f16 outputs
are held within 2e-3 (about two f16 ulps near 1)."""
import torch

torch.set_num_threads(2)

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
from repro_torch.kernels.el2n.ops import el2n_scores  # noqa: E402
from repro_torch.kernels.flash_attention.decode import (  # noqa: E402
    decode_attention, paged_decode_attention)
from repro_torch.kernels.flash_attention.ops import \
    prefill_attention  # noqa: E402
from repro_torch.kernels.mamba2_scan.ops import mamba2_scan  # noqa: E402
from repro_torch.kernels.quant.ops import (dequantize_int8,  # noqa: E402
                                           quantize_int8)
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan  # noqa: E402
from repro_torch.kernels.secure_mask.ops import masked_encode  # noqa: E402

import test_torch_bf16 as tbf16  # noqa: E402
import test_torch_paged as tpaged  # noqa: E402

F16_TOL = dict(atol=2e-3, rtol=2e-3)
EL2N_TOL = dict(atol=1e-5, rtol=1e-5)
STATE_TOL = tbf16.STATE_TOL          # the scans' f32 state, as at bf16


def _h(a):
    """The same f16 values in both packages."""
    return (torch.from_numpy(np.asarray(a, np.float32)).half(),
            jnp.asarray(a, jnp.float32).astype(jnp.float16))


def _f32(t):
    """A torch or JAX array as f32 numpy (f16 widens exactly)."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t.astype(jnp.float32))


def _pair(a, dtype):
    """`a` in both packages, as f16 or as f32."""
    if dtype == "f16":
        return _h(a)
    return torch.from_numpy(a), jnp.asarray(a)


@pytest.mark.parametrize("shape", [(37, 160), (3, 5120)])
def test_quant_f16_bit_equal_to_jax(shape):
    """f16 x: payload and scales == the jitted JAX op (reference and
    Pallas interpret); the payload dequantized to f16 == JAX's."""
    rng = np.random.default_rng(sum(shape) + 1)
    x = rng.standard_normal(shape) * rng.exponential(3.0, (shape[0], 1))
    tx, jx = _h(x)
    u = rng.random(shape).astype(np.float32)
    v, s = quantize_int8(tx, torch.from_numpy(u))
    for impl in ("ref", "interpret"):
        jv, js = jquantize(jx, jnp.asarray(u), impl=impl)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv), impl)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js), impl)
        out = dequantize_int8(v, s, dtype=torch.float16)
        assert out.dtype == torch.float16
        np.testing.assert_array_equal(_f32(out), _f32(jdequantize(
            jv, js, dtype=jnp.float16, impl=impl)), impl)


@pytest.mark.parametrize("causal", [True, False])
def test_prefill_f16_matches_jax_kernel(causal):
    B, S, Hq, Hkv, Dh = 1, 45, 10, 2, 16
    rng = np.random.default_rng(S + causal + 1)
    (tq, jq), (tk, jk), (tv, jv) = (
        _h(rng.standard_normal((B, S, h, Dh))) for h in (Hq, Hkv, Hkv))
    got = prefill_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.float16
    want = jflash(jq, jk, jv, causal=causal, impl="interpret", block_q=16,
                  block_kv=16)
    assert want.dtype == jnp.float16
    np.testing.assert_allclose(_f32(got), _f32(want), **F16_TOL)


@pytest.mark.parametrize("kv_dtype", ["f32", "f16"])
def test_decode_f16_matches_jax_kernel(kv_dtype):
    """q f16 over an f32 cache (the engines' pairing) and over an f16 one,
    on ragged, empty and ring-wrapped slots."""
    q, k, v, qp, kvp = tbf16._decode_inputs()
    tq, jq = _h(q)
    (tk, jk), (tv, jv) = _pair(k, kv_dtype), _pair(v, kv_dtype)
    got = decode_attention(tq, tk, tv, q_positions=torch.from_numpy(qp),
                           kv_positions=torch.from_numpy(kvp),
                           sliding_window=12)
    assert got.dtype == torch.float16
    want = jdecode(jq, jk, jv, q_positions=jnp.asarray(qp),
                   kv_positions=jnp.asarray(kvp), sliding_window=12,
                   impl="interpret")
    assert want.dtype == jnp.float16
    np.testing.assert_allclose(_f32(got), _f32(want), **F16_TOL)


@pytest.mark.parametrize("kv_dtype", ["f32", "f16"])
def test_paged_decode_f16_matches_jax_kernel(kv_dtype):
    B, nb, page, Hq, Hkv, Dh = 3, 4, 8, 10, 2, 16
    q, kp, vp, tables, qpos, kvpos = tpaged._paged_inputs(
        46, B, nb, page, Hq, Hkv, Dh, [13, None, 32])
    tq, jq = _h(q)
    (tk, jk), (tv, jv) = _pair(kp, kv_dtype), _pair(vp, kv_dtype)
    got = paged_decode_attention(
        tq, tk, tv, block_tables=torch.from_numpy(tables),
        q_positions=torch.from_numpy(qpos),
        kv_positions=torch.from_numpy(kvpos), sliding_window=6, softcap=15.0)
    assert got.dtype == torch.float16
    want = jpaged(jq, jk, jv, block_tables=jnp.asarray(tables),
                  q_positions=jnp.asarray(qpos),
                  kv_positions=jnp.asarray(kvpos), sliding_window=6,
                  softcap=15.0, impl="interpret")
    np.testing.assert_allclose(_f32(got), _f32(want), **F16_TOL)


def test_el2n_f16_matches_jax_kernel():
    """f16 logits: f32 EL2N and CE within 1e-5 of the JAX kernel
    (interpret) and of its one-pass XLA form."""
    rng = np.random.default_rng(12)
    N, V = 12, 300
    tl, jl = _h(3.0 * rng.standard_normal((N, V)))
    labels = rng.integers(0, V, N).astype(np.int32)
    e, c = el2n_scores(tl, torch.from_numpy(labels))
    assert e.dtype == c.dtype == torch.float32
    for impl in ("interpret", "fused"):
        je, jc = jel2n(jl, jnp.asarray(labels), impl=impl, block_n=4,
                       block_v=128)
        np.testing.assert_allclose(e.numpy(), np.asarray(je), **EL2N_TOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **EL2N_TOL)


def test_masked_encode_f16_bit_equal_to_jax():
    rng = np.random.default_rng(6)
    n = 896
    tx, jx = _h(rng.standard_normal(n) * 3)
    seeds = np.array([0, 0xFFFFFFFF, 12345], np.uint32)
    signs = np.array([1, -1, 1], np.int32)
    got = masked_encode(tx, torch.from_numpy(seeds.astype(np.int64)),
                        torch.from_numpy(signs))
    want = jmask.masked_encode(jx, jnp.asarray(seeds), jnp.asarray(signs),
                               impl="ref")
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(want))


@pytest.mark.parametrize("T", [1, 40])
def test_mamba2_f16_layer_mix_matches_jax_kernel(T):
    """The layer's dtype mix at f16: x, B and C f16, dt, A and the state
    f32; y f16, the state f32; decode (T 1) and prefill."""
    rng = np.random.default_rng(3 + T)
    B, H, P, N, G = 2, 4, 8, 8, 2
    tx, jx = _h(rng.standard_normal((B, T, H, P)))
    tb, jb = _h(rng.standard_normal((B, T, G, N)))
    tc, jc = _h(rng.standard_normal((B, T, G, N)))
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    y, h = mamba2_scan(tx, torch.from_numpy(dt), torch.from_numpy(A), tb, tc,
                       torch.from_numpy(h0))
    assert y.dtype == torch.float16 and h.dtype == torch.float32
    jy, jh = jmamba2(jx, jnp.asarray(dt), jnp.asarray(A), jb, jc,
                     jnp.asarray(h0), impl="interpret", chunk=min(T, 16))
    assert jy.dtype == jnp.float16
    np.testing.assert_allclose(_f32(y), _f32(jy), **F16_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **STATE_TOL)


def test_rwkv6_f16_matches_jax_kernel():
    """Every input f16 but the f32 state, as tests/test_kernels.py:105 runs
    the JAX kernel at bf16."""
    rng = np.random.default_rng(5)
    B, T, H, K = 2, 40, 2, 16
    (tr, jr), (tk, jk), (tv, jv) = (
        _h(rng.standard_normal((B, T, H, K))) for _ in range(3))
    tw, jw = _h(-np.exp(rng.standard_normal((B, T, H, K))))
    tu, ju = _h(rng.standard_normal((H, K)))
    s0 = rng.standard_normal((B, H, K, K)).astype(np.float32)
    y, S = rwkv6_scan(tr, tk, tv, tw, tu, torch.from_numpy(s0))
    assert y.dtype == torch.float16 and S.dtype == torch.float32
    jy, jS = jrwkv6(jr, jk, jv, jw, ju, jnp.asarray(s0), impl="interpret",
                    chunk=16)
    np.testing.assert_allclose(_f32(y), _f32(jy), **F16_TOL)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), **STATE_TOL)
