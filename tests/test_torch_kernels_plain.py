"""The port's plain kernel versions against the JAX package's kernels.

The JAX side runs its Pallas kernels as its own tests do on the CPU
(impl="interpret"), plus its jnp references; inputs and noise come from
numpy and are fed to both packages. No port kernel may launch on CPU
tensors."""
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.kernels.el2n.ops import el2n_scores as jel2n  # noqa: E402
from repro.kernels.flash_attention import ref as jref  # noqa: E402
from repro.kernels.flash_attention.decode import \
    decode_attention as jdecode  # noqa: E402
from repro.kernels.flash_attention.ops import \
    flash_attention as jflash  # noqa: E402
from repro.kernels.quant.ops import dequantize_int8 as jdequantize  # noqa: E402
from repro.kernels.quant.ops import quantize_int8 as jquantize  # noqa: E402
from repro.runtime.codec import get_codec as jget_codec  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.el2n import ref as tel2n_ref  # noqa: E402
from repro_torch.kernels.el2n.ops import el2n_scores  # noqa: E402
from repro_torch.kernels.flash_attention.decode import (  # noqa: E402
    decode_attention, grouped_decode)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention, prefill_attention)
from repro_torch.kernels.quant import ref as tquant_ref  # noqa: E402
from repro_torch.kernels.quant.ops import (dequantize_int8,  # noqa: E402
                                           quantize_int8)
from repro_torch.runtime.codec import get_codec  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------------ quant
@pytest.mark.parametrize("shape", [(37, 160), (8, 64), (3, 5120)])
@pytest.mark.parametrize("noise", ["half", "uniform"])
def test_quant_plain_bit_equal_to_jax(shape, noise):
    """Payload and scales bit-equal to the JAX op, through its jitted jnp
    reference and through the Pallas kernel in interpret mode (D = 160 and
    64 are padded to 128 lanes there)."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape)
         * rng.exponential(3.0, (shape[0], 1))).astype(np.float32)
    x[0, :5] = 0.0
    u = (np.float32(0.5) if noise == "half"
         else rng.random(shape).astype(np.float32))
    v, s = quantize_int8(_t(x), _t(u))
    for impl in ("ref", "interpret"):
        jv, js = jquantize(jnp.asarray(x), jnp.asarray(u), impl=impl)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv), impl)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js), impl)
    out = dequantize_int8(v, s)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jdequantize(jv, js, impl="ref")))


def test_quant_zero_row_and_clip():
    x = np.zeros((2, 10), np.float32)
    x[1] = np.linspace(-3, 3, 10)
    v, s = tquant_ref.quantize(_t(x), 0.5)
    assert float(s[0, 0]) == np.float32(1e-8)
    assert v.numpy()[0].tolist() == [0] * 10
    assert v.numpy()[1].min() == -127 and v.numpy()[1].max() == 127


# ------------------------------------------------------------ prefill
PREFILL_CASES = [
    # (B, Sq, Hq, Hkv, Dh, causal, window, softcap)
    (2, 37, 4, 4, 32, True, None, None),     # ragged Sq, G = 1
    (1, 45, 10, 2, 16, True, None, None),    # G = 5
    (2, 29, 10, 2, 16, True, 8, None),       # sliding window
    (1, 33, 4, 2, 32, True, None, 30.0),     # softcap
    (1, 40, 10, 2, 16, True, 16, 20.0),      # window + softcap + G = 5
    (2, 21, 4, 2, 16, False, None, None),    # non-causal (encoder)
]


@pytest.mark.parametrize("case", PREFILL_CASES)
def test_prefill_plain_matches_jax_kernel(case):
    B, S, Hq, Hkv, Dh, causal, window, softcap = case
    rng = np.random.default_rng(S)
    q = rng.standard_normal((B, S, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal,
                          sliding_window=window, softcap=softcap).numpy()
    for impl in ("interpret", "ref"):
        want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal, sliding_window=window, softcap=softcap,
                      impl=impl, block_q=16, block_kv=16)
        np.testing.assert_allclose(got, np.asarray(want), **TOL,
                                   err_msg=impl)


def test_prefill_kv_len_drops_trailing_keys():
    """kv_len marks trailing keys absent (the TPU wrapper's right padding):
    the answer is attention over the first kv_len keys, including rows a
    sliding window leaves fully masked (finite, never NaN)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 40, 10, 2 * 8)).astype(np.float32)
    k = rng.standard_normal((1, 40, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 40, 2, 16)).astype(np.float32)
    got = prefill_attention(_t(q), _t(k), _t(v), sliding_window=8,
                            softcap=20.0, kv_len=13).numpy()
    want = jref.attention(jnp.asarray(q), jnp.asarray(k[:, :13]),
                          jnp.asarray(v[:, :13]), sliding_window=8,
                          softcap=20.0)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


# ------------------------------------------------------------- decode
def _decode_inputs(seed, B, W, Hq, Hkv, Dh, lengths, wrap=()):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, W, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, W, Hkv, Dh)).astype(np.float32)
    kvp = np.full((B, W), -1, np.int32)
    qp = np.zeros((B,), np.int32)
    for b, n in enumerate(lengths):
        if b in wrap:                        # ring wrapped past W
            pos = np.arange(n, W + n, dtype=np.int32)
            kvp[b, pos % W] = pos
            qp[b] = W + n - 1
        elif n:
            kvp[b, :n] = np.arange(n)
            qp[b] = n - 1
    return q, k, v, qp, kvp


DECODE_CASES = [
    # (B, W, Hq, Hkv, Dh, lengths, wrap, window, softcap)
    (4, 64, 10, 2, 16, [5, 0, 64, 31], (), None, None),   # ragged + empty
    (3, 64, 4, 4, 32, [0, 0, 0], (), None, None),          # all empty
    (3, 64, 10, 2, 16, [7, 40, 1], (0, 1), None, None),    # ring-wrapped
    (4, 64, 10, 2, 16, [60, 3, 64, 20], (2,), 16, None),   # window
    (2, 64, 4, 2, 32, [33, 64], (), None, 25.0),           # softcap
    (4, 64, 10, 2, 16, [9, 0, 50, 64], (3,), 12, 15.0),    # everything
    # a window across the seam of a ring wrapped 8 past W: slot 0's valid
    # keys sit at indices 56-63 and 0-7, in both of its 32-key tiles
    (2, 64, 10, 2, 16, [8, 40], (0,), 16, None),
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_plain_matches_jax_kernel(case):
    B, W, Hq, Hkv, Dh, lengths, wrap, window, softcap = case
    q, k, v, qp, kvp = _decode_inputs(W + B, B, W, Hq, Hkv, Dh, lengths,
                                      wrap)
    got = decode_attention(_t(q), _t(k), _t(v), q_positions=_t(qp),
                           kv_positions=_t(kvp), sliding_window=window,
                           softcap=softcap).numpy()
    assert np.isfinite(got).all()
    plain = grouped_decode(_t(q), _t(k), _t(v), _t(qp), _t(kvp),
                           scale=Dh ** -0.5, sliding_window=window,
                           softcap=softcap).numpy()
    np.testing.assert_array_equal(got, plain)
    for impl in ("interpret", "xla", "ref"):
        want = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       q_positions=jnp.asarray(qp),
                       kv_positions=jnp.asarray(kvp), sliding_window=window,
                       softcap=softcap, impl=impl)
        np.testing.assert_allclose(got, np.asarray(want), **TOL,
                                   err_msg=impl)


def test_flash_attention_routes_single_query_to_decode():
    q, k, v, qp, kvp = _decode_inputs(1, 2, 16, 4, 2, 8, [16, 9])
    via_flash = flash_attention(_t(q), _t(k), _t(v), q_offset=_t(qp),
                                kv_positions=_t(kvp)).numpy()
    direct = decode_attention(_t(q), _t(k), _t(v), q_positions=_t(qp),
                              kv_positions=_t(kvp)).numpy()
    np.testing.assert_array_equal(via_flash, direct)


# -------------------------------------------------------------- codecs
@pytest.mark.parametrize("name", ["fp32", "bf16", "int8"])
def test_codec_roundtrip_backward_matches_jax_grad(name):
    """The autograd roundtrip's backward pushes the gradient through the
    same codec with u_bwd, exactly as the JAX custom VJP does."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    w = rng.standard_normal((3, 5, 48)).astype(np.float32)
    u_f = rng.random(x.shape).astype(np.float32)
    u_b = rng.random(x.shape).astype(np.float32)
    jc = jget_codec(name, impl="ref")
    jy, jg = jax.value_and_grad(lambda a: jnp.sum(
        jc.roundtrip(a, jnp.asarray(u_f), jnp.asarray(u_b)) * w))(
        jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    y = get_codec(name).roundtrip(xt, _t(u_f), _t(u_b))
    (y * _t(w)).sum().backward()
    fwd = jc.roundtrip(jnp.asarray(x), jnp.asarray(u_f), jnp.asarray(u_b))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(fwd))


# ---------------------------------------------------------------- el2n
EL2N_CASES = [
    # (N, V, logit scale)
    (16, 100, 3.0),      # the ViT classifier's phase-1b batch
    (7, 1, 1.0),         # V = 1: p = onehot, EL2N = 0, CE = 0
    (5, 13, 2.0),        # V not a multiple of 4
    (9, 600, 1.0),       # spans the interpret kernel's vocab blocks
]


def _el2n_inputs(N, V, scale):
    rng = np.random.default_rng(N * 1000 + V)
    logits = (scale * rng.standard_normal((N, V))).astype(np.float32)
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[0], labels[-1] = 0, V - 1          # first and last column
    return logits, labels


@pytest.mark.parametrize("case", EL2N_CASES)
def test_el2n_plain_forms_match_jax(case):
    """Both plain forms against the JAX op's materialized reference and its
    Pallas kernel in interpret mode."""
    logits, labels = _el2n_inputs(*case)
    forms = {"materialized": tel2n_ref.el2n_scores,
             "one-pass": tel2n_ref.fused_scores, "op": el2n_scores}
    for impl in ("ref", "interpret"):
        je, jc = jel2n(jnp.asarray(logits), jnp.asarray(labels), impl=impl,
                       block_v=256)
        for name, fn in forms.items():
            e, c = fn(_t(logits), _t(labels))
            assert e.dtype == c.dtype == torch.float32
            np.testing.assert_allclose(e.numpy(), np.asarray(je), **TOL,
                                       err_msg=f"{name} vs {impl}")
            np.testing.assert_allclose(c.numpy(), np.asarray(jc), **TOL,
                                       err_msg=f"{name} vs {impl}")


def test_el2n_one_pass_cancels_near_certain_rows():
    """At p_y -> 1 the one-pass identity cancels: it stays >= 0 and within
    about sqrt(1e-7) of the materialized form, and equals the JAX one-pass
    form (`impl="fused"`) to 1e-5."""
    logits = np.zeros((4, 50), np.float32)
    labels = np.array([0, 7, 49, 20], np.int32)
    logits[np.arange(4), labels] = [30.0, 40.0, 25.0, 60.0]
    e1, c1 = tel2n_ref.fused_scores(_t(logits), _t(labels))
    em, cm = tel2n_ref.el2n_scores(_t(logits), _t(labels))
    je, jc = jel2n(jnp.asarray(logits), jnp.asarray(labels), impl="fused")
    assert (e1 >= 0).all()
    np.testing.assert_allclose(e1.numpy(), np.asarray(je), **TOL)
    np.testing.assert_allclose(c1.numpy(), np.asarray(jc), **TOL)
    assert float((e1 - em).abs().max()) <= 1e-3
    np.testing.assert_allclose(c1.numpy(), cm.numpy(), **TOL)


def test_no_kernel_launches_on_cpu_tensors():
    before = launch_counts()
    x = torch.randn(6, 40)
    v, s = quantize_int8(x, 0.5)
    dequantize_int8(v, s)
    q, k, vv = torch.randn(1, 9, 4, 8), torch.randn(1, 9, 2, 8), \
        torch.randn(1, 9, 2, 8)
    prefill_attention(q, k, vv)
    decode_attention(q[:, :1], k, vv, q_positions=torch.tensor([8]),
                     kv_positions=torch.arange(9)[None])
    el2n_scores(torch.randn(4, 10), torch.tensor([0, 3, 9, 2]))
    assert launch_counts() == before
