"""The int8 wire's launch plan and its round-to-nearest noise on the CPU.

`quantize_plan` picks the quantize kernel's layout (a warp, a block or a
cluster of blocks a row) from shapes alone; it is pinned here case by case.
The noise of round-to-nearest (u = 0.5) travels as a Python float from the
boundary through the codec and the op to the kernel, which takes it by
value: these tests hold that path to the same bits as a 0-dim tensor u and
as the JAX package's op and wire crossing. The kernels themselves run on the
card (tests/test_torch_cuda.py)."""
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.kernels.quant.ops import dequantize_int8 as jdequantize  # noqa: E402
from repro.kernels.quant.ops import quantize_int8 as jquantize  # noqa: E402
from repro.runtime.boundary import Boundary as JBoundary  # noqa: E402
from repro.runtime.codec import get_codec as jget_codec  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.quant import kernel as qkernel  # noqa: E402
from repro_torch.kernels.quant import ops as qops  # noqa: E402
from repro_torch.kernels.quant.kernel import (MAX_D,  # noqa: E402
                                              check_plan, quantize_plan)
from repro_torch.kernels.quant.ops import (dequantize_int8,  # noqa: E402
                                           quantize_int8)
from repro_torch.runtime import codec as tcodec  # noqa: E402
from repro_torch.runtime.boundary import Boundary  # noqa: E402
from repro_torch.runtime.codec import get_codec  # noqa: E402


# ------------------------------------------------------------------ plan
@pytest.mark.parametrize("N", [1, 8, 16, 3408, 6816])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_plan_warp_per_row_up_to_1024(N, itemsize):
    """The training path's (3408 | 6816, 768) and every row up to 1024:
    a warp a row, 8 rows a 256-thread block."""
    for D in (1, 100, 768, 1024):
        assert quantize_plan(N, D, itemsize) == ("warp", 1, 256)


@pytest.mark.parametrize("D", [1025, 2560, 3584, 5120, 8192])
@pytest.mark.parametrize("N", [1, 8, 16, 132, 1025])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_plan_serving_widths_take_a_block(D, N, itemsize):
    """Every serving width (zamba2 and rwkv6 2560, gemma2 3584, Qwen and
    stablelm 5120) runs a block a row at every row count: the card's
    cluster sweep found no cluster 10% faster at the decode row counts."""
    assert quantize_plan(N, D, itemsize) == ("block", 1, 256)


@pytest.mark.parametrize("D, C", [(8193, 2), (16384, 2), (18432, 3),
                                  (24577, 4), (65536, 8)])
def test_plan_cluster_of_ceil_d_over_8192(D, C):
    """Above 8192 a cluster of ceil(D / 8192) blocks: nemotron-4-340b's
    18432 takes 3, 65536 the portable maximum of 8."""
    for N in (1, 132, 4096):
        for itemsize in (4, 2):
            plan = quantize_plan(N, D, itemsize)
            assert plan == ("cluster", C, 256)
            check_plan(plan, D)


def test_plan_refuses_rows_past_65536():
    assert MAX_D == 65536
    for itemsize in (4, 2):
        with pytest.raises(ValueError, match="at most 65536"):
            quantize_plan(8, 65537, itemsize)
        with pytest.raises(ValueError, match="65536"):
            quantize_plan(1, 1 << 20, itemsize)


@pytest.mark.parametrize("plan, D", [
    (("warp", 1, 256), 1025), (("block", 1, 256), 8193),
    (("block", 1, 64), 2049), (("cluster", 2, 256), 16385),
    (("cluster", 1, 256), 100), (("cluster", 9, 256), 70000),
    (("block", 1, 48), 100), (("block", 1, 512), 100),
    (("rows", 1, 256), 100)])
def test_check_plan_refuses_plans_that_cannot_hold_the_row(plan, D):
    with pytest.raises(ValueError):
        check_plan(plan, D)


def test_check_plan_takes_every_forced_layout_that_fits():
    """The plans the card tests and sweeps force: the warp up to 1024, the
    block up to 8192, clusters of 2-8 up to C x 8192."""
    for D in (1, 100, 768, 1024):
        check_plan(("warp", 1, 256), D)
    for D in (1, 2560, 8192):
        check_plan(("block", 1, 256), D)
    for C in (2, 4, 8):
        for D in (2, 2560, 5120, C * 8192):
            check_plan(("cluster", C, 256), D)


# ------------------------------------------------------------ u by value
def _x(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape)
         * rng.exponential(3.0, (shape[0], 1))).astype(np.float32)
    x[0, :3] = 0.0
    return x


@pytest.mark.parametrize("shape", [(8, 160), (3, 5120), (37, 100)])
def test_float_u_equals_0dim_u_and_jax(shape):
    """The op and the codec with the Python float 0.5 give the same bits as
    with a 0-dim f32 tensor 0.5, and as the JAX op (its jnp reference and
    its Pallas kernel in interpret mode) at u = 0.5."""
    x = _x(shape, sum(shape))
    tx = torch.from_numpy(x)
    v, s = quantize_int8(tx, 0.5)
    v0, s0 = quantize_int8(tx, torch.tensor(0.5))
    assert torch.equal(v, v0) and torch.equal(s, s0)
    for impl in ("ref", "interpret"):
        jv, js = jquantize(jnp.asarray(x), jnp.float32(0.5), impl=impl)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv), impl)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js), impl)
    np.testing.assert_array_equal(
        dequantize_int8(v, s).numpy(),
        np.asarray(jdequantize(jv, js, impl="ref")))
    codec = get_codec("int8")
    x3 = tx.reshape(1, shape[0], shape[1])
    (cv, cs), (cv0, cs0) = codec.encode(x3, 0.5), codec.encode(
        x3, torch.tensor(0.5))
    assert torch.equal(cv, cv0) and torch.equal(cs, cs0)
    assert torch.equal(cv.reshape(shape), v) and \
        torch.equal(cs.reshape(shape[0], 1), s)


def test_deterministic_noise_is_a_float_and_allocates_nothing(monkeypatch):
    """Round-to-nearest noise is the float 0.5, made without a tensor: on
    the card no fill kernel runs at a wire crossing. Every tensor factory
    the old path could reach raises here, and the device named is the
    card's, which this CPU box does not have."""
    def refuse(*a, **k):
        raise AssertionError("a tensor was allocated for the noise")
    for name in ("full", "tensor", "as_tensor", "empty", "rand", "ones",
                 "zeros"):
        monkeypatch.setattr(torch, name, refuse)
    b = Boundary("head_body", get_codec("int8"))
    assert b._noise(None, (8, 1, 5120), "cuda") == (0.5, 0.5)
    assert all(type(u) is float for u in b._noise(None, (2, 3), "cuda"))
    # fp32 and bf16 wires consume no noise: the same floats
    for name in ("fp32", "bf16"):
        bb = Boundary("body_tail", get_codec(name))
        assert bb._noise(torch.Generator(), (2, 3), "cuda") == (0.5, 0.5)


def test_ops_hand_the_kernel_a_float_for_host_scalars(monkeypatch):
    """On the card path the op passes a Python number or a 0-dim host
    tensor to the launch wrapper as a float (no copy to the card), and a
    tensor through its strides; the codec passes a float u on untouched.
    The wrapper is replaced by a recorder, since this box has no card."""
    seen = []
    monkeypatch.setattr(qops, "on_cuda", lambda t: True)
    monkeypatch.setattr(qops, "quantize_fwd",
                        lambda x, u: seen.append(u) or ("v", "s"))
    x = torch.zeros((4, 8))
    qops.quantize_int8(x, 0.5)
    qops.quantize_int8(x, torch.tensor(0.25))
    qops.quantize_int8(x, torch.tensor(0.75, dtype=torch.float64))
    u = torch.rand((4, 8))
    qops.quantize_int8(x, u)
    assert seen[:3] == [0.5, 0.25, 0.75]
    assert all(type(v) is float for v in seen[:3])
    assert isinstance(seen[3], torch.Tensor) and torch.equal(seen[3], u)

    got = []
    monkeypatch.setattr(tcodec, "quantize_int8",
                        lambda x, u: got.append(u) or (
                            torch.zeros(x.shape, dtype=torch.int8),
                            torch.ones((x.shape[0], 1))))
    codec = get_codec("int8")
    codec.encode(torch.zeros((2, 3, 8)), 0.5)
    codec.encode(torch.zeros((2, 3, 8)), torch.tensor(0.5))
    assert got[0] == 0.5 and type(got[0]) is float
    assert got[1].shape == (6, 8) and got[1].stride() == (0, 0)


def test_quantize_fwd_takes_a_float_u_and_checks_before_launching():
    """The launch wrapper takes u as a float; on a CPU tensor it raises for
    the device before it builds or launches anything, and a plan that
    cannot hold the row never reaches the kernel."""
    before = launch_counts()
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        qkernel.quantize_fwd(x, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        qkernel.quantize_fwd(x, torch.full((2, 8), 0.5),
                             plan=("warp", 1, 256))
    assert launch_counts() == before


# --------------------------------------------------------- wire crossing
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("shape", [(2, 5, 64), (8, 1, 160)])
def test_round_to_nearest_crossing_matches_jax(shape, train):
    """One round-to-nearest crossing of the int8 wire (no generator, no
    noise: the serving and eval mode) on the CPU: the received tensor,
    the payload and the wire bytes equal the JAX package's, and so does the
    gradient, which crosses back through the same codec at u = 0.5."""
    x = _x((shape[0] * shape[1], shape[2]), 7 + shape[2]).reshape(shape)
    w = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    tb = Boundary("head_body", get_codec("int8"))
    jb = JBoundary("head_body", jget_codec("int8", impl="ref"))

    xt = torch.from_numpy(x).requires_grad_(True)
    y, nbytes = tb.transmit(xt, train=train)
    (y * torch.from_numpy(w)).sum().backward()

    def loss(a):
        jy, _ = jb.transmit(a, train=train)
        return jnp.sum(jy * w)
    jy, jbytes = jb.transmit(jnp.asarray(x), train=train)
    jg = jax.grad(loss)(jnp.asarray(x))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
    assert nbytes == np.float32(jbytes) and nbytes.dtype == np.float32

    tv, ts = get_codec("int8").encode(torch.from_numpy(x), 0.5)
    jv, js = jget_codec("int8", impl="ref").encode(jnp.asarray(x),
                                                   jnp.float32(0.5))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
