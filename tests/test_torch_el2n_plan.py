"""The EL2N kernel's launch plan, and the plain one-pass form the card holds
the kernel against, on the CPU.

`el2n_plan` picks the EL2N kernel's layout (a warp a row or a block a row)
and its threads from the shapes and the card's SM count alone; it is pinned
here case by case, and every V from 1 to 300,000 (sampled) gets a plan
that covers it. `ref.fused_scores` is held against the JAX package's
one-pass and materialized EL2N at f32, bf16 and f16, at row lengths on
either side of the layouts' boundaries and of a 16-byte load, and on the
rows where the layouts must agree: near-certain ones and a row of -inf.
The kernel itself runs on the card (tests/test_torch_cuda.py)."""
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.kernels.el2n import ref as jref  # noqa: E402
from repro.kernels.el2n.ops import _fused_scores as jfused  # noqa: E402
from repro_torch.kernels.el2n import ref  # noqa: E402
from repro_torch.kernels.el2n.kernel import (  # noqa: E402
    FEW_ROWS_THREADS, MANY_ROWS_THREADS, THREADS, WARP_MAX_V, check_plan,
    el2n_plan)

TOL = 1e-5   # |port - JAX| <= TOL (1 + |JAX|), as the EL2N parity tests
SMS = (132, 114)   # the H100 SXM's SMs and the H100 PCIe's


# ------------------------------------------------------------------ plan
@pytest.mark.parametrize("N", [1, 16, 64, 512, 4096])
@pytest.mark.parametrize("sms", SMS)
def test_plan_warp_per_row_up_to_1024(N, sms):
    """The ViT path's (16, 100) and every row up to 1024 values: a warp a
    row, 4 rows a 128-thread block."""
    for V in (1, 13, 100, 1000, WARP_MAX_V):
        assert el2n_plan(N, V, sms) == ("warp", THREADS)
    assert (WARP_MAX_V, THREADS) == (1024, 128)


@pytest.mark.parametrize("V", [1025, 4099, 32000, 152064, 256000])
@pytest.mark.parametrize("sms", SMS)
def test_plan_many_rows_take_a_block(V, sms):
    """Rows enough to put a block on every SM (the LM scoring batch
    (512, 152064) among them) stream a block of 256 threads a row."""
    for N in (sms, 512, 4096):
        assert el2n_plan(N, V, sms) == ("block", MANY_ROWS_THREADS)
    assert MANY_ROWS_THREADS == 256


@pytest.mark.parametrize("N, V", [
    (16, 152064), (16, 98304), (16, 256000), (9, 152064), (8, 152064),
    (4, 98304), (1, 256000), (1, 300000), (16, 65536), (17, 152064),
    (32, 256000), (64, 152064), (64, 256000), (113, 152064), (8, 4099),
    (1, 1025)])
@pytest.mark.parametrize("sms", SMS)
def test_plan_few_rows_take_a_wide_block(N, V, sms):
    """Fewer rows than SMs, at any V past the warp's: a block of 512
    threads a row, each block alone on its SM."""
    assert FEW_ROWS_THREADS == 512
    assert el2n_plan(N, V, sms) == ("block", FEW_ROWS_THREADS)


def test_plan_threads_turn_at_the_sm_count():
    """The block's threads turn from 512 to 256 where the rows reach the
    card's SM count, whichever card it is."""
    for sms in (1, 66, 114, 132):
        assert el2n_plan(sms - 1, 5000, sms) == ("block", FEW_ROWS_THREADS)
        assert el2n_plan(sms, 5000, sms) == ("block", MANY_ROWS_THREADS)


def _sampled_vs():
    rng = np.random.default_rng(25)
    edges = [1, 2, 3, 7, 8, 9, 1023, 1024, 1025, 16383, 16384, 16385,
             32767, 32768, 65535, 65536, 131072, 152064, 256000, 300000]
    return sorted(set(edges) | set(int(v) for v in
                                   rng.integers(1, 300_001, 400)))


@pytest.mark.parametrize("N", [1, 2, 16, 64, 131, 132, 512, 100_000])
@pytest.mark.parametrize("sms", SMS)
def test_plan_covers_every_v(N, sms):
    """No V is refused, and each plan passes check_plan: a warp holds the
    row exactly when V <= 1024, a block any V."""
    for V in _sampled_vs():
        plan = el2n_plan(N, V, sms)
        check_plan(plan, V)
        assert (plan[0] == "warp") == (V <= WARP_MAX_V), (N, V, plan)
        assert el2n_plan(N, V, sms) == plan   # its arguments alone


@pytest.mark.parametrize("plan, V", [
    (("warp", 256), 1025), (("warp", 256), 300000),
    (("block", 48), 5000), (("block", 1024), 5000), (("block", 0), 5000),
    (("block", 544), 5000), (("grid", 256), 100), (("warp", 544), 100),
    (("cluster", 512), 300000), (("warp", 16), 100),
])
def test_check_plan_refuses_bad_overrides(plan, V):
    with pytest.raises(ValueError):
        check_plan(plan, V)


@pytest.mark.parametrize("plan, V", [
    (("warp", 32), 1024), (("warp", 512), 1), (("block", 32), 1),
    (("block", 512), 300000), (("block", 256), 1025), (("block", 64), 3),
])
def test_check_plan_takes_overrides_that_hold_the_row(plan, V):
    """The warp layout holds up to 1024 values, a block any V, with 32 to
    512 threads in whole warps."""
    check_plan(plan, V)


# -------------------------------------------------- one-pass plain form
def _logits(N, V, scale, seed):
    rng = np.random.default_rng(seed)
    logits = (scale * rng.standard_normal((N, V))).astype(np.float32)
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[0], labels[-1] = 0, V - 1            # first and last column
    return logits, labels


def _near_certain(V):
    """Rows of zeros with one large logit at the label: p_y within 1e-11
    of 1, where the one-pass identity cancels to 0."""
    labels = np.array([0, 7 % V, V - 1, (V // 2)], np.int32)
    logits = np.zeros((4, V), np.float32)
    logits[np.arange(4), labels] = [30.0, 40.0, 25.0, 60.0]
    return logits, labels


DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "f16": (torch.float16, jnp.float16)}


def _both(logits, labels, dtype):
    """The same values as a torch and a JAX array of `dtype` (both round
    the f32 values to nearest even)."""
    tdt, jdt = DTYPES[dtype]
    return ((torch.from_numpy(logits).to(tdt), torch.from_numpy(labels)),
            (jnp.asarray(logits).astype(jdt), jnp.asarray(labels)))


def _close(got, want):
    got, want = got.numpy(), np.asarray(want)
    err = np.abs(got - want)
    assert (err <= TOL * (1 + np.abs(want))).all(), float(err.max())


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("N, V", [
    (16, 100), (9, 1031), (5, 4099), (3, 1000), (7, 13), (4, 5),
    (2, 152064 // 16), (3, 1024), (3, 1025)])
def test_one_pass_matches_jax_one_pass_and_materialized(dtype, N, V):
    """At V on either side of the warp layout's 1024 and of a 16-byte load
    (4 f32, 8 at 16 bits): within 1e-5 of JAX's one-pass form in EL2N and
    CE, and of its materialized form in CE and in EL2N where p_y < 0.99
    (near 1 the one-pass identity cancels)."""
    logits, labels = _logits(N, V, 3.0, N * 1000 + V)
    (tl, tlab), (jl, jlab) = _both(logits, labels, dtype)
    e, c = ref.fused_scores(tl, tlab)
    assert e.dtype == c.dtype == torch.float32
    je, jc = jfused(jl, jlab)
    _close(e, je)
    _close(c, jc)
    me, mc = jref.el2n_scores(jl, jlab)
    _close(c, mc)
    py = torch.softmax(tl.float(), -1).gather(1, tlab.long()[:, None])[:, 0]
    ok = (py < 0.99).numpy()
    _close(e[ok], np.asarray(me)[ok])


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("V", [50, 1024, 1100, 4099])
def test_one_pass_near_certain_rows(dtype, V):
    """Near-certain rows: EL2N >= 0 and within 1e-5 of JAX's one-pass form
    (both cancel to the same rounding), CE within 1e-5 of both JAX forms,
    and EL2N within 1e-3 of the materialized form."""
    logits, labels = _near_certain(V)
    (tl, tlab), (jl, jlab) = _both(logits, labels, dtype)
    e, c = ref.fused_scores(tl, tlab)
    je, jc = jfused(jl, jlab)
    me, mc = jref.el2n_scores(jl, jlab)
    assert (e >= 0).all()
    _close(e, je)
    _close(c, jc)
    _close(c, mc)
    assert float(np.abs(e.numpy() - np.asarray(me)).max()) <= 1e-3


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("V", [50, 1100])
def test_one_pass_row_of_minus_inf_is_nan(dtype, V):
    """A row of -inf alone gives NaN in both outputs, in the port's plain
    form as in JAX's one-pass form (exp(-inf - -inf)); both kernel layouts
    are held to it on the card. Rows beside it, with some -inf logits,
    stay finite and agree."""
    logits, labels = _near_certain(V)
    logits[1, :] = -np.inf
    logits[3, 30:40] = -np.inf
    (tl, tlab), (jl, jlab) = _both(logits, labels, dtype)
    e, c = ref.fused_scores(tl, tlab)
    je, jc = jfused(jl, jlab)
    for got, want in ((e, je), (c, jc)):
        want = np.asarray(want)
        assert np.isnan(want[1]) and torch.isnan(got[1])
        keep = [0, 2, 3]
        assert torch.isfinite(got[keep]).all()
        _close(got[keep], want[keep])
