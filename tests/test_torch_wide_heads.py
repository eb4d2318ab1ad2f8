"""The port at the head dims and GQA groups of the wide families against
the JAX package, on the CPU: gemma2-9b (head_dim 256, G 2, attention
softcap 50, a local window), stablelm-12b (160, G 4) and nemotron-4-340b
(192, G 12), and values narrower than the keys (192 / 128, MLA's shape).

- The plain prefill, decode and paged-decode versions against the JAX ops:
  its XLA or jnp path, its Pallas kernel in interpret mode and its ref.
- Reduced models of the three families at their published head dims and
  groups, on bridged weights, through the port's dense ServeEngine against
  JAX's, and stablelm through both paged engines too: tokens ==, logits
  within 1e-5, wire bytes and counters ==.
- The decode kernels' residency (`decode_blocks_per_sm`, from each
  instantiation's shared memory) and the split count it sets.

The CUDA kernels at these shapes are held against these plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 3)."""
import torch

torch.set_num_threads(2)

import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import test_torch_paged as tpaged  # noqa: E402
import test_torch_serve as tserve  # noqa: E402
from test_torch_cuda import wide_reduced  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import SplitConfig as JSplitConfig  # noqa: E402
from repro.core import SplitModel as JSplitModel  # noqa: E402
from repro.kernels.flash_attention.decode import \
    decode_attention as jdecode  # noqa: E402
from repro.kernels.flash_attention.decode import \
    paged_decode_attention as jpaged  # noqa: E402
from repro.kernels.flash_attention.ops import \
    flash_attention as jflash  # noqa: E402
from repro.runtime import WireSpec as JWireSpec  # noqa: E402
from repro.serve import PagedServeConfig as JPagedServeConfig  # noqa: E402
from repro.serve import PagedServeEngine as JPagedServeEngine  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import TenantBank as JTenantBank  # noqa: E402
from repro_torch.bridge import bank_from_arrays, jax_to_torch  # noqa: E402
from repro_torch.core import SplitConfig, SplitModel  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.flash_attention.decode import (  # noqa: E402
    BLOCKS_PER_SM, decode_block_bytes, decode_blocks_per_sm, decode_shape,
    decode_splits, paged_decode_attention)
from repro_torch.kernels.flash_attention.decode import \
    decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import \
    flash_attention  # noqa: E402
from repro_torch.runtime import WireSpec  # noqa: E402
from repro_torch.serve import (PagedServeConfig,  # noqa: E402
                               PagedServeEngine, ServeConfig, ServeEngine)

TOL = dict(atol=1e-5, rtol=1e-5)
# the Pallas kernels in interpret mode sum in their own block order
ITOL = dict(atol=2e-5, rtol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------ prefill
PREFILL_CASES = [
    # (B, S, Hq, Hkv, Dh, Dv, causal, window, softcap)
    (1, 37, 4, 2, 256, 256, True, 16, 50.0),      # gemma2's
    (1, 45, 8, 2, 160, 160, True, None, None),    # stablelm's
    (1, 33, 24, 2, 192, 192, True, 8, 50.0),      # nemotron's G 12
    (1, 29, 12, 1, 192, 128, True, None, None),   # Dv < Dh, G 12
    (2, 21, 4, 2, 256, 256, False, None, 50.0),   # non-causal
]


def _attention_f64(q, k, v, causal, window, softcap):
    """The plain attention formula in float64 numpy: the yardstick that
    says which side of a failed comparison moved."""
    S, Skv, group = q.shape[1], k.shape[1], q.shape[2] // k.shape[2]
    kg = np.repeat(k.astype(np.float64), group, axis=2)
    vg = np.repeat(v.astype(np.float64), group, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kg)
    s = s * q.shape[-1] ** -0.5
    if softcap is not None:
        s = softcap * np.tanh(s / softcap)
    qi, kj = np.arange(S)[:, None], np.arange(Skv)[None, :]
    valid = np.ones((S, Skv), bool)
    if causal:
        valid &= kj <= qi
    if window is not None:
        valid &= kj > qi - window
    s = np.where(valid, s, -2.0 ** 30)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), vg)


@pytest.mark.parametrize("case", PREFILL_CASES)
def test_wide_prefill_plain_matches_jax(case):
    B, S, Hq, Hkv, Dh, Dv, causal, window, softcap = case
    rng = np.random.default_rng(Dh + S)
    q = rng.standard_normal((B, S, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, Dv)).astype(np.float32)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal,
                          sliding_window=window, softcap=softcap).numpy()
    assert got.shape == (B, S, Hq, Dv) and np.isfinite(got).all()
    exact = _attention_f64(q, k, v, causal, window, softcap)
    # the f32 QK^T product's distance from f64: if the port moved, this
    # says whether the process's f32 matmul did
    kg = np.repeat(k, Hq // Hkv, axis=2)
    qk = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                   kg.astype(np.float64))
    qk_err = np.abs(torch.einsum("bqhd,bkhd->bhqk", _t(q), _t(kg)).numpy()
                    - qk).max()
    # and torch's exp and tanh (relative error) on the logits' range
    x = qk.astype(np.float32) / 16
    op_err = max(np.abs(fn(_t(x)).numpy() / ref(x.astype(np.float64))
                        - 1).max()
                 for fn, ref in ((torch.tanh, np.tanh),
                                 (torch.exp, np.exp)))
    for impl, tol in (("ref", TOL), ("interpret", ITOL)):
        want = np.asarray(jflash(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            sliding_window=window, softcap=softcap, impl=impl, block_q=16,
            block_kv=16))
        # on a failure, the side further from float64 is the one that moved
        np.testing.assert_allclose(
            got, want, **tol,
            err_msg=(f"{impl}: max |port - f64| "
                     f"{np.abs(got - exact).max():.3g}, max |jax - f64| "
                     f"{np.abs(want - exact).max():.3g}, torch threads "
                     f"{torch.get_num_threads()}, f32 QK^T vs f64 "
                     f"{qk_err:.3g}, f32 exp/tanh vs f64 (rel) {op_err:.3g}, "
                     f"matmul precision "
                     f"{torch.get_float32_matmul_precision()}, cpu "
                     f"{torch.backends.cpu.get_cpu_capability()}"))


# ------------------------------------------------------------- decode
DECODE_CASES = [
    # (B, W, Hq, Hkv, Dh, Dv, lengths, wrap, window, softcap)
    (3, 64, 4, 2, 256, 256, [5, 8, 31], (1,), 16, 50.0),  # window across
    #                                                        a ring's seam
    (3, 64, 8, 2, 160, 160, [7, 0, 40], (), None, None),
    (3, 64, 24, 2, 192, 192, [60, 3, 20], (0,), 12, 50.0),
    (2, 64, 12, 1, 192, 128, [33, 64], (), None, None),
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_wide_decode_plain_matches_jax(case):
    B, W, Hq, Hkv, Dh, Dv, lengths, wrap, window, softcap = case
    q, k, v, qp, kvp = _ring_inputs(B, W, Hq, Hkv, Dh, Dv, lengths,
                                            wrap)
    got = decode_attention(_t(q), _t(k), _t(v), q_positions=_t(qp),
                           kv_positions=_t(kvp), sliding_window=window,
                           softcap=softcap).numpy()
    assert got.shape == (B, 1, Hq, Dv) and np.isfinite(got).all()
    for impl, tol in (("xla", TOL), ("ref", TOL), ("interpret", ITOL)):
        want = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       q_positions=jnp.asarray(qp),
                       kv_positions=jnp.asarray(kvp), sliding_window=window,
                       softcap=softcap, impl=impl)
        np.testing.assert_allclose(got, np.asarray(want), **tol,
                                   err_msg=impl)


def _ring_inputs(B, W, Hq, Hkv, Dh, Dv, lengths, wrap):
    """Ring caches: slot b holds lengths[b] tokens, a slot in `wrap` has
    run past W (its ring wrapped), a length of 0 is an empty slot."""
    rng = np.random.default_rng(W + Dh + B)
    q = rng.standard_normal((B, 1, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, W, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, W, Hkv, Dv)).astype(np.float32)
    kvp = np.full((B, W), -1, np.int32)
    qp = np.zeros((B,), np.int32)
    for b, n in enumerate(lengths):
        if b in wrap:
            pos = np.arange(n, W + n, dtype=np.int32)
            kvp[b, pos % W] = pos
            qp[b] = W + n - 1
        elif n:
            kvp[b, :n] = np.arange(n)
            qp[b] = n - 1
    return q, k, v, qp, kvp


# ------------------------------------------------------- paged decode
PAGED_CASES = [
    # (B, nb, page, Hq, Hkv, Dh, Dv, lens, window, softcap); a length of
    # None is a fully masked row (every table entry NULL)
    (3, 4, 8, 8, 2, 160, 160, [20, 7, 32], None, None),
    (3, 4, 8, 24, 2, 192, 192, [13, None, 30], 6, 50.0),
    (2, 3, 16, 4, 2, 256, 256, [33, 48], 16, 50.0),
    (2, 3, 8, 12, 1, 192, 128, [17, 24], None, None),
]


@pytest.mark.parametrize("case", PAGED_CASES)
def test_wide_paged_plain_matches_jax(case):
    B, nb, page, Hq, Hkv, Dh, Dv, lens, window, softcap = case
    q, kp, vp, tables, qpos, kvpos = tpaged._paged_inputs(
        Dh + sum(n or 0 for n in lens), B, nb, page, Hq, Hkv, Dh, lens)
    vp = np.random.default_rng(Dv).standard_normal(
        vp.shape[:3] + (Dv,)).astype(np.float32)
    got = paged_decode_attention(
        _t(q), _t(kp), _t(vp), block_tables=_t(tables), q_positions=_t(qpos),
        kv_positions=_t(kvpos), sliding_window=window,
        softcap=softcap).numpy()
    assert got.shape == (B, 1, Hq, Dv) and np.isfinite(got).all()
    jargs = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp))
    jkw = dict(block_tables=jnp.asarray(tables),
               q_positions=jnp.asarray(qpos),
               kv_positions=jnp.asarray(kvpos), sliding_window=window,
               softcap=softcap)
    for impl, tol in (("xla", TOL), ("ref", TOL), ("interpret", ITOL)):
        np.testing.assert_allclose(
            got, np.asarray(jpaged(*jargs, **jkw, impl=impl)), **tol,
            err_msg=impl)


# ------------------------------------------------------------ engines
@functools.lru_cache(maxsize=None)
def _build(arch):
    """(JAX model, params, bank) and (port model, params, bank) on the same
    weights; the tenants' (tail, prompt) jittered by numpy noise."""
    split = dict(head_cycles=1, tail_cycles=1, prompt_len=tserve.PROMPT_LEN)
    jm = JSplitModel(wide_reduced(arch, jget_config), JSplitConfig(**split),
                     JWireSpec.make("fp32"))
    tm = SplitModel(wide_reduced(arch), SplitConfig(**split),
                    WireSpec.make("fp32"))
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)

    def jitter(x):
        return x + 0.2 * rng.standard_normal(x.shape).astype(np.float32)
    tails = [jax.tree.map(jitter, params["tail"]) for _ in range(3)]
    prompts = [jitter(params["prompt"]) for _ in range(3)]
    jb = JTenantBank.from_lists(tails, prompts)
    return dict(arch=arch, jm=jm, params=params, jb=jb, tm=tm,
                tparams=jax_to_torch(params, "cpu"),
                tbank=bank_from_arrays(jb.tails, jb.prompts, "cpu"))


def _same_run(got, want, reqs, counters):
    assert got["n_finished"] == want["n_finished"] == len(reqs)
    w_by = {f.req.rid: f for f in want["finished"]}
    for f in got["finished"]:
        np.testing.assert_array_equal(f.tokens, w_by[f.req.rid].tokens)
        np.testing.assert_allclose(f.logits, w_by[f.req.rid].logits, **TOL)
    assert got["wire_bytes"] == want["wire_bytes"]
    for key in counters:
        assert got[key] == want[key], key


# three requests over two slots: one queues, joins mid-flight and reuses
# a slot; two prompt lengths, so the JAX engine compiles two prefills
REQS = tserve.REQS[:2] + [dataclasses.replace(
    tserve.REQS[2], tokens=(np.arange(9, dtype=np.int32) * 7) % 128)]


@pytest.mark.parametrize("arch", ["gemma2-9b", "stablelm-12b",
                                  "nemotron-4-340b"])
def test_wide_family_dense_engine_matches_jax(arch):
    """The dense engine, decode_block 2, tenants 0-2."""
    family = _build(arch)
    kw = dict(n_slots=2, max_seq=tserve.MAX_SEQ, decode_block=2)
    want = JServeEngine(family["jm"], family["params"], family["jb"],
                        JServeConfig(**kw), collect_logits=True).run(REQS)
    before = launch_counts()
    got = ServeEngine(family["tm"], family["tparams"], family["tbank"],
                      ServeConfig(**kw), collect_logits=True,
                      device="cpu").run(REQS)
    assert launch_counts() == before      # the plain versions on the CPU
    _same_run(got, want, REQS,
              ("tokens_out", "decode_steps", "prefills", "occupancy"))


def test_stablelm_paged_engine_matches_jax():
    """stablelm through both paged engines (gemma2's local layers are
    refused by both, and nemotron's G 12 is held by the dense engine and
    the paged op) on the trace of tests/test_serve_paged.py with a tenant
    repeat, a shared prefix and chunked prefill. Every page counter ==."""
    family = _build("stablelm-12b")
    kw = dict(n_slots=3, max_seq=tpaged.MAX_SEQ, decode_block=2,
              page_size=tpaged.PAGE, **tpaged.ENGINE_CASES["prefix_chunked"])
    want = JPagedServeEngine(family["jm"], family["params"], family["jb"],
                             JPagedServeConfig(**kw), collect_logits=True
                             ).run(tpaged.REQS_HIT)
    got = PagedServeEngine(family["tm"], family["tparams"], family["tbank"],
                           PagedServeConfig(**kw), collect_logits=True,
                           device="cpu").run(tpaged.REQS_HIT)
    _same_run(got, want, tpaged.REQS_HIT, tpaged.COUNTERS)


# -------------------------------------------------- decode residency
@pytest.mark.parametrize("Dh,Dv,G,shape,nbytes,blocks", [
    (128, 128, 5, (128, 2), 72_704, 3),    # Qwen2.5-14B: unchanged
    (80, 80, 1, (128, 2), 72_704, 3),      # zamba2: unchanged
    (128, 128, 12, (128, 4), 77_824, 2),
    (160, 160, 4, (256, 2), 142_336, 1),   # stablelm-12b
    (256, 256, 2, (256, 2), 142_336, 1),   # gemma2-9b
    (192, 192, 12, (256, 4), 151_552, 1),  # nemotron-4-340b
    (192, 128, 12, (256, 4), 151_552, 1),  # values narrower than keys
])
def test_decode_residency_follows_shared_memory(Dh, Dv, G, shape, nbytes,
                                                blocks):
    """Each instantiation's shared memory and the blocks of it an SM
    holds: three at the narrow shapes (BLOCKS_PER_SM, as before), one at
    head dims above 128."""
    assert decode_shape(Dh, Dv, G) == shape
    assert decode_block_bytes(Dh, Dv, G) == nbytes
    assert decode_blocks_per_sm(Dh, Dv, G) == blocks <= BLOCKS_PER_SM


@pytest.mark.parametrize("B,Hkv,width,Dh,G,want", [
    (8, 8, 512, 128, 5, 7),     # Qwen2.5-14B dense: S 7, as before
    (8, 32, 512, 80, 1, 2),     # zamba2's shared block: S 2, as before
    (16, 8, 512, 128, 5, 4),    # Qwen2.5-14B paged: S 4, as before
    (8, 8, 512, 256, 2, 3),     # gemma2-9b dense: one block an SM
    (16, 8, 512, 160, 4, 2),    # stablelm-12b paged
    (8, 8, 512, 192, 12, 3),    # nemotron-4-340b's group
    (1, 8, 4096, 256, 2, 8),    # capped at MAX_SPLITS
])
def test_decode_splits_follow_residency(B, Hkv, width, Dh, G, want):
    got = decode_splits(B, Hkv, width, 132, decode_blocks_per_sm(Dh, Dh, G))
    assert got == want
    if Dh <= 128 and G <= 8:
        assert got == decode_splits(B, Hkv, width, 132)
