"""The narrow f32 prefill kernel's key split and GQA grouping on the CPU:
`ref.split_attention`, the plain model of what the kernel computes when
`prefill_plan` splits the keys (each query block's tiles cut into the
plan's shares, each share's unnormalised (m, l, acc), then the decode
kernels' combine), held against the JAX package's
`repro.kernels.flash_attention.ref.attention` on numpy inputs, and the
plan's split and group at the paths' shapes."""
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.kernels.flash_attention import ref as jref  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    F32_ROWS, F32_SPLIT_BLOCKS_PER_SM, F32_SPLIT_TILES, MAX_SPLITS,
    TILE_KEYS, prefill_plan)

TOL = 1e-5


def _inputs(seed, B, Sq, Skv, Hq, Hkv, Dh):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32)
                 for shape in ((B, Sq, Hq, Dh), (B, Skv, Hkv, Dh),
                               (B, Skv, Hkv, Dh)))


@pytest.mark.parametrize("case", [
    # (B, Sq, Skv, Hq, Hkv, Dh, causal, window, softcap, kv_len, rows,
    # splits, group)
    # whisper's cross-attention: Sq 1 and 64 over a long key axis
    (2, 1, 1500, 4, 4, 16, False, None, None, None, 16, 5, 1),
    (2, 1, 1500, 4, 4, 16, False, None, None, None, 16, 8, 1),
    (1, 64, 1500, 4, 4, 16, False, None, None, None, 16, 2, 1),
    (1, 64, 1500, 4, 4, 16, False, None, None, None, 64, 6, 1),
    # kv_len short of Skv, with a softcap
    (1, 7, 600, 10, 2, 32, False, None, 30.0, 455, 32, 3, 5),
    (2, 64, 900, 8, 1, 16, False, None, None, 777, 64, 4, 8),
    # a window that ends before kv_len: rows from kv_len + window - 1 on
    # are fully masked and average every key, over every share
    (1, 100, 100, 5, 1, 16, True, 8, None, 40, 16, 3, 5),
    (1, 100, 100, 8, 1, 16, True, 8, 20.0, 40, 64, 8, 8),
    (1, 90, 90, 4, 4, 32, True, 12, None, 33, 32, 4, 1),
    # causal, more shares than a block has tiles (empty shares, l = 0)
    (1, 132, 132, 10, 2, 32, True, None, None, None, 32, 8, 5),
    (2, 132, 132, 16, 2, 16, True, None, 50.0, None, 16, 2, 8),
    (1, 40, 40, 8, 8, 16, True, 16, None, None, 16, 8, 1),
])
def test_split_model_equals_jax(case):
    B, Sq, Skv, Hq, Hkv, Dh, causal, window, softcap, kv_len, rows, \
        splits, group = case
    q, k, v = _inputs(len(case) + Sq + Skv, B, Sq, Skv, Hq, Hkv, Dh)
    L = kv_len or Skv
    got = ref.split_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        rows=rows, splits=splits, group=group, causal=causal,
        sliding_window=window, softcap=softcap, kv_len=L)
    want = jref.attention(jnp.asarray(q), jnp.asarray(k[:, :L]),
                          jnp.asarray(v[:, :L]), causal=causal,
                          sliding_window=window, softcap=softcap)
    assert got.shape == (B, Sq, Hq, Dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("shape", [
    # (B, Sq, Skv, Hq, Hkv, Dh, causal): whisper-base's cross-attention
    # at Sq 1 and 64 over 1500 frames, reduced to 4 heads of 16
    (4, 1, 1500, 4, 4, 16, False), (4, 64, 1500, 4, 4, 16, False),
    # GQA 4, 5 and 8 at a short causal prompt
    (1, 37, 37, 8, 2, 16, True), (1, 37, 37, 10, 2, 16, True),
    (1, 37, 37, 16, 2, 16, True)])
def test_plan_split_model_equals_jax(shape):
    """The plan the kernel takes at an SM count these few heads would not
    fill (96), through the plain model, against JAX: a GQA group in one
    block where G divides 16."""
    B, Sq, Skv, Hq, Hkv, Dh, causal = shape
    plan = prefill_plan(B, Sq, Hq, Dh, Dh, 4, 96, Hkv=Hkv, kv_len=Skv)
    G = Hq // Hkv
    assert plan.group == (G if 16 % G == 0 else 1)
    assert (plan.splits > 1) == (Skv >= 1500)
    q, k, v = _inputs(Sq + Hq, B, Sq, Skv, Hq, Hkv, Dh)
    got = ref.split_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        rows=plan.rows, splits=plan.splits, group=plan.group, causal=causal)
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv", [
    (4, 1, 1500, 8, 8), (4, 64, 1500, 8, 8), (4, 1500, 1500, 8, 8),
    (2, 132, 132, 64, 8), (1, 132, 132, 40, 8), (16, 213, 213, 6, 6),
    (1, 1, 40000, 1, 1), (1, 5, 70, 2, 1)])
@pytest.mark.parametrize("sms", [16, 132])
def test_plan_split_rule(B, Sq, Skv, Hq, Hkv, sms):
    """A split only where the blocks fall short of the SMs, of at least
    F32_SPLIT_TILES tiles a share and at most MAX_SPLITS; it launches
    F32_SPLIT_BLOCKS_PER_SM blocks an SM unless the tiles or MAX_SPLITS
    stop it, and no such count leaves the busiest SM fewer tiles; a pure
    function of the shapes."""
    plan = prefill_plan(B, Sq, Hq, 64, 64, 4, sms, Hkv=Hkv, kv_len=Skv)
    assert plan == prefill_plan(B, Sq, Hq, 64, 64, 4, sms, Hkv=Hkv,
                                kv_len=Skv)
    assert plan.rows in F32_ROWS and Hq // Hkv % plan.group == 0
    blocks = -(-Sq // (plan.rows // plan.group)) * (Hq // plan.group) * B
    assert 1 <= plan.splits <= MAX_SPLITS
    if plan.splits == 1:
        return
    tiles = -(-Skv // TILE_KEYS)
    cap = min(MAX_SPLITS, tiles // F32_SPLIT_TILES)
    assert blocks < sms and plan.splits <= cap
    assert plan.splits == cap or \
        blocks * plan.splits >= F32_SPLIT_BLOCKS_PER_SM * sms

    def load(n):   # tiles the busiest SM walks
        return -(-blocks * n // sms) * -(-tiles // n)
    assert all(load(n) >= load(plan.splits) for n in range(2, cap + 1)
               if blocks * n >= F32_SPLIT_BLOCKS_PER_SM * sms)
